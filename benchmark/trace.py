"""The traced run's device profile: ``torch.profiler`` over a window,
reduced to what the metrics and the result's ``breakdown`` read.

Device busy time is the union of the intervals in which an operation
ran on the card (the sum of CUDA self time, as the port's
``scripts/torch_profile.py`` takes it, where nothing overlaps); idle is
the rest of the window. The window is a host span of the benchmark's
own: ``bench.window`` (the whole recording) unless the run names
another, such as a slice inside a serving window. A kernel belongs to
the window's per-kernel totals when the host launched it inside the
window (matched to its launch by the profiler's correlation id; by its
device time where no launch is found), so that the totals hold the
launches the port's counters counted there whatever the offset between
the host's and the device's clocks. Idle gaps are labelled by what the
host was doing when the gap opened: the innermost host operation then
running, under the benchmark's own ``bench.*`` span around it.

The events are read straight from the profiler's result (no
``FunctionEvent`` parse, which takes minutes for a minute of serving)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


class DeviceTrace:
    """``with DeviceTrace() as t: ...`` then ``t.summary()``."""

    WINDOW = "bench.window"

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._torch = torch
        self._record = record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._span = record_function(self.WINDOW)
        self.wall_s = 0.0

    @staticmethod
    def prewarm() -> None:
        """Profile one small operation, so that the profiler's one-time
        start (loading and initialising the device tracer) falls in
        set-up and not inside a measured window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        x = torch.ones(256, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            (x * 2).sum().item()
        torch.cuda.synchronize()

    def span(self, name: str):
        """A host span the caller enters and exits itself, such as the
        slice a summary is taken over."""
        return self._record(name)

    def __enter__(self):
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self, top: int = 10, window: str | None = None) -> dict:
        from torch.autograd import DeviceType
        dev, cpu, launched = [], [], {}
        for e in self._prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                name = e.name()
                # a host span's mirror on the device timeline is no work
                if e.is_user_annotation() or name.startswith("bench."):
                    continue
                dev.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name,
                            e.correlation_id()))
            elif kind == DeviceType.CPU:
                start = e.start_ns() / 1e3
                cpu.append((start, e.end_ns() / 1e3, e.name()))
                if e.correlation_id() and e.name().startswith("cu"):
                    launched[e.correlation_id()] = start
        dev = [(s, e, n, launched.get(c)) for s, e, n, c in dev]
        return summarize(dev, cpu, window or self.WINDOW, top)


def summarize(dev: list[tuple], cpu: list[tuple], window_name: str,
              top: int = 10) -> dict:
    """Reduce device intervals (start_us, end_us, name[, the host's
    launch instant or None]) and host spans (start_us, end_us, name) to
    the window's length, busy time, per-kernel totals and the
    breakdown."""
    win = [(s, e) for s, e, n in cpu if n == window_name]
    if win:
        w0, w1 = win[0]
    else:
        w0 = min(d[0] for d in dev + cpu)
        w1 = max(d[1] for d in dev + cpu)
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    spans = []
    for s, e, n, *launch in dev:
        at = launch[0] if launch else None
        if at is not None and w0 <= at <= w1:
            kernels[n][0] += (e - s) / 1e6
            kernels[n][1] += 1
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if at is None:
            kernels[n][0] += (e - s) / 1e6
            kernels[n][1] += 1
        spans.append((s, e))
    spans.sort()
    busy_us, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, e in spans:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy_us += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy_us += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    labels = _GapLabels(cpu, window_name)
    by_label: dict[str, float] = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        by_label[labels.at(g0)] += (g1 - g0) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": {n: (t, c) for n, (t, c) in kernels.items()},
            "breakdown": {"device_ops": [[n, t] for n, (t, _) in ops],
                          "idle_gaps": [[n, t] for n, t in idle]}}


class _GapLabels:
    """What the host was doing at an instant: the innermost host span
    covering it, under the innermost ``bench.*`` span covering it."""

    def __init__(self, cpu: list[tuple], window_name: str) -> None:
        self._ops = sorted(c for c in cpu if c[2] != window_name)
        self._starts = [c[0] for c in self._ops]
        self._bench = sorted(c for c in self._ops
                             if c[2].startswith("bench."))
        self._bstarts = [c[0] for c in self._bench]

    @staticmethod
    def _cover(items, starts, t, limit):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - limit), -1):
            if items[j][1] >= t:
                return items[j][2]
        return None

    def at(self, t: float) -> str:
        inner = self._cover(self._ops, self._starts, t, 4096)
        outer = self._cover(self._bench, self._bstarts, t, 4096)
        if inner is None:
            return outer or "host idle"
        return inner if outer in (None, inner) else f"{outer} > {inner}"


def kernel_time(summary: dict, *patterns: str) -> tuple[float, int]:
    """Seconds and launches of every kernel whose name holds one of
    ``patterns``."""
    t, n = 0.0, 0
    for name, (secs, count) in summary["kernels"].items():
        if any(p in name for p in patterns):
            t += secs
            n += count
    return t, n
