#!/usr/bin/env python3
"""Host cost of one step span (``tracing.step_span``).

    python scripts/step_span_cost.py [--device cuda] [--n 20000]

Times ``n`` empty spans in a loop on the host clock, in these states:
spans off (the hook reads the switch and enters a shared null context);
names only (``start_step_spans(record=False)``: a ``record_function``
each, as in ``profiling.trace``); on, host only; on and device-timed (a
CUDA event pair on the current stream; on a CUDA device only); and the
last three again while a ``torch.profiler`` profile records. Every span
of a recording is one trace, like an engine step. Prints one JSON line:
the device, torch's version, and microseconds a span in each state
(the loop's own cost included; an empty loop's is printed beside).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def per_span_us(n: int, device, timed: bool) -> float:
    from tpushare_torch import tracing
    dev = device if timed else None
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.step_span("serve.step", device=dev, root=True):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="step_span_cost")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=20000)
    a = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpushare_torch import tracing
    device = torch.device(a.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.ones(1, device=device).sum().item()
    t0 = time.perf_counter()
    for _ in range(a.n):
        pass
    out = {"device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu"),
           "torch": torch.__version__, "n": a.n,
           "empty_loop_us": 1e6 * (time.perf_counter() - t0) / a.n}
    per_span_us(a.n, device, False)             # warm
    out["off_us"] = per_span_us(a.n, device, False)
    tracing.start_step_spans(record=False)
    out["names_only_us"] = per_span_us(a.n, device, False)
    tracing.stop_step_spans()
    states = [("on_us", False)] + ([("on_device_timed_us", True)]
                                   if cuda else [])
    for key, timed in states:
        tracing.start_step_spans(capacity=a.n + 1)
        per_span_us(a.n, device, timed)
        if cuda:
            torch.cuda.synchronize()
        assert tracing.stop_step_spans()["complete"]
        tracing.start_step_spans(capacity=a.n + 1)
        out[key] = per_span_us(a.n, device, timed)
        if cuda:
            torch.cuda.synchronize()
        tracing.stop_step_spans()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    tracing.start_step_spans(record=False)
    with profile(activities=acts):
        out["names_only_profiled_us"] = per_span_us(a.n, device, False)
    tracing.stop_step_spans()
    for key, timed in states:
        tracing.start_step_spans(capacity=a.n + 1)
        with profile(activities=acts):
            out[key.replace("_us", "_profiled_us")] = per_span_us(
                a.n, device, timed)
            if cuda:
                torch.cuda.synchronize()
        tracing.stop_step_spans()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
