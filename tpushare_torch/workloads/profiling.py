"""Workload-side profiling: a device trace around any region — the port
of ``tpushare/workloads/profiling.py`` on ``torch.profiler``.

    from tpushare_torch.workloads.profiling import trace
    with trace("/tmp/tb"):           # or TPUSHARE_TRACE_DIR=/tmp/tb
        loss = step(inputs, targets)

The trace (host ops, and the card's kernels and copies where CUDA is
present) is written as a Chrome trace JSON into the directory, readable
in Perfetto or ``chrome://tracing``. A payload pod sets
``TPUSHARE_TRACE_DIR`` on a debug run and takes the file from its
volume, with no code change. ``trace(None)`` with the env unset is a
no-op, so the hook stays in production paths.

The region runs with step spans naming the profile
(``tracing.start_step_spans(record=False)``: their
``record_function``s alone, no ring and no CUDA events), so the trace
names the serving engine's and the train step's phases
(``serve.step``, ``serve.admit_wave``, ``serve.prefill_chunk``,
``serve.decode_dispatch``, ``train.loss_and_grads``,
``train.optimizer_update``, ...) on the host timeline, and a gap on the
card sits under the phase that left it idle. Where step spans were
already on, the region leaves them to whoever turned them on.
"""

from __future__ import annotations

import contextlib
import os
import time

from tpushare_torch import consts, tracing

__all__ = ["trace", "env_trace_dir"]

ENV_TRACE_DIR = consts.ENV_TRACE_DIR


def env_trace_dir() -> str | None:
    """The trace directory requested through the env, or None."""
    d = os.environ.get(ENV_TRACE_DIR, "").strip()
    return d or None


@contextlib.contextmanager
def trace(directory: str | None = None, *, block: bool = True):
    """Profile the region into ``directory`` (default the
    ``TPUSHARE_TRACE_DIR`` env; a no-op when neither is set). Yields the
    directory (None when off).

    ``block=True`` synchronizes the card before the trace closes, so
    kernels launched inside the region are attributed to it rather than
    finishing after the profiler stopped."""
    directory = directory if directory is not None else env_trace_dir()
    if not directory:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    spans = tracing.start_step_spans(record=False)
    try:
        yield directory
    finally:
        if block and torch.cuda.is_available():
            torch.cuda.synchronize()
        if spans:
            tracing.stop_step_spans()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            directory, f"trace_{os.getpid()}_{time.time_ns()}.json"))
