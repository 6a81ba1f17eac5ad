#!/usr/bin/env python3
"""Host cost of the serving control plane per decode chunk.

    python scripts/torch_telemetry_cost.py [--device cpu] [--admission]

Runs ``infer``'s ``serve --paged`` engine (the smoke's serve traffic:
16 requests, 8 lanes, flagship preset on the card) once to warm up and
once measured, with every control-plane call on the host timed where it
is made: the ``EngineTelemetry`` hooks, the request-trace marks, bumps
and flushes, the page publication and, with ``--admission`` (the
payload's default), the admission controller's decisions. Prints one
JSON line: decode chunks, the control plane's host seconds in all and
per chunk, the run's wall seconds, the control plane's share of it and
its six costliest calls.
A call made inside another timed call counts once, in the outer one.
Each timed call also pays two ``perf_counter`` reads (about 0.1 us), so
the figure is an upper bound.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SERVE = ["--mode", "serve", "--paged", "--requests", "16", "--slots", "4",
         "--seq", "512", "--steps", "128", "--hbm-limit-mib", "80000",
         "--seed", "0"]
TELEMETRY_HOOKS = ("submitted", "admit_start", "prefill_start", "admitted",
                   "prefill_chunk", "first_token", "decode_chunk", "retired",
                   "shed", "deadline_exceeded", "oom_recovery",
                   "set_watermark", "set_degraded", "set_pages",
                   "set_drain_state")
TRACE_CALLS = ("mark", "bump", "finish")
ADMISSION_CALLS = ("admit_ok_pages", "could_ever_fit_pages", "on_progress",
                   "on_oom", "watermark", "pressure_deferring")
ENGINE_CALLS = ("_publish_pages", "_trace_req", "_finish_trace")


class Clock:
    def __init__(self) -> None:
        self.restart()

    def restart(self) -> None:
        self.seconds = 0.0
        self.calls = 0
        self.by_name: dict[str, list] = {}
        self.depth = 0
        self.t0 = time.perf_counter()

    def wrap(self, fn, name: str):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
                dt = time.perf_counter() - t0
                if not self.depth:        # nested calls count once
                    self.seconds += dt
                    self.calls += 1
                entry = self.by_name.setdefault(name, [0, 0.0])
                entry[0] += 1
                entry[1] += dt
        return timed


def instrument(eng, clock: Clock) -> None:
    """Time every control-plane call of ``eng`` (bound methods on the
    instances; the trace methods on the class, as requests make their
    own)."""
    from tpushare_torch import tracing
    for name in TELEMETRY_HOOKS:
        setattr(eng.telemetry, name,
                clock.wrap(getattr(eng.telemetry, name), name))
    if eng.admission is not None:
        for name in ADMISSION_CALLS:
            setattr(eng.admission, name,
                    clock.wrap(getattr(eng.admission, name), name))
    for name in ENGINE_CALLS:
        setattr(eng, name, clock.wrap(getattr(eng, name), name))
    reset = eng.reset_stats

    def reset_and_restart() -> None:
        # the payload resets stats between its warm-up and the measured
        # wave: the clock measures that wave alone
        reset()
        clock.restart()
    eng.reset_stats = reset_and_restart
    for name in TRACE_CALLS:
        setattr(tracing.RequestTrace, name,
                clock.wrap(getattr(tracing.RequestTrace, name),
                           f"trace.{name}"))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="torch_telemetry_cost")
    p.add_argument("--device", default="cuda")
    p.add_argument("--admission", action="store_true",
                   help="keep infer's admission controller on")
    args = p.parse_args(argv)
    import torch
    from tpushare_torch.workloads import infer
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    flags = SERVE + ["--device", args.device]
    if not args.admission:
        flags.append("--no-admission")
    if args.device == "cpu":
        flags[flags.index("80000")] = "2000"
    ns = infer.parse_args(flags)
    setup = infer.serve_engine(ns)
    eng = setup["engine"]
    clock = Clock()
    instrument(eng, clock)
    # the warm-up request and the measured wave, as the payload runs them
    res = infer.serve_traffic(eng, ns, setup["cfg"], setup["device"],
                              setup["plen"], setup["max_seq"],
                              setup["n_lanes"])
    if setup["device"].type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - clock.t0
    chunks = res["engine"].stats["chunks"]
    print(json.dumps({
        "device": str(setup["device"]), "admission": args.admission,
        "decode_chunks": chunks, "control_calls": clock.calls,
        "control_s": clock.seconds,
        "control_us_per_chunk": clock.seconds / max(1, chunks) * 1e6,
        "wall_s": wall, "control_share": clock.seconds / wall,
        "tokens_per_s": res["tokens_per_s"],
        # the costliest calls: name -> [calls, seconds]
        "top": dict(sorted(clock.by_name.items(),
                           key=lambda kv: -kv[1][1])[:6])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
