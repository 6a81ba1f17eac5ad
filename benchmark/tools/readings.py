"""Readings that set a cell's limits, taken on the card at the cell's
own size: the program's numbers over many seeds, the control's (the
plain reference computed with fp8 operands in the program's place)
and, for a training cell, a planted fault's (half of the batch left
out, the mean taken over the rest). Not run by the benchmark's runs.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--fault-seeds 1,2] [--seconds 20] \
        [--rates 1.5,2.5] [--shape-seeds 20,21] [--pool-pages 12545] \
        [--out chiprun_out/readings.jsonl]

A serving cell runs a short window at the cell's load per seed (or, with
``--rates``, at each rate on the first seed: the sweep for the knee; or,
with ``--shape-seeds``, the mix's arrivals and lengths drawn from each
of those orders on the first seed) and reads the program's and the
control's gaps on the same requests, and the pool's peak."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _floats(s: str) -> list[float]:
    return [float(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=_floats, default=[])
    ap.add_argument("--shape-seeds", type=_ints, default=[])
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as runmod
    runmod.set_env()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    from benchmark import harness, model, traffic
    from benchmark.trace import DeviceTrace
    cell = harness.load_cell(args.workload)
    if args.pool_pages:
        cell["engine"] = {**cell["engine"], "n_pages": args.pool_pages}
    config = model.load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    base = {"cell": cell, "config": config, "m": model.dims(config),
            "mix": mix, "traffic": traffic.generator(mix), "trace": False,
            "device": "cuda", "tracer": DeviceTrace}
    if cell["driver"] == "train":
        train_readings(base, args, emit)
    else:
        serve_readings(base, args, emit)
    if out:
        out.close()
    return 0


def train_readings(base: dict, args, emit) -> None:
    import torch

    from benchmark import checks
    from benchmark.drivers import train as drv
    from benchmark.drivers.common import free_device
    import tpushare_torch.workloads.train as port_train
    from tpushare_torch.workloads.models.transformer import forward

    def half_loss(params, inputs, targets, cfg):
        logits = forward(params, inputs, cfg)
        B, S = targets.shape
        if B > 1:
            logits, targets = logits[: B // 2], targets[: B // 2]
        else:
            logits, targets = logits[:, : S // 2], targets[:, : S // 2]
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets.long()[..., None]).mean()

    sound = port_train.loss_and_grads

    def program(ctx, fault=None):
        if fault == "half":
            port_train.loss_and_grads = (
                lambda p, i, t, cfg: sound(p, i, t, cfg, loss_of=half_loss))
        try:
            t0 = time.perf_counter()
            state, step, batch, readings = drv.setup(ctx)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            port_train.loss_and_grads = sound
        del state, step
        free_device("cuda")
        return batch, readings, secs

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.fault_seeds))
    for seed in seeds:
        ctx = {**base, "seed": seed}
        batch, readings, secs = program(ctx)
        t0 = time.perf_counter()
        ref = drv.reference(ctx, batch)
        ref_s = time.perf_counter() - t0
        if seed in args.seeds:
            emit({"seed": seed, "kind": "program", "setup_steps_s": secs,
                  "reference_s": ref_s,
                  **checks.train_numbers(readings, ref),
                  "losses": readings["losses"], "ref_losses": ref["losses"]})
        if seed in args.control_seeds:
            ctl = drv.reference(ctx, batch, prec="fp8")
            emit({"seed": seed, "kind": "control_fp8",
                  **checks.train_numbers(ctl, ref),
                  "losses": ctl["losses"], "ref_losses": ref["losses"]})
        if seed in args.fault_seeds:
            _, bad, _ = program(ctx, fault="half")
            emit({"seed": seed, "kind": "fault_half_batch",
                  **checks.train_numbers(bad, ref),
                  "losses": bad["losses"], "ref_losses": ref["losses"]})
        free_device("cuda")


def serve_readings(base: dict, args, emit) -> None:
    from benchmark.drivers import serve as drv
    from benchmark.harness import percentile
    rate0 = float(base["cell"]["rate_rps"])
    shape0 = base["mix"]["shape_seed"]
    if args.rates:
        runs = [(args.seeds[0], r, shape0) for r in args.rates]
    elif args.shape_seeds:
        runs = [(args.seeds[0], rate0, k) for k in args.shape_seeds]
    else:
        runs = [(s, rate0, shape0) for s in args.seeds]
    for seed, rate, shape in runs:
        cell = {**base["cell"], "rate_rps": rate}
        ctx = {**base, "cell": cell, "seed": seed, "seconds": args.seconds,
               "mix": {**base["mix"], "shape_seed": shape},
               "t_start": time.perf_counter(),
               "control": seed in args.control_seeds}
        rec = drv.run(ctx)
        reqs = rec["requests"]

        def ms(key):
            vals = [r[key] if r[key] is not None
                    else rec["span_s"] - r["due_s"] for r in reqs]
            return {f"{key[:-2]}_p50_ms": 1e3 * percentile(vals, 50),
                    f"{key[:-2]}_p90_ms": 1e3 * percentile(vals, 90)}
        emit({"seed": seed, "rate_rps": rate, "shape_seed": shape,
              "seconds": args.seconds, **rec["pool"],
              "offered": len(reqs), "failed": rec["failed"],
              "span_s": rec["span_s"], "setup_s": rec["setup_s"],
              "waves": len(rec["waves"]), "chunks": len(rec["chunks"]),
              **ms("ttft_s"), **ms("queue_s"),
              "late_max_s": max((r["late_s"] or 0.0) for r in reqs),
              "peak_gib": rec["peak_bytes"] / 2 ** 30,
              **rec["numbers"]})


if __name__ == "__main__":
    sys.exit(main())
