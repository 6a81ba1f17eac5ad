"""Training payload of the port — ``python -m
tpushare_torch.workloads.train_payload``, the counterpart of
``tpushare/workloads/train_payload.py``: the process a *training* pod
runs under the binpacker.

Trains the reference payload's transformer (vocab 512, d_model 128,
8 heads of 16, 4 layers) on synthetic next-token data, checkpoints
every ``--save-every`` steps, and — what matters to the scheduler —
RESUMES from the newest checkpoint when restarted, so a pod the
binpacker evicts and replaces loses at most one save interval. A
SIGTERM drains between steps: the step in flight finishes and the state
is checkpointed before the process exits.

One device only in this slice: ``--dp/--sp/--tp`` above 1 and a
multi-host pod group exit 2 (the mesh and ring attention are ROADMAP
A.10). ``--device cpu`` runs the plain-PyTorch path; the default is the
card, and a host without CUDA raises.
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import sys
import time

import torch

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.checkpoint import TrainCheckpointer
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         init_params)
from tpushare_torch.workloads.train import (init_state, make_optimizer,
                                            make_train_step)

# the multi-host pod-group envs the device plugin's Allocate injects
# (the port's copy of the reference's consts)
ENV_GROUP_SIZE = "TPUSHARE_GROUP_SIZE"


def install_signal_queue(signals: tuple[int, ...]) -> "queue.Queue[int]":
    """Deliver ``signals`` through a queue — the port's copy of the
    reference's ``deviceplugin/watchers.install_signal_queue``."""
    q: "queue.Queue[int]" = queue.Queue()

    def handler(signum, frame):  # noqa: ARG001
        q.put(signum)

    for s in signals:
        signal.signal(s, handler)
    return q


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="tpushare-torch-train-payload")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)
    mesh = {"dp": args.dp or 1, "sp": args.sp, "tp": args.tp or 1}
    if any(n > 1 for n in mesh.values()):
        p.error(f"mesh {mesh}: training over more than one device is not "
                "ported yet (ROADMAP A.10); run with one device")
    group = os.environ.get(ENV_GROUP_SIZE, "")
    if group not in ("", "0", "1"):
        p.error(f"{ENV_GROUP_SIZE}={group}: multi-host training is not "
                "ported yet (ROADMAP A.10)")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = TransformerConfig(vocab=512, d_model=128, n_heads=8, n_layers=4,
                            d_ff=256, max_seq=args.seq)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}), one device, no mesh", flush=True)
    optimizer = make_optimizer(lr=args.lr)

    ckpt = None
    state = None
    if args.checkpoint_dir:
        ckpt = TrainCheckpointer(args.checkpoint_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore(cfg, device)
            print(f"resumed from step {int(state['step'])}", flush=True)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(init_params(gen, cfg, device), optimizer)

    step_fn = make_train_step(cfg, optimizer, device)
    gen = torch.Generator(device=device).manual_seed(1)
    inputs = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=gen, device=device)
    targets = torch.roll(inputs, -1, dims=1)

    start = int(state["step"])
    if start >= args.steps:
        print(f"checkpoint already at step {start} >= --steps {args.steps}; "
              f"nothing to train", flush=True)
        if ckpt:
            ckpt.close()
        return 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # graceful SIGTERM drain (pod eviction): the signal lands in a queue
    # and is checked BETWEEN steps, so the payload finishes its step and
    # checkpoints instead of dying mid-step and losing a save interval.
    # The reference also posts a final usage report on this path and
    # wraps the loop in its env-gated profiler trace; the port's
    # usage_report and profiling modules are ROADMAP A.12.
    previous = signal.getsignal(signal.SIGTERM)
    sigq = install_signal_queue((signal.SIGTERM,))
    evicted: int | None = None
    loss = torch.tensor(float("nan"))
    t0 = t_after_first = time.perf_counter()
    try:
        for i in range(start, args.steps):
            try:
                evicted = sigq.get_nowait()
            except queue.Empty:
                evicted = None
            if evicted is not None:
                print(f"signal {evicted}: graceful drain at step {i} — "
                      "checkpointing", flush=True)
                break
            state, loss = step_fn(state, inputs, targets)
            if i == start:
                # the first step builds the kernels; keep it out of the
                # throughput window
                sync()
                t_after_first = time.perf_counter()
            if ckpt and (i + 1) % args.save_every == 0:
                ckpt.save(state)
                print(f"step {i + 1}: loss={float(loss):.4f} "
                      "(checkpointed)", flush=True)
            elif (i + 1) % 5 == 0:
                print(f"step {i + 1}: loss={float(loss):.4f}", flush=True)
    finally:
        signal.signal(signal.SIGTERM, previous)
    loss = float(loss)
    sync()
    dt = time.perf_counter() - t0
    dt_steady = time.perf_counter() - t_after_first
    done = int(state["step"])
    if ckpt and done > start and done % args.save_every:
        ckpt.save(state)
    if ckpt:
        ckpt.close()
    steps_run = done - start
    steady_steps = max(steps_run - 1, 0)
    tps = (args.batch * args.seq * steady_steps / dt_steady
           if steady_steps and dt_steady > 0 else 0.0)
    print(f"trained {steps_run} steps in {dt:.2f}s "
          f"({tps:,.0f} tokens/s steady-state), final loss={loss:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
