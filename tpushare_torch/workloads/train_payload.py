"""Training payload of the port — ``python -m
tpushare_torch.workloads.train_payload``, the counterpart of
``tpushare/workloads/train_payload.py``: the process a *training* pod
runs under the binpacker.

Trains the reference payload's transformer (vocab 512, d_model 128,
8 heads of 16, 4 layers) on synthetic next-token data, checkpoints
every ``--save-every`` steps, and — what matters to the scheduler —
RESUMES from the newest checkpoint when restarted, so a pod the
binpacker evicts and replaces loses at most one save interval. A
SIGTERM drains between steps: the step in flight finishes, the state is
checkpointed and one last usage report is posted
(``usage_report.post_now``, a no-op outside the plugin's wiring) before
the process exits. ``TPUSHARE_TRACE_DIR`` profiles the training loop
(``profiling.trace``).

``--dp/--sp/--tp`` train over a mesh (``parallel/mesh.make_mesh``),
with ring attention when sp > 1, as the reference's payload; it prints
the reference's ``mesh:`` line. The mesh spans the host's first
dp*sp*tp CUDA devices, ``--mesh-devices`` (a comma-separated list,
which may name one card several times), or ``main``'s ``mesh_devices``;
a mesh the model does not tile exits 2. A checkpoint saved on one mesh
resumes on another. Under the plugin's grant (``TPUSHARE_HBM_LIMIT_MIB``
or ``XLA_PYTHON_CLIENT_MEM_FRACTION`` set) the allocator is capped on
every card of the mesh (``device.apply_hbm_cap``) and the usage
reporter runs. ``--device cpu`` runs the plain-PyTorch path; the
default is the card, and a host without CUDA raises.

A pod group (the ``TPUSHARE_GROUP_*`` envs Allocate injects) brings up
the ``gloo`` process group first (``multihost.init_from_env``; a group
with no coordinator or no rank exits 2 with the reference's words),
then trains over ``multihost.make_multihost_mesh``: dp across the
members, sp / tp inside each; every rank derives the same global batch
and feeds its own dp rows through ``shard_host_batch``. A member names
its visible cards (``--mesh-devices`` its own list; under ``--device
cpu`` the CPU dp*sp*tp / members times). ``--checkpoint-dir`` is
refused under a group, as the reference refuses it. Before the first
CUDA call a granted ``TPU_VISIBLE_CHIPS`` becomes
``CUDA_VISIBLE_DEVICES`` (``device.apply_visible_chips``).
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import sys
import time

import torch

from tpushare_torch import consts
from tpushare_torch.device import (apply_hbm_cap, apply_visible_chips,
                                   resolve_device)
from tpushare_torch.workloads import usage_report
from tpushare_torch.workloads.checkpoint import TrainCheckpointer
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         init_params)
from tpushare_torch.workloads.parallel import multihost
from tpushare_torch.workloads.parallel.mesh import (assert_divisible,
                                                    make_mesh)
from tpushare_torch.workloads.profiling import trace
from tpushare_torch.workloads.train import (init_state, make_optimizer,
                                            make_train_step, place_state)


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
    p.add_argument("--mesh-devices", default=None,
                   help="comma-separated devices of the mesh, in mesh "
                        "order (may repeat a device)")
    args = p.parse_args(argv)
    args.error = p.error
    return args


def payload_config(seq: int) -> TransformerConfig:
    """The reference payload's model."""
    return TransformerConfig(vocab=512, d_model=128, n_heads=8, n_layers=4,
                             d_ff=256, max_seq=seq)


def payload_mesh(args: argparse.Namespace, cfg, mesh_devices=None,
                 group: bool = False):
    """The mesh of ``--dp/--sp/--tp`` (None when none is given and there
    is no ``group``): over ``mesh_devices``, ``--mesh-devices``, or the
    first dp*sp*tp devices (the one CPU device named that often under
    ``--device cpu``); under a pod group this member's devices of
    ``multihost.make_multihost_mesh`` (its visible cards by default). A
    mesh that cannot be built or tiled exits 2."""
    if mesh_devices is None and args.mesh_devices:
        mesh_devices = [torch.device(d) for d in
                        args.mesh_devices.split(",")]
    if mesh_devices is None and args.dp is None and args.tp is None \
            and args.sp == 1 and not group:
        return None
    dp, tp = args.dp, args.tp
    dev = resolve_device(args.device)
    if mesh_devices is None and group and dev.type != "cuda":
        n = (dp or 1) * args.sp * (tp or 1)
        mesh_devices = [dev] * max(1, n // multihost.process_count())
    elif mesh_devices is None and not group:
        dp, tp = dp or 1, tp or 1
        n = dp * args.sp * tp
        mesh_devices = ([dev] * n if dev.type != "cuda" else
                        [torch.device("cuda", i) for i in
                         range(min(n, torch.cuda.device_count()))])
    try:
        mesh = (multihost.make_multihost_mesh(dp=dp, sp=args.sp, tp=tp,
                                              devices=mesh_devices)
                if group else
                make_mesh(dp=dp, sp=args.sp, tp=tp, devices=mesh_devices))
        assert_divisible(cfg, mesh)
        if args.batch % mesh.shape["dp"]:
            raise ValueError(f"batch {args.batch} not divisible by dp "
                             f"{mesh.shape['dp']}")
        if args.sp > 1 and args.seq % (2 * args.sp):
            raise ValueError(f"seq {args.seq} must divide into "
                             f"{2 * args.sp} ring blocks")
    except ValueError as e:
        args.error(f"mesh: {e}")
    return mesh


def main(argv: list[str] | None = None, mesh_devices=None) -> int:
    """Train, checkpoint, resume; ``mesh_devices`` names the mesh's
    devices (in mesh order, repeats allowed) as ``infer.run`` takes
    them."""
    args = parse_args(argv)
    # the chips Allocate granted, before the first CUDA call
    apply_visible_chips()
    # a pod group: the TPUSHARE_GROUP_* envs Allocate injected bring up
    # the process group; the mesh then spans every member's devices
    try:
        distributed = multihost.init_from_env()
    except ValueError as e:
        args.error(str(e))
    cfg = payload_config(args.seq)
    if distributed:
        if args.checkpoint_dir:
            raise SystemExit("--checkpoint-dir is single-host only (the "
                             "multi-host checkpoint story needs a shared "
                             "filesystem + orbax multiprocess arrays)")
        print(f"distributed: rank {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)
    mesh = payload_mesh(args, cfg, mesh_devices, group=distributed)
    device = (mesh.first_device() if mesh is not None
              else resolve_device(args.device))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if mesh is None:
        print(f"device: {device} ({name}), one device, no mesh", flush=True)
    else:
        print(f"mesh: {dict(mesh.shape)} on {mesh.size} "
              f"{device.type} devices ({name})", flush=True)
    if os.environ.get(consts.ENV_HBM_LIMIT_MIB) or \
            os.environ.get(consts.ENV_XLA_MEM_FRACTION):
        apply_hbm_cap([mesh.devices[c] for c in mesh.coords()
                       if mesh.is_local(c)] if mesh is not None
                      else device,
                      float(os.environ.get(consts.ENV_HBM_LIMIT_MIB, 0)))
    reporter = usage_report.start_reporter()
    optimizer = make_optimizer(lr=args.lr)

    ckpt = None
    state = None
    if args.checkpoint_dir:
        ckpt = TrainCheckpointer(args.checkpoint_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore(cfg, mesh if mesh is not None else device)
            print(f"resumed from step {int(state['step'])}", flush=True)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(init_params(gen, cfg, device), optimizer)
        if mesh is not None:
            state = place_state(state, mesh)

    step_fn = make_train_step(
        cfg, optimizer, mesh if mesh is not None else device,
        ring_attention=mesh is not None and mesh.shape["sp"] > 1)
    gen = torch.Generator(device=device).manual_seed(1)
    inputs = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=gen, device=device)
    targets = torch.roll(inputs, -1, dims=1)
    if distributed:
        # every rank derives the same global batch; each places only its
        # own dp rows (process-major mesh order: rank r owns rows
        # [r*B/nproc, (r+1)*B/nproc))
        nproc, rank = multihost.process_count(), multihost.process_index()
        if args.batch % nproc:
            raise SystemExit(f"--batch {args.batch} must divide by the "
                             f"{nproc} group members")
        rows = slice(rank * args.batch // nproc,
                     (rank + 1) * args.batch // nproc)
        inputs = multihost.shard_host_batch(inputs[rows], mesh)
        targets = multihost.shard_host_batch(targets[rows], mesh)

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
    # and is checked BETWEEN steps, so the payload finishes its step,
    # checkpoints and posts a final usage report instead of dying
    # mid-step and losing a save interval
    previous = signal.getsignal(signal.SIGTERM)
    sigq = install_signal_queue((signal.SIGTERM,))
    evicted: int | None = None
    loss = torch.tensor(float("nan"))
    t0 = t_after_first = time.perf_counter()
    # the env-gated profiler trace (TPUSHARE_TRACE_DIR; unset: no-op)
    try:
        with trace():
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
    if reporter is not None:
        reporter.set()
    if evicted is not None:
        # the eviction's last word: the node daemon sees the final state
        usage_report.post_now()
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
