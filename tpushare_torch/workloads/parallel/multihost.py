"""Meshes over the processes of a pod group — the port of
``tpushare/workloads/parallel/multihost.py``.

The workload half of the pod-group contract, as the reference has it:

- the scheduler-extender places the members of a pod group
  (``tpushare.aliyun.com/group`` label) and writes each member's rank
  annotation at bind;
- the device plugin's Allocate injects the rank, size and coordinator
  envs (``TPUSHARE_GROUP_RANK`` / ``_SIZE`` / ``TPUSHARE_COORDINATOR``)
  into the container;
- :func:`init_from_env` turns those envs into a ``torch.distributed``
  process group, and :func:`make_multihost_mesh` builds a mesh whose
  bandwidth-hungry axes (sp, tp, ep) never cross a process boundary,
  while exactly one axis (dp by default, pp for cross-host pipelines)
  spans the processes.

The transport across processes is ``gloo`` over TCP, the counterpart of
the reference's DCN: one card cannot hold two NCCL ranks (the smoke runs
a two-process group on one card), and the step's cross-process
collectives are exact gathers followed by the one-process rank-order
fp32 sums (``mesh.exchange``, ``mesh.gather_replica_grads``), never a
backend's ``all_reduce(SUM)``, so a two-process step gives the bits of
the one-process step over the same global mesh. CUDA tensors are staged
through host memory.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch

from tpushare_torch import consts
from tpushare_torch.workloads.parallel.mesh import (AXES, Mesh, Sharded,
                                                    data_spec, make_mesh)

log = logging.getLogger("tpushare_torch.multihost")

# how long a member waits for the rest of its group at the rendezvous
# and in every collective before it fails
TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# torch.distributed bring-up
# ---------------------------------------------------------------------------

def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Bring up the ``gloo`` process group from the arguments, falling
    back to the plugin-injected group envs (``TPUSHARE_COORDINATOR``,
    else torch's own ``MASTER_ADDR:MASTER_PORT``), falling back to
    single-process.

    Returns True when a multi-process group was brought up, False for
    the single-process no-op (size absent or <= 1). A declared group
    without a coordinator or a rank raises: no member carries on
    alone."""
    coordinator = coordinator or os.environ.get(consts.ENV_COORDINATOR)
    if not coordinator and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        size = os.environ.get(consts.ENV_GROUP_SIZE)
        if size:
            try:
                num_processes = int(size)
            except ValueError:
                raise ValueError(
                    f"{consts.ENV_GROUP_SIZE}={size!r} is not an integer — "
                    f"check the pod's {consts.GROUP_SIZE_LABEL} label "
                    "(Allocate forwards it verbatim)") from None
    if process_id is None:
        rank = os.environ.get(consts.ENV_GROUP_RANK)
        if rank not in (None, ""):
            try:
                process_id = int(rank)
            except ValueError:
                raise ValueError(
                    f"{consts.ENV_GROUP_RANK}={rank!r} is not an integer — "
                    "the extender stamps this annotation at bind; check "
                    f"for a manual {consts.GROUP_RANK_ANNOTATION} override"
                ) from None
    if not num_processes or num_processes <= 1:
        return False
    if not coordinator:
        # a declared group with no rendezvous point is a misconfiguration,
        # not a single-host run: N pods each training alone would clobber
        # each other's checkpoints with no error anywhere
        raise ValueError(
            f"group size {num_processes} but no coordinator address: set "
            f"the {consts.COORDINATOR_ANNOTATION} pod annotation (or "
            f"{consts.ENV_COORDINATOR} / MASTER_ADDR:MASTER_PORT) to the "
            "rank-0 member's stable DNS, e.g. trainer-0.trainer:8476")
    if process_id is None:
        raise ValueError(
            f"multi-host group of {num_processes} needs a rank: pass "
            f"process_id or set {consts.ENV_GROUP_RANK} (the device "
            "plugin injects it from the extender's rank annotation)")
    import torch.distributed as dist
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) is already up; asked for rank "
                f"{process_id} of {num_processes}")
        return True
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    log.info("distributed runtime up: rank %d/%d via %s", process_id,
             num_processes, coordinator)
    return True


def init_from_env() -> bool:
    """``init_distributed()`` resolved purely from the Allocate-injected
    envs — the one-liner a containerized training script calls first."""
    return init_distributed()


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# hybrid mesh construction
# ---------------------------------------------------------------------------

class GridDevice:
    """One device of the global grid: its process, its global id, and —
    on its own process — its ``torch.device`` (None elsewhere)."""

    def __init__(self, process_index: int, dev_id: int,
                 device: torch.device | None = None) -> None:
        self.process_index = process_index
        self.id = dev_id
        self.device = device

    def __repr__(self) -> str:
        return f"d{self.id}@p{self.process_index}"


def _device_grid(devices, dp: int, sp: int, tp: int, ep: int, pp: int,
                 dcn_axis: str) -> np.ndarray:
    """Order devices process-major and reshape into the (dp, sp, tp, ep,
    pp) grid with ``dcn_axis`` spanning processes.

    Pure function over anything with ``.process_index`` / ``.id`` so the
    placement logic is unit-testable without a process group."""
    if dcn_axis not in ("dp", "pp"):
        raise ValueError(f"dcn_axis must be 'dp' or 'pp', got {dcn_axis!r}"
                         " (sp/tp/ep collectives sit on the per-layer "
                         "critical path and must stay on ICI)")
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    n = len(devs)
    sizes = dict(dp=dp, sp=sp, tp=tp, ep=ep, pp=pp)
    if dp * sp * tp * ep * pp != n:
        raise ValueError(f"dp*sp*tp*ep*pp = {dp}*{sp}*{tp}*{ep}*{pp} "
                         f"!= {n} devices")
    counts: dict[int, int] = {}
    for d in devs:
        counts[d.process_index] = counts.get(d.process_index, 0) + 1
    nproc = len(counts)
    per = n // nproc
    if set(counts.values()) != {per}:
        raise ValueError(f"uneven devices per process: {counts} — the "
                         "hybrid grid needs identical hosts")
    if sizes[dcn_axis] % nproc:
        raise ValueError(
            f"DCN axis {dcn_axis}={sizes[dcn_axis]} must be a multiple of "
            f"the {nproc} processes (each host contributes the same slice "
            "of the axis)")
    # with the DCN axis a multiple of nproc and process-major ordering,
    # every reshape row of the other axes packs whole into one process
    if dcn_axis == "dp":
        # dp slowest-varying: its process-spanning factor on the seams
        grid = np.array(devs, dtype=object).reshape(dp, sp, tp, ep, pp)
    else:
        # pp outermost (one or more stages per process), then back to
        # the canonical (dp, sp, tp, ep, pp) axis order
        grid = np.array(devs, dtype=object).reshape(pp, dp, sp, tp, ep)
        grid = grid.transpose(1, 2, 3, 4, 0)
    return grid


def ici_violations(grid: np.ndarray, dcn_axis: str) -> list[str]:
    """Which non-DCN axes cross a process boundary? (empty = healthy)."""
    bad = []
    for k, name in enumerate(AXES):
        if name == dcn_axis or grid.shape[k] == 1:
            continue
        lead = np.moveaxis(grid, k, 0)
        procs = np.vectorize(lambda d: d.process_index)(lead)
        if not (procs == procs[:1]).all():
            bad.append(name)
    return bad


def _grid_devices(devices) -> list:
    """The global device list: descriptors with ``.process_index`` as
    given, or this process's devices (the visible cards by default; a
    list may repeat one) joined with every other member's count over
    the group."""
    if devices is not None:
        devs = list(devices)
        if devs and hasattr(devs[0], "process_index"):
            return devs
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devs]
    nproc, rank = process_count(), process_index()
    counts = [len(local)]
    if nproc > 1:
        import torch.distributed as dist
        counts = [None] * nproc
        dist.all_gather_object(counts, len(local))
    out, next_id = [], 0
    for p, count in enumerate(counts):
        for i in range(count):
            out.append(GridDevice(p, next_id + i,
                                  local[i] if p == rank else None))
        next_id += count
    return out


def make_multihost_mesh(dp: int | None = None, sp: int = 1,
                        tp: int | None = None, ep: int = 1, pp: int = 1,
                        dcn_axis: str = "dp", devices=None) -> Mesh:
    """The (dp, sp, tp, ep, pp) :class:`~mesh.Mesh` of a process group.

    The axis names and defaults of ``mesh.make_mesh`` (so every train
    step works unchanged), plus the hybrid guarantee: sp / tp / ep (and
    whichever of dp / pp is not the DCN axis) are placed within single
    processes; ``dcn_axis`` spans them. Every coordinate knows its
    process; only this process's hold a device. ``devices`` is this
    process's list (None: its visible CUDA devices; a list may name one
    card several times); the members exchange their counts, so every
    rank builds the same grid. With one process this is
    ``make_mesh``."""
    devs = _grid_devices(devices)
    n = len(devs)
    nproc = len({d.process_index for d in devs})
    per = n // max(nproc, 1)
    if tp is None:
        # largest power-of-two <= 4 whose ICI block still fits one host
        rest = sp * ep * (pp if dcn_axis != "pp" else 1)
        fits = [d for d in (1, 2, 4)
                if n % (d * sp * ep * pp) == 0 and per % (d * rest) == 0]
        if not fits:
            raise ValueError(
                f"no tp in (1, 2, 4) fits: sp*ep{'*pp' if dcn_axis != 'pp' else ''}"
                f"={rest} must divide the {per} devices of one host "
                f"({n} devices / {nproc} processes) — shrink the ICI axes "
                "or add local devices")
        tp = max(fits)
    if dp is None:
        dp = n // (tp * sp * ep * pp)
    if nproc == 1:
        return make_mesh(dp=dp, tp=tp, sp=sp, ep=ep, pp=pp,
                         devices=[d.device for d in devs])
    grid = _device_grid(devs, dp, sp, tp, ep, pp, dcn_axis)
    bad = ici_violations(grid, dcn_axis)
    if bad:
        raise AssertionError(f"axes {bad} cross process boundaries — "
                             "device ordering violated the hybrid layout")
    procs = np.vectorize(lambda d: d.process_index)(grid)
    local = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        local[idx] = grid[idx].device
    return Mesh(local, AXES, processes=procs,
                process_index=process_index())


def shard_host_batch(local, mesh: Mesh, spec=None) -> Sharded:
    """This process's rows of the global (B, S) batch as the batch
    placed over ``spec`` (default ``data_spec()``: batch over dp,
    sequence over sp) — its blocks only, each on its coordinate's
    device. ``local`` is the consecutive rows this host owns in rank
    order (B/nproc of them when dp spans the processes, all B when pp
    does); sp / tp shards are process-local by construction, so no data
    crosses processes."""
    if not isinstance(local, torch.Tensor):
        local = torch.as_tensor(np.asarray(local))
    spec = tuple(spec if spec is not None else data_spec())
    shape = list(local.shape)
    lo: dict[int, int] = {}
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        ranks = mesh.local_ranks(axis)
        shape[dim] = local.shape[dim] * mesh.shape[axis] // len(ranks)
        lo[dim] = ranks[0]
    shards = {}
    for c in mesh.coords():
        if not mesh.is_local(c):
            continue
        idx = []
        for dim, axis in enumerate(spec):
            if axis is None:
                idx.append(slice(None))
                continue
            w = shape[dim] // mesh.shape[axis]
            r = c[mesh.axis_names.index(axis)] - lo[dim]
            idx.append(slice(r * w, (r + 1) * w))
        part = local[tuple(idx)]
        shards[c] = torch.empty(part.shape, dtype=part.dtype,
                                device=mesh.devices[c]).copy_(part)
    return Sharded(mesh, spec, tuple(shape), shards)
