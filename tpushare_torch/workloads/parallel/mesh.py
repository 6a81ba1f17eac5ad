"""Meshes of the port — ``tpushare/workloads/parallel/mesh.py``: the
training mesh (``make_mesh``, ``param_specs``, ``moe_param_specs``,
``data_spec``, ``place_params``, ``place_data``, ``assert_divisible``)
and the serving half (``make_serving_mesh``, ``serving_degrees``,
``check_serving_mesh``, ``place_serving_params``).

The reference is one controller over a device grid: XLA runs each
shard's program on its chip and inserts the collectives. The port keeps
the one controller: :class:`Mesh` names the axes of an explicit grid of
``torch.device``s, every shard's tensors live on their grid device, and
the collectives are explicit copies and sums in rank order. A grid may
name one device several times — how a 2×2 mesh runs on one card or on
the CPU; NCCL, which refuses two ranks on one GPU, is not needed.

**Across processes** (a pod group, ``multihost.make_multihost_mesh``)
each process is that controller for its own coordinates, and the grid
records every coordinate's process. Where a sum crosses processes, the
operands are gathered exactly over ``torch.distributed``'s ``gloo``
group (:func:`exchange`) and summed in the one-process rank order in
fp32, so the result is the one-process result bit for bit
(:func:`gather_replica_grads`); a pipeline stage handoff across
processes is a :class:`SendStage` / :class:`RecvStage` pair.

**Training.** ``make_mesh`` builds the reference's five-axis
``("dp", "sp", "tp", "ep", "pp")`` grid. ``place_params`` splits each
leaf per its spec — the reference's megatron layout: ``wq`` / ``wk`` /
``wv`` / ``w1`` / ``w3`` by column over tp, ``wo`` / ``w2`` by row,
``embed`` and ``out`` over tp on their second axis, the norms whole —
into a :class:`Sharded` leaf that holds one tensor per grid coordinate:
every replica (a coordinate that differs only along an axis the spec
does not split) is its own copy on its own device, as every device of
a JAX mesh holds its own. The training step keeps the replicas bitwise
equal: each takes the same gradient, summed over the replicas in rank
order in fp32 (:func:`sum_replica_grads`), and the same AdamW update.
:class:`Reduce` and :class:`Broadcast` are the two collectives of the
step's forward: a fp32 sum of per-rank partials in rank order (the
reference's ``psum`` over tp), and its adjoint, one tensor copied to
every rank, whose backward sums the ranks' gradients in rank order.

**Serving.** The layout is the reference's exactness-preserving one
(``mesh.py:118-142``): the layer stack splits into pp stages; the
column projections ``wq`` / ``wk`` / ``wv`` / ``w1`` / ``w3`` split
their output columns over tp (head by head, hidden column by hidden
column, in rank order); ``wo``, ``w2``, the norms, the embedding,
``norm_f`` and ``out`` are not split. The engine gathers the tp
activations in rank order before the down-projections instead of
summing partial products, so the down-projection consumes the operand
the unsharded layer does. The unsplit weights of a stage live once, on
the stage's rank-0 device, where the one controller runs the stage's
replicated ops; embedding, ``lm_head`` and sampling run on the mesh's
first device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpushare_torch import consts

# the training mesh's axes, in the reference's order
AXES = ("dp", "sp", "tp", "ep", "pp")

# the column projections a serving mesh splits over tp; every other
# layer leaf stays whole
TP_COLUMNS = ("wq", "wk", "wv", "w1", "w3")


class Mesh:
    """Named axes over an explicit grid of ``torch.device``s:
    ``Mesh(grid, ("tp", "pp"))`` with ``grid[r][s]`` the device of tp
    rank r in pipeline stage s (``("dp", "tp")`` for a slot engine's
    ragged read). ``shape`` maps each axis to its size, as a JAX mesh's
    does.

    A mesh over the processes of a group (``multihost.
    make_multihost_mesh``) also carries ``processes``, the grid of the
    process that owns each coordinate, and ``process_index``, this
    process's rank: only this process's coordinates hold a device (the
    others ``None``), and the collectives of the step reach the other
    coordinates over ``torch.distributed``'s default group."""

    def __init__(self, devices, axis_names: tuple[str, ...],
                 processes=None, process_index: int = 0) -> None:
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = None if given[idx] is None else \
                torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.processes = (None if processes is None else
                          np.asarray(processes, dtype=int).reshape(
                              grid.shape))
        self.process_index = int(process_index)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multiprocess(self) -> bool:
        """Whether the grid spans more than one process."""
        return self.processes is not None and \
            len(set(self.processes.flat)) > 1

    def coords(self):
        """Every grid coordinate, in rank order (the last axis fastest)."""
        return list(np.ndindex(self.devices.shape))

    def process_of(self, coord: tuple) -> int:
        """The process that owns grid coordinate ``coord``."""
        return 0 if self.processes is None else int(self.processes[coord])

    def is_local(self, coord: tuple) -> bool:
        """Whether this process owns grid coordinate ``coord``."""
        return self.process_of(coord) == self.process_index

    def owner(self, **coords: int) -> int:
        """The process owning the given axis coordinates (absent 0)."""
        return self.process_of(tuple(coords.get(a, 0)
                                     for a in self.axis_names))

    def local_ranks(self, axis: str) -> list[int]:
        """The ranks along ``axis`` of which this process owns a
        coordinate, in order."""
        k = self.axis_names.index(axis)
        return sorted({c[k] for c in self.coords() if self.is_local(c)})

    def first_device(self) -> torch.device:
        """This process's first grid device."""
        return next(self.devices[c] for c in self.coords()
                    if self.is_local(c))

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (absent axes 0);
        ``None`` where another process owns them."""
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]


def make_serving_mesh(tp: int = 1, pp: int = 1, devices=None) -> Mesh:
    """The (tp, pp) mesh a sharded ``PagedServingEngine`` serves over:
    tensor parallelism over the KV-head axis, pipeline stages over the
    layer axis, factorized tp-major as the reference's (consecutive
    devices are tp neighbours). ``devices=None`` takes every CUDA
    device of the host; an explicit list may repeat a device."""
    if tp < 1 or pp < 1:
        raise ValueError(f"serving mesh degrees tp={tp}, pp={pp} must "
                         "both be >= 1")
    devs = list(devices if devices is not None else
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())])
    n = tp * pp
    if n > len(devs):
        raise ValueError(f"serving mesh tp*pp={tp}*{pp} needs {n} "
                         f"devices, have {len(devs)}")
    flat = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        flat[i] = torch.device(d)
    return Mesh(flat.reshape(pp, tp).T, ("tp", "pp"))


def serving_degrees(mesh) -> tuple[int, int]:
    """(tp, pp) of a mesh as the serving engine reads them; absent axes
    count 1, and no mesh is (1, 1)."""
    if mesh is None:
        return 1, 1
    return int(mesh.shape.get("tp", 1)), int(mesh.shape.get("pp", 1))


def check_serving_mesh(cfg, mesh) -> None:
    """Refuse a model that cannot tile a serving mesh, through the
    ``ERR_SERVING_MESH_*`` contract strings: KV heads (and heads) over
    tp, the MLP hidden columns over tp, the layer stack over pp."""
    tp, pp = serving_degrees(mesh)
    if tp > 1 and (cfg.kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(consts.ERR_SERVING_MESH_HEADS_FMT.format(
            tp=tp, kv_heads=cfg.kv_heads, n_heads=cfg.n_heads))
    if tp > 1 and cfg.d_ff % tp:
        raise ValueError(consts.ERR_SERVING_MESH_FF_FMT.format(
            tp=tp, d_ff=cfg.d_ff))
    if pp > 1 and cfg.n_layers % pp:
        raise ValueError(consts.ERR_SERVING_MESH_LAYERS_FMT.format(
            pp=pp, n_layers=cfg.n_layers))


def place_serving_params(params: dict, mesh: Mesh) -> dict:
    """The weights of a sharded serving engine, placed on the mesh:

    ``{"embed", "norm_f", "out"}`` whole on the mesh's first device, and
    ``"stages"``: per pipeline stage s, ``{"lead": {ln1, ln2, wo, w2}``
    (the stage's layers, whole, on its rank-0 device) ``, "ranks": [{wq,
    wk, wv, w1, w3}`` (rank r's output columns of the stage's layers, on
    device (r, s))``]}``. Every leaf is a contiguous copy, so the
    caller's params stay as they were."""
    tp, pp = serving_degrees(mesh)
    home = mesh.device(tp=0, pp=0)
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    per = L // pp

    def put(t, dev):
        return t.to(dev).contiguous() if t.device != dev else t.clone()

    stages = []
    for s in range(pp):
        lo, hi = s * per, (s + 1) * per
        lead = mesh.device(tp=0, pp=s)
        ranks = []
        for r in range(tp):
            dev = mesh.device(tp=r, pp=s)
            cols = {}
            for name in TP_COLUMNS:
                w = layers[name][lo:hi]
                c = w.shape[-1] // tp
                cols[name] = put(w[..., r * c:(r + 1) * c], dev)
            ranks.append(cols)
        stages.append({
            "lead": {name: put(w[lo:hi], lead) for name, w in layers.items()
                     if name not in TP_COLUMNS},
            "ranks": ranks})
    return {"embed": put(params["embed"], home),
            "norm_f": put(params["norm_f"], home),
            "out": put(params["out"], home),
            "stages": stages}


# ---------------------------------------------------------------------------
# training meshes (dp, sp, tp, ep, pp)
# ---------------------------------------------------------------------------

def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, sp: int = 1, ep: int = 1, pp: int = 1,
              devices=None) -> Mesh:
    """A ``(dp, sp, tp, ep, pp)`` mesh over the first ``n_devices``
    devices — the reference's factorization: pp = ep = sp = 1 unless
    given, tp the largest of 1, 2, 4 that divides what is left, dp the
    rest. ``devices=None`` takes every CUDA device of the host; an
    explicit list may repeat a device (a 2×2 mesh on one card)."""
    devs = list(devices if devices is not None else
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())])
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    if n % (sp * ep * pp):
        raise ValueError(
            f"n={n} devices not divisible by sp*ep*pp={sp}*{ep}*{pp}")
    if tp is None:
        tp = max(d for d in (1, 2, 4) if n % (d * sp * ep * pp) == 0)
    if dp is None:
        dp = n // (tp * sp * ep * pp)
    if dp * tp * sp * ep * pp != n:
        raise ValueError(f"dp*sp*tp*ep*pp = {dp}*{sp}*{tp}*{ep}*{pp} != {n} "
                         "devices")
    flat = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        flat[i] = torch.device(d)
    return Mesh(flat.reshape(dp, sp, tp, ep, pp), AXES)


def param_specs() -> dict:
    """Per leaf of ``init_params``' dict, the mesh axis that splits each
    dimension (None: whole) — the reference's megatron layout: column
    projections split their output columns over tp, ``wo`` / ``w2``
    their input rows, ``embed`` and ``out`` their second axis; the
    stacked-layer axis stays whole (``pipeline.pp_param_specs`` splits
    it over pp)."""
    return {
        "embed": (None, "tp"),
        "layers": {
            "wq": (None, None, "tp"),
            "wk": (None, None, "tp"),
            "wv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "w1": (None, None, "tp"),
            "w3": (None, None, "tp"),
            "w2": (None, "tp", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "norm_f": (None,),
        "out": (None, "tp"),
    }


def moe_param_specs() -> dict:
    """``init_moe_params``' layout: attention as the dense model's, the
    experts over ep (their ff dim over tp), the router whole."""
    specs = param_specs()
    specs["layers"] = {
        **{k: v for k, v in specs["layers"].items()
           if k not in ("w1", "w2", "w3")},
        "router": (None, None, None),
        "w1": (None, "ep", None, "tp"),
        "w3": (None, "ep", None, "tp"),
        "w2": (None, "ep", "tp", None),
    }
    return specs


def data_spec() -> tuple:
    """Tokens (B, S): batch over dp, sequence over sp."""
    return ("dp", "sp")


def _shard_index(mesh: Mesh, spec: tuple, shape: tuple,
                 coord: tuple) -> tuple:
    """The block of a ``shape`` array that grid coordinate ``coord``
    holds under ``spec``."""
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        k, n = mesh.shape[axis], shape[dim]
        if n % k:
            raise ValueError(f"dimension {dim} of size {n} does not split "
                             f"over {axis}={k}")
        r = coord[mesh.axis_names.index(axis)]
        idx.append(slice(r * (n // k), (r + 1) * (n // k)))
    return tuple(idx)


class Sharded:
    """One array laid out on a mesh: ``spec`` names, per dimension, the
    axis that splits it, and ``shards`` maps every grid coordinate (in
    ``mesh.coords()`` order) to that coordinate's block, a tensor of its
    own on the coordinate's device. Coordinates that differ only along
    axes the spec does not split are replicas of one block."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple,
                 shards: dict) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def at(self, **coords: int) -> torch.Tensor:
        """The block at the given axis coordinates (absent axes 0)."""
        return self.shards[tuple(coords.get(a, 0)
                                 for a in self.mesh.axis_names)]

    def index(self, coord: tuple) -> tuple:
        return _shard_index(self.mesh, self.spec, self.shape, coord)

    def groups(self) -> list[list[tuple]]:
        """The replica groups: the coordinates holding each block, in
        rank order, blocks in rank order (every process's coordinates
        on a mesh over several)."""
        split = [i for i, a in enumerate(self.mesh.axis_names)
                 if a in self.spec]
        keyed: dict[tuple, list] = {}
        for c in (self.mesh.coords() if self.mesh.multiprocess
                  else self.shards):
            keyed.setdefault(tuple(c[i] for i in split), []).append(c)
        return list(keyed.values())

    def full(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default this process's first
        grid device), from the first replica of every block. On a mesh
        over several processes each block comes from the process that
        owns its first replica, so every process must call it, in the
        same order."""
        dev = torch.device(device) if device is not None else \
            self.mesh.first_device()
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        groups = self.groups()
        if self.mesh.multiprocess:
            blocks = exchange({i: self.shards[g[0]]
                               for i, g in enumerate(groups)
                               if self.mesh.is_local(g[0])}, device=dev)
            for i, group in enumerate(groups):
                out[self.index(group[0])] = blocks[i].to(dev)
            return out
        for group in groups:
            out[self.index(group[0])] = self.shards[group[0]].to(dev)
        return out

    def map(self, fn, *rest: "Sharded") -> "Sharded":
        """``fn`` over every block (and the same block of ``rest``)."""
        return Sharded(self.mesh, self.spec, self.shape,
                       {c: fn(t, *(r.shards[c] for r in rest))
                        for c, t in self.shards.items()})

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh.shape})")


def shard_tensor(t, spec: tuple, mesh: Mesh) -> Sharded:
    """``t`` (a tensor, or a :class:`Sharded` on any mesh) split per
    ``spec`` onto ``mesh``: every coordinate gets a contiguous copy of
    its block on its device."""
    if isinstance(t, Sharded):
        t = t.full()
    shards = {}
    for c in mesh.coords():
        if not mesh.is_local(c):
            continue
        part = t[_shard_index(mesh, spec, tuple(t.shape), c)]
        shards[c] = torch.empty(part.shape, dtype=t.dtype,
                                device=mesh.devices[c]).copy_(part)
    return Sharded(mesh, spec, tuple(t.shape), shards)


def _codec_specs(params, specs):
    """``specs`` expanded to int8 codec leaves (``{q, s}``): ``q`` keeps
    the dense weight's spec; ``s`` (per output channel, in-dim of size 1)
    keeps only a split of the last axis, and a per-row scale (``s`` of
    width 1, the embedding's) none — the reference's
    ``_codec_shardings``."""
    if isinstance(params, dict) and not isinstance(specs, dict):
        s = params["s"]
        sspec = (None,) * (len(specs) - 1) + (specs[-1],)
        if s.shape[-1] == 1:
            sspec = (None,) * s.dim()
        return {"q": specs, "s": sspec}
    if isinstance(params, dict):
        return {k: _codec_specs(v, specs[k]) for k, v in params.items()}
    return specs


def place_tree(tree, specs, mesh: Mesh):
    """Every tensor of ``tree`` split per the same-shaped ``specs`` tree
    (int8 codec leaves expanded as :func:`_codec_specs` says)."""
    specs = _codec_specs(tree, specs)

    def rec(node, spec):
        if isinstance(node, dict):
            return {k: rec(v, spec[k]) for k, v in node.items()}
        return shard_tensor(node, spec, mesh)
    return rec(tree, specs)


def place_params(params: dict, mesh: Mesh) -> dict:
    """The parameter dict on ``mesh`` as :func:`param_specs` says, int8
    ``{q, s}`` leaves included (scales follow their output channels)."""
    return place_tree(params, param_specs(), mesh)


def place_data(tokens: torch.Tensor, mesh: Mesh) -> Sharded:
    """Tokens (B, S) on ``mesh``: batch over dp, sequence over sp."""
    return shard_tensor(tokens, data_spec(), mesh)


def rank_rows(data, d: int, rows: slice | None = None) -> torch.Tensor:
    """Dp rank ``d``'s rows of a batch: ``data[rows]`` of a whole
    tensor, or of a :class:`Sharded` one the rank's sp blocks side by
    side on the first one's device (any process owning one of them has
    them all)."""
    if not isinstance(data, Sharded):
        return data[rows]
    mesh = data.mesh
    k_dp, k_sp = mesh.axis_names.index("dp"), mesh.axis_names.index("sp")
    blocks = {}
    for c, t in data.shards.items():
        if c[k_dp] == d:
            blocks.setdefault(c[k_sp], t)
    first = blocks[min(blocks)].device
    return torch.cat([blocks[s].to(first) for s in sorted(blocks)], dim=1)


def assert_divisible(cfg, mesh: Mesh) -> None:
    """Fail fast when the model does not tile onto the mesh — the
    reference's checks and words."""
    tp = mesh.shape["tp"]
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by tp {tp}")
    kv_heads = getattr(cfg, "kv_heads", cfg.n_heads)
    if kv_heads % tp:
        raise ValueError(f"n_kv_heads {kv_heads} not divisible by tp {tp}"
                         " (wk/wv are column-sharded per KV head)")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tp {tp}")
    ep = mesh.shape.get("ep", 1)
    n_experts = getattr(cfg, "n_experts", 1)
    if ep > 1 and n_experts % ep:
        raise ValueError(f"n_experts {n_experts} not divisible by ep {ep}")


# ---------------------------------------------------------------------------
# the step's collectives: fixed order, fp32 sums
# ---------------------------------------------------------------------------

def fp32_sum(parts, device) -> torch.Tensor:
    """The fp32 sum of ``parts`` in their order, on ``device``."""
    acc = parts[0].to(device=device, dtype=torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device=device, dtype=torch.float32)
    return acc


class Reduce(torch.autograd.Function):
    """``Reduce.apply(device, dtype, *parts)``: the per-rank partials
    summed in rank order in fp32 on ``device``, cast to ``dtype`` — the
    reference's ``psum`` over tp. The backward copies the gradient to
    every rank."""

    @staticmethod
    def forward(ctx, device, dtype, *parts):
        ctx.meta = [(p.device, p.dtype) for p in parts]
        return fp32_sum(parts, device).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g.to(device=d, dtype=dt, copy=True)
                              for d, dt in ctx.meta))


class Broadcast(torch.autograd.Function):
    """``Broadcast.apply(x, *devices)``: a copy of ``x`` on every device,
    one per rank. The backward sums the ranks' gradients in rank order in
    fp32 and casts to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.src = (x.device, x.dtype)
        ctx.n = len(devices)
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        dev, dtype = ctx.src
        return (fp32_sum(grads, dev).to(dtype), *([None] * ctx.n))


def all_reduce(parts: list) -> list:
    """The rank-order fp32 sum of ``parts``, one copy on each part's
    device (Reduce to rank 0, then Broadcast); one part passes
    through."""
    if len(parts) == 1:
        return list(parts)
    total = Reduce.apply(parts[0].device, parts[0].dtype, *parts)
    return list(Broadcast.apply(total, *(p.device for p in parts)))


def all_gather(parts: list, dim: int) -> list:
    """``parts`` concatenated along ``dim`` in rank order, one copy on
    each part's device; the backward sums the copies' gradients in rank
    order (fp32) before slicing each rank's block back."""
    if len(parts) == 1:
        return list(parts)
    home = parts[0].device
    whole = torch.cat([p.to(home) for p in parts], dim=dim)
    return list(Broadcast.apply(whole, *(p.device for p in parts)))


# ---------------------------------------------------------------------------
# the cross-process half: exact gathers over torch.distributed (gloo)
# ---------------------------------------------------------------------------

# the bytes a gather moves out of one process at a time: a larger
# gradient goes in several rounds (with exchange's ``device``, one
# round's host buffers are alive at a time)
BUCKET_BYTES = 64 * 2 ** 20

# what this process's gathers moved (calls, bytes sent, bytes received)
# and the host seconds they took, staging included
EXCHANGED = {"calls": 0, "sent_bytes": 0, "received_bytes": 0,
             "seconds": 0.0}


def reset_exchanged() -> None:
    for k in EXCHANGED:
        EXCHANGED[k] = 0


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


def _aligned(n: int) -> int:
    """Byte offsets of the staged items stay 8-aligned, so every item's
    bytes view back as its dtype in place."""
    return (n + 7) // 8 * 8


def exchange(items: dict, device=None) -> dict:
    """Every process's ``items`` (``{key: tensor}``, keys picklable and
    unique across processes), on every process: a collective — every
    process of the default group calls it, in the same order. Each
    process's tensors travel as raw bytes, copied straight into a host
    staging buffer (page-locked when they live on a card), in rounds of
    ``gloo`` ``all_gather``s of at most :data:`BUCKET_BYTES` from each
    process, so a value arrives bit for bit. Own items come back as
    given; the others as views of the received host buffers, or, with
    ``device``, copied there at the end of their round, so the round's
    buffers are freed before the next (on the CPU the views stay)."""
    import time

    import torch.distributed as dist
    t0 = time.perf_counter()
    world = dist.get_world_size()
    meta = [(k, tuple(t.shape), str(t.dtype),
             _aligned(t.numel() * t.element_size()))
            for k, t in items.items()]
    metas: list = [None] * world
    dist.all_gather_object(metas, meta)
    # each process's items cut into rounds of at most BUCKET_BYTES, in
    # order (an item larger than a bucket is a round of its own)
    rounds = []
    for m in metas:
        cut, size = [[]], 0
        for entry in m:
            if cut[-1] and size + entry[3] > BUCKET_BYTES:
                cut.append([])
                size = 0
            cut[-1].append(entry)
            size += entry[3]
        rounds.append(cut)
    me = dist.get_rank()
    pin = any(t.is_cuda for t in items.values())
    out = dict(items)
    EXCHANGED["calls"] += 1
    for r in range(max(len(c) for c in rounds)):
        parts = [c[r] if r < len(c) else [] for c in rounds]
        sizes = [sum(e[3] for e in p) for p in parts]
        width = max(sizes)
        if width == 0:
            continue
        mine = torch.empty(width, dtype=torch.uint8, pin_memory=pin)
        at = 0
        for key, _, _, n in parts[me]:
            flat = items[key].detach().reshape(-1).view(torch.uint8)
            mine[at:at + flat.numel()].copy_(flat)
            at += n
        bufs = [torch.empty(width, dtype=torch.uint8, pin_memory=pin)
                for _ in range(world)]
        dist.all_gather(bufs, mine)
        EXCHANGED["sent_bytes"] += sizes[me]
        for p, (part, buf) in enumerate(zip(parts, bufs)):
            if p == me:
                continue
            EXCHANGED["received_bytes"] += sizes[p]
            at = 0
            for key, shape, dtype, n in part:
                dt = _dtype(dtype)
                count = math.prod(shape) * torch.empty((), dtype=dt
                                                       ).element_size()
                out[key] = buf[at:at + count].view(dt).reshape(shape)
                if device is not None:
                    out[key] = out[key].to(device)
                at += n
        del mine, bufs
    EXCHANGED["seconds"] += time.perf_counter() - t0
    return out


# sends of the backward still in flight: (work, host buffer) pairs
_PENDING: list = []


def _send(x: torch.Tensor, peer: int, tag: int, wait: bool) -> None:
    import torch.distributed as dist
    buf = x.detach().contiguous().cpu()
    if wait:
        dist.send(buf, peer, tag=tag)
    else:
        _PENDING.append((dist.isend(buf, peer, tag=tag), buf))


def _recv(shape, dtype, device, peer: int, tag: int) -> torch.Tensor:
    import torch.distributed as dist
    buf = torch.empty(shape, dtype=dtype)
    dist.recv(buf, peer, tag=tag)
    return buf.to(device)


def wait_sends() -> None:
    """Wait for every send a backward started (:class:`RecvStage`)."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


class SendStage(torch.autograd.Function):
    """``SendStage.apply(peer, tag, *xs)``: a pipeline stage's outputs
    handed to the next stage on process ``peer`` (tags ``tag + i``), in
    order, through host memory. Returns a 0-d zero that the caller adds
    to its loss so the backward reaches this node, which receives the
    outputs' gradients from the peer."""

    @staticmethod
    def forward(ctx, peer, tag, *xs):
        ctx.peer, ctx.tag = peer, tag
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        for i, x in enumerate(xs):
            _send(x, peer, tag + i, wait=True)
        return torch.zeros((), dtype=torch.float32, device=xs[0].device)

    @staticmethod
    def backward(ctx, _):
        return (None, None, *(_recv(shape, dtype, dev, ctx.peer, ctx.tag + i)
                              for i, (shape, dtype, dev)
                              in enumerate(ctx.meta)))


class RecvStage(torch.autograd.Function):
    """``RecvStage.apply(anchor, peer, tag, metas)``: the previous
    stage's outputs from process ``peer``, one tensor per ``(shape,
    dtype, device)`` of ``metas``. ``anchor`` is any autograd leaf of
    the caller's backward (the backward only visits nodes that lead to
    a leaf it was asked for); its gradient is None. The backward starts
    the sends of the outputs' gradients to the peer without waiting
    (:func:`wait_sends`), so the two processes' autograd engines may
    visit the stage boundaries in any order."""

    @staticmethod
    def forward(ctx, anchor, peer, tag, metas):
        ctx.peer, ctx.tag = peer, tag
        return tuple(_recv(shape, dtype, dev, peer, tag + i)
                     for i, (shape, dtype, dev) in enumerate(metas))

    @staticmethod
    def backward(ctx, *grads):
        for i, g in enumerate(grads):
            _send(g, ctx.peer, ctx.tag + i, wait=False)
        return None, None, None, None


def gather_replica_grads(leaves: list, grads: list) -> list:
    """``grads`` (``grads[i]`` the present gradients of ``leaves[i]``,
    by coordinate) with the gradients of every replica group that spans
    processes added: gathered exactly, one :func:`exchange` for all
    leaves, so :func:`sum_replica_grads` can sum each group in the
    one-process order. On one process ``grads`` as they are."""
    if not leaves or not leaves[0].mesh.multiprocess:
        return grads
    mesh = leaves[0].mesh
    send = {}
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        for group in leaf.groups():
            if len({mesh.process_of(c) for c in group}) > 1:
                send.update({(i, c): g[c] for c in group
                             if mesh.is_local(c) and g.get(c) is not None})
    got = exchange(send, device=mesh.first_device())
    out = [dict(g) for g in grads]
    for (i, c), t in got.items():
        out[i][c] = t
    return out


def sum_replica_grads(leaf: Sharded, grads: dict) -> dict:
    """The gradient of every block of ``leaf``: its replicas' gradients
    (``grads[coord]``, None or absent where a replica took no part, or
    lives on another process and was not gathered —
    :func:`gather_replica_grads`) summed in rank order in fp32 — the
    reference's dp / tp / sp all-reduce of a replicated leaf — and a
    copy of the sum on every local replica's device, so every replica
    takes the same update."""
    out = {}
    for group in leaf.groups():
        local = [c for c in group if c in leaf.shards]
        if not local:
            continue
        present = [grads[c] for c in group if grads.get(c) is not None]
        first = leaf.shards[local[0]]
        if not present:
            total = torch.zeros_like(first)
        elif len(present) == 1:
            total = present[0]
        else:
            total = fp32_sum(present, first.device).to(first.dtype)
        for c in local:
            dev = leaf.shards[c].device
            out[c] = total if total.device == dev and c == local[0] \
                else total.to(dev, copy=True)
    return {c: out[c] for c in leaf.shards}
