"""Serving meshes — the serving half of ``tpushare/workloads/parallel/
mesh.py`` (``make_serving_mesh``, ``serving_degrees``,
``check_serving_mesh``, ``place_serving_params``).

The reference's sharded engine is one controller over a device grid:
XLA runs each shard's program on its chip and inserts the collectives.
The port keeps the one controller: :class:`Mesh` names the axes of an
explicit grid of ``torch.device``s, every shard's tensors live on their
grid device, and the collectives are explicit copies and ``torch.cat``s
in rank order (``workloads/sharded_pool.py``). No process group is
involved. A grid may name one device several times — how a 2×2 mesh
runs on one card or on the CPU; NCCL, which refuses two ranks on one
GPU, is not needed.

The layout is the reference's exactness-preserving one
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

import numpy as np
import torch

from tpushare_torch import consts

# the column projections a serving mesh splits over tp; every other
# layer leaf stays whole
TP_COLUMNS = ("wq", "wk", "wv", "w1", "w3")


class Mesh:
    """Named axes over an explicit grid of ``torch.device``s:
    ``Mesh(grid, ("tp", "pp"))`` with ``grid[r][s]`` the device of tp
    rank r in pipeline stage s (``("dp", "tp")`` for a slot engine's
    ragged read). ``shape`` maps each axis to its size, as a JAX mesh's
    does."""

    def __init__(self, devices, axis_names: tuple[str, ...]) -> None:
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (absent axes 0)."""
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
