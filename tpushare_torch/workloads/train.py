"""Training step of the port: AdamW over the transformer, on one device
or over a mesh — the counterpart of ``tpushare/workloads/train.py``.

The reference jits loss, backward and the optax update into one
donating program over a mesh. Here the step runs eagerly: autograd
through the loss (on the card the attention backward is the dQ and
dK/dV kernels), then :class:`AdamW` updates the parameters and moments
**in place** (the counterpart of donation: one copy of params +
optimizer state per device).

Over a mesh (``parallel/mesh.make_mesh``; the state placed by
:func:`place_state`) the step runs the sharded forward of
``parallel/pipeline.group_loss`` for each dp rank's batch shard —
megatron tp with fp32 rank-order partial sums, a vocab-split cross
entropy, ring attention over sp (``ring_attention=True``: the zigzag
reorder of inputs, targets and RoPE positions once a step, or the
banded ring in the natural order under a window), the kernels once per
(dp, tp) shard otherwise (B.10 / B.8, ``ops/attention.
make_mesh_attention``) — takes each dp rank's gradients with autograd,
sums every replicated leaf's gradient over its replicas in rank order
in fp32 (the dp all-reduce, and the tp / sp ones of the norms), and
updates every shard in place: replicas stay bitwise equal.

Over a mesh that spans processes (``multihost.make_multihost_mesh``)
each process runs its own dp ranks on its own blocks — its rows of the
global batch, or its blocks from ``multihost.shard_host_batch`` — and
every sum that crosses processes (replica gradients, the dp losses,
the clip norm's terms) gathers its operands exactly and sums them in
the one-process order: the step gives the one-process step's bits.

:class:`AdamW` is optax's ``adamw`` (optionally chained after
``clip_by_global_norm``, with the warmup + cosine schedule), written out
on a dict of tensors op for op: moments kept in the params' dtype
(optax's ``mu_dtype=None``), the bias correction computed in fp32 and
cast, decoupled weight decay ``p - lr * (adam + wd * p)``, and clipping
as ``g * max / ||g||`` only when ``||g|| >= max``. Python scalars are
rounded to the tensor's dtype first, as JAX does with weak-typed
scalars. ``torch.optim.AdamW`` differs in each of those places
(fused bias correction, ``clip_grad_norm_``'s ``||g|| + 1e-6``, its own
step counting), so the port keeps this form and the tests hold it to
optax.

:func:`make_moe_train_step` is the same step over the MoE model
(``models/moe.moe_loss_fn``: cross entropy plus ``router_aux_coef`` x
the load-balancing term), on one device or over a (dp, tp, ep) mesh:
the experts split over ep (``models/moe.moe_ffn``'s ep form).

Step spans (``tracing.step_span``, off by default): each one-device
step of :func:`make_train_step` is one trace, ``train.step``, with a
``train.loss_and_grads`` span a microbatch and one
``train.optimizer_update``, both device-timed on a CUDA device.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Sequence

import torch

from tpushare_torch import tracing
from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         loss_fn)
from tpushare_torch.workloads.parallel.mesh import (Mesh, Sharded,
                                                    assert_divisible,
                                                    exchange, fp32_sum,
                                                    gather_replica_grads,
                                                    moe_param_specs,
                                                    param_specs, place_tree,
                                                    rank_rows, shard_tensor,
                                                    sum_replica_grads,
                                                    wait_sends)

B1, B2, EPS = 0.9, 0.95, 1e-8


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order; a
    :class:`Sharded` leaf gives its blocks in grid order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, Sharded):
        yield from tree.shards.values()
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more nested dicts of one
    structure (over every block of a :class:`Sharded` leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.map(fn, *rest)
    return fn(tree, *rest)


def _norm_terms(tree) -> Iterator[torch.Tensor]:
    """Every tensor of the tree once: one replica of each
    :class:`Sharded` block."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _norm_terms(v)
    elif isinstance(tree, Sharded):
        for group in tree.groups():
            yield tree.shards[group[0]]
    else:
        yield tree


def _global_norm(tree) -> torch.Tensor:
    """The global norm of a gradient tree, every logical block counted
    once (:func:`_norm_terms`), the terms summed in tree order on the
    first term's device. Over several processes, the process owning a
    block's first replica computes its term and the terms are gathered,
    so every process sums the same terms in the one-process order."""
    meshes = [t.mesh for t in sharded_leaves(tree)]
    if not meshes or not meshes[0].multiprocess:
        terms = list(_norm_terms(tree))
        dev = terms[0].device
        return torch.sqrt(sum(torch.sum(g * g).to(dev) for g in terms))
    mesh = meshes[0]
    keys, mine = [], {}
    for i, leaf in enumerate(sharded_leaves(tree)):
        for j, group in enumerate(leaf.groups()):
            keys.append((i, j))
            if mesh.is_local(group[0]):
                g = leaf.shards[group[0]]
                mine[(i, j)] = torch.sum(g * g)
    terms = exchange(mine)
    dev = mesh.first_device()
    return torch.sqrt(sum(terms[k].to(dev) for k in keys))


def sharded_leaves(tree) -> Iterator[Sharded]:
    """The :class:`Sharded` leaves of a nested dict, in tree order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from sharded_leaves(v)
    elif isinstance(tree, Sharded):
        yield tree


def _rounded(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX rounds a weak-typed
    scalar before it meets a tensor of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def warmup_cosine(init: float, peak: float, warmup_steps: int,
                  decay_steps: int, end: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps, end_value=end)`` as a function of the update count."""
    alpha = 0.0 if peak == 0.0 else end / peak
    cos_steps = decay_steps - warmup_steps

    def lr_at(count: int) -> float:
        if count < warmup_steps:
            return (init - peak) * (1 - count / warmup_steps) + peak
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak * ((1 - alpha) * cosine + alpha)
    return lr_at


class AdamW:
    """optax ``adamw(lr, b1=0.9, b2=0.95, weight_decay)``, optionally after
    ``clip_by_global_norm(clip_norm)``, over a nested dict of tensors.

    ``init(params)`` gives the state ``{"mu", "nu", "count"}`` (the
    moments mirror the params' tree and dtype; ``count`` is the number
    of updates applied, optax's adam and schedule count alike).
    ``update(grads, state, params)`` applies one step in place."""

    def __init__(self, lr: float | Callable[[int], float] = 3e-4,
                 weight_decay: float = 0.01,
                 clip_norm: float | None = None) -> None:
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def init(self, params: dict) -> dict:
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params), "count": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        gs = list(tree_leaves(grads))
        if self.clip_norm is not None:
            # the global norm of the logical gradient: a replicated
            # block counts once, every term summed on one device
            norm = _global_norm(grads)
            keep = norm < self.clip_norm
            gs = [torch.where(keep.to(g.device), g,
                              (g / norm.to(g.device, g.dtype))
                              * _rounded(self.clip_norm, g.dtype))
                  for g in gs]
        lr = self.lr_at(state["count"])
        count = state["count"] + 1
        # 1 - b**count in fp32, then cast to the moment's dtype (optax)
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** count)
        for p, g, mu, nu in zip(tree_leaves(params), gs,
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            dt = mu.dtype

            def r(x, dt=dt):
                return _rounded(x, dt)
            mu.copy_(r(1 - B1) * g + r(B1) * mu)
            nu.copy_(r(1 - B2) * (g * g) + r(B2) * nu)
            u = (mu / r(bc1)) / (torch.sqrt(nu / r(bc2)) + r(EPS))
            u = u + r(self.weight_decay, p.dtype) * p
            p.add_(r(-lr, u.dtype) * u)
        state["count"] = count


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   clip_norm: float | None = None, warmup_steps: int = 0,
                   decay_steps: int | None = None,
                   end_lr_ratio: float = 0.1) -> AdamW:
    """AdamW, optionally with global-norm gradient clipping and a warmup +
    cosine-decay schedule — the reference's ``make_optimizer``: lr ramps
    0 -> lr over ``warmup_steps``, then decays to ``lr * end_lr_ratio``
    at ``decay_steps``; with warmup but no decay horizon the decay
    stretches to 10x the warmup; decay without warmup starts at peak
    lr."""
    schedule: float | Callable[[int], float] = lr
    if warmup_steps or decay_steps:
        if decay_steps is not None and decay_steps <= warmup_steps:
            raise ValueError(f"decay_steps {decay_steps} must exceed "
                             f"warmup_steps {warmup_steps}")
        total = decay_steps if decay_steps is not None else warmup_steps * 10
        init = 0.0 if warmup_steps else lr
        schedule = warmup_cosine(init, lr, max(warmup_steps, 1),
                                 max(total, warmup_steps + 1),
                                 end=lr * end_lr_ratio)
    return AdamW(schedule, weight_decay=weight_decay, clip_norm=clip_norm)


def init_state(params: dict, optimizer: AdamW) -> dict:
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def _one_device(device) -> torch.device:
    """The step's device: a device or a one-device list (a mesh is
    passed as a :class:`Mesh`)."""
    if isinstance(device, Sequence) and not isinstance(device, str):
        if len(device) != 1:
            raise ValueError(
                f"a list of {len(device)} devices: train over them through "
                "a mesh (parallel.mesh.make_mesh) and place_state")
        device = device[0]
    return resolve_device(device)


# ---------------------------------------------------------------------------
# the state over a mesh
# ---------------------------------------------------------------------------

def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _opt_shardings(opt_state, params: dict, shard_tree: dict | None = None):
    """The spec tree of an optimizer state, derived structurally: a
    subtree shaped exactly like the params (AdamW's mu and nu) takes the
    params' specs; every other leaf (the count) is replicated (None).
    Shape-based matching would be wrong: wq and wo share a shape but not
    a spec."""
    specs = shard_tree if shard_tree is not None else param_specs()
    want = _structure(params)

    def rec(node):
        if isinstance(node, dict) and _structure(node) == want:
            return specs
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return None
    return rec(opt_state)


def place_state(state: dict, mesh: Mesh, shard_tree: dict | None = None
                ) -> dict:
    """The train state on ``mesh``: params split per ``shard_tree``
    (default ``param_specs``; MoE and pipeline rules pass theirs), the
    moments mirroring them, the count and step as they are. Values are
    kept, so this also places a restored checkpoint — or a state placed
    on another mesh."""
    specs = shard_tree if shard_tree is not None else param_specs()

    def put(node, spec):
        if isinstance(node, dict):
            return {k: put(v, spec[k] if isinstance(spec, dict) else None)
                    for k, v in node.items()}
        if isinstance(node, (torch.Tensor, Sharded)):
            if spec is None:
                spec = (None,) * len(node.shape)
            return shard_tensor(node, spec, mesh)
        return node
    return {"params": place_tree(state["params"], specs, mesh),
            "opt": put(state["opt"],
                       _opt_shardings(state["opt"], state["params"], specs)),
            "step": int(state["step"])}


def place_moe_state(state: dict, mesh: Mesh) -> dict:
    """:func:`place_state` with the MoE rules (experts over ep, their ff
    dim over tp, the router whole)."""
    return place_state(state, mesh, shard_tree=moe_param_specs())


def gather_state(state: dict) -> dict:
    """A placed state as whole tensors (the first replica of every
    block, on the mesh's first device)."""
    return {"params": tree_map_whole(state["params"]),
            "opt": tree_map_whole(state["opt"]), "step": int(state["step"])}


def tree_map_whole(tree):
    if isinstance(tree, dict):
        return {k: tree_map_whole(v) for k, v in tree.items()}
    return tree.full() if isinstance(tree, Sharded) else tree


def _dp_view(params: dict, d: int | None, flat: list) -> dict:
    """``params`` with dp rank ``d``'s blocks (every block for None)
    swapped for detached autograd leaves sharing their storage; ``flat``
    collects (leaf, coord, tensor)."""
    if isinstance(params, dict):
        return {k: _dp_view(v, d, flat) for k, v in params.items()}
    shards = dict(params.shards)
    for c, t in params.shards.items():
        if d is None or c[0] == d:
            shards[c] = t.detach().requires_grad_()
            flat.append((params, c, shards[c]))
    return Sharded(params.mesh, params.spec, params.shape, shards)


def _rebuild(tree, grads: dict):
    """The gradient tree of ``tree``'s placed leaves from their
    replicas' gradients (``grads[id(leaf)][coord]``): every replica
    group summed (:func:`mesh.sum_replica_grads`), the groups that span
    processes gathered first, in one call for every leaf."""
    leaves = list(sharded_leaves(tree))
    per = gather_replica_grads(
        leaves, [grads.get(id(leaf), {}) for leaf in leaves])
    sums = iter([sum_replica_grads(leaf, g) for leaf, g in zip(leaves, per)])

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return Sharded(node.mesh, node.spec, node.shape, next(sums))
    return rec(tree)


def mesh_loss_and_grads(params: dict, inputs: torch.Tensor,
                        targets: torch.Tensor, mesh: Mesh, group_loss,
                        accum_steps: int = 1, joint=None, reorder=None
                        ) -> tuple[torch.Tensor, dict]:
    """(loss, grads) over a placed state: for each of ``accum_steps``
    equal microbatches and each of this process's dp ranks' equal batch
    shard of it, ``group_loss(view, d, inputs, targets)`` and its
    gradients (one autograd pass per dp rank, so one rank's activations
    live at a time); fp32 accumulators over microbatches; then every
    block's gradient summed over its replicas in rank order
    (:func:`_rebuild`). The loss is the rank-order mean of every dp
    rank's loss, the other processes' gathered. ``joint(view, {dp rank:
    (inputs, targets)})`` instead takes this process's dp ranks' losses
    at once, in one autograd pass (the MoE step's global aux).
    ``reorder`` is applied to each rank's rows (the zigzag).

    On a mesh over several processes each process runs its own dp ranks
    (``mesh.local_ranks``), on its rows of the global batch or on its
    blocks of a ``shard_host_batch``."""
    if not mesh.multiprocess:
        inputs, targets = (x.full() if isinstance(x, Sharded) else x
                           for x in (inputs, targets))
    dp = mesh.shape["dp"]
    B = inputs.shape[0]
    if B % (accum_steps * dp):
        raise ValueError(f"batch {B} not divisible by accum_steps*dp "
                         f"{accum_steps}*{dp}")
    if accum_steps > 1 and isinstance(inputs, Sharded):
        raise ValueError("accum_steps > 1 over several processes takes "
                         "the global batch, not shard_host_batch's blocks")
    local_dp = mesh.local_ranks("dp")
    mb = B // accum_steps
    bs = mb // dp

    def rows(x, a, d):
        r = rank_rows(x, d, slice(a * mb + d * bs, a * mb + (d + 1) * bs))
        return reorder(r) if reorder is not None else r

    acc: dict[int, dict] = {}
    losses = []
    for a in range(accum_steps):
        dl = {}
        for d in ([None] if joint else local_dp):
            flat: list = []
            view = _dp_view(params, d, flat)
            with torch.enable_grad():
                if joint:
                    loss = joint(view, {r: (rows(inputs, a, r),
                                            rows(targets, a, r))
                                        for r in local_dp})
                else:
                    loss = group_loss(view, d, rows(inputs, a, d),
                                      rows(targets, a, d))
            gs = torch.autograd.grad(loss / dp if dp > 1 and not joint
                                     else loss,
                                     [t for _, _, t in flat],
                                     allow_unused=True)
            wait_sends()
            for (leaf, c, _), g in zip(flat, gs):
                if g is None:
                    continue
                per = acc.setdefault(id(leaf), {})
                if accum_steps == 1:
                    per[c] = g
                else:
                    per[c] = per[c] + g.float() if c in per else g.float()
            dl[d] = loss.detach()
            del view, flat, gs, loss
        if joint:
            losses.append(dl[None])
            continue
        if len(local_dp) < dp:
            dev = dl[local_dp[0]].device
            dl = {d: t.to(dev) for d, t in exchange(dl).items()}
        ranked = [dl[d] for d in range(dp)]
        losses.append(ranked[0] if dp == 1
                      else fp32_sum(ranked, ranked[0].device) / dp)
    loss = losses[0]
    if accum_steps > 1:
        loss = fp32_sum(losses, loss.device) / accum_steps
        for lid, per in acc.items():
            for c, g in per.items():
                per[c] = g / accum_steps
    grads = _rebuild(params, acc)
    if accum_steps > 1:
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
    return loss, grads


def loss_and_grads(params: dict, inputs: torch.Tensor,
                   targets: torch.Tensor, cfg: TransformerConfig,
                   loss_of=loss_fn) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_of`` (default :func:`loss_fn`): detached
    leaves that share the params' storage stand in as the autograd
    leaves."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_of(leaves, inputs, targets, cfg)
    flat = list(tree_leaves(leaves))
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def make_train_step(cfg: TransformerConfig, optimizer: AdamW,
                    device="cuda", ring_attention: bool = False,
                    accum_steps: int = 1):
    """Returns ``step(state, inputs, targets) -> (state, loss)``, which
    updates ``state`` in place and returns it with the step's mean loss
    (a 0-d fp32 tensor on the device). ``accum_steps > 1`` runs that many
    microbatches with fp32 gradient accumulators before the one update.

    ``device`` is the card by default, any device, or a one-device list;
    a :class:`Mesh` trains over it (the state from :func:`place_state`),
    the module docstring says how. ``ring_attention=True`` swaps the
    attention for the ring over the mesh's sp axis (sp > 1): the token
    stream is zigzag-reordered once a step (inputs, targets and RoPE
    positions together; the mean cross entropy does not care), or, with
    a window, the banded ring keeps the natural order."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if isinstance(device, Mesh):
        return _mesh_step(cfg, optimizer, device, ring_attention,
                          accum_steps)
    if ring_attention:
        raise ValueError("ring_attention needs an sp axis > 1")
    dev = _one_device(device)

    def body(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        with tracing.step_span("train.step", root=True):
            params = state["params"]
            inputs, targets = inputs.to(dev), targets.to(dev)
            if accum_steps == 1:
                with tracing.step_span("train.loss_and_grads", device=dev):
                    loss, grads = loss_and_grads(params, inputs, targets,
                                                 cfg)
            else:
                # fp32 accumulators over equal microbatches: the mean of
                # the means is the full-batch mean, in 1/accum the
                # activations
                B = inputs.shape[0]
                if B % accum_steps:
                    raise ValueError(f"batch {B} not divisible by "
                                     f"accum_steps {accum_steps}")
                mb = B // accum_steps
                gsum = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                lsum = torch.zeros((), dtype=torch.float32, device=dev)
                for a in range(accum_steps):
                    rows = slice(a * mb, (a + 1) * mb)
                    with tracing.step_span("train.loss_and_grads",
                                           device=dev):
                        loss, grads = loss_and_grads(params, inputs[rows],
                                                     targets[rows], cfg)
                    for acc, g in zip(tree_leaves(gsum),
                                      tree_leaves(grads)):
                        acc.add_(g.float())
                    lsum = lsum + loss
                    del grads
                grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype),
                                 gsum, params)
                loss = lsum / accum_steps
            with tracing.step_span("train.optimizer_update", device=dev):
                optimizer.update(grads, state["opt"], params)
            state["step"] += 1
            return state, loss

    return body


def _mesh_attention(cfg, mesh: Mesh, ring_attention: bool):
    """The attention of a step over ``mesh``: the ring (zigzag, or
    banded under a window), the kernels per (dp, tp) shard, or None for
    a one-device mesh (the single-device registry per shard)."""
    if ring_attention:
        if mesh.shape["sp"] < 2:
            raise ValueError("ring_attention needs an sp axis > 1")
        from tpushare_torch.workloads.ops.ring_attention import (
            make_ring_attention)
        if cfg.attn_window is not None:
            ring = make_ring_attention(mesh, causal=True,
                                       window=cfg.attn_window)
        else:
            ring = make_ring_attention(mesh, causal=True, zigzag=True,
                                       reorder=False)
        return ring.shards
    if mesh.size > 1:
        from tpushare_torch.workloads.ops.attention import (
            make_mesh_attention)
        return make_mesh_attention(cfg, mesh)
    return None


def mesh_grad_fn(cfg, mesh: Mesh, ring_attention: bool = False,
                 accum_steps: int = 1, moe: bool = False):
    """``grad_fn(params, inputs, targets) -> (loss, grads)`` of the step
    over ``mesh`` (placed params; grads as :class:`Sharded` leaves, every
    replica holding its block's summed gradient) — the step's body before
    the update."""
    from tpushare_torch.workloads.parallel.pipeline import (group_loss,
                                                            moe_dp_loss)
    assert_divisible(cfg, mesh)
    attn = _mesh_attention(cfg, mesh, ring_attention)
    sp = mesh.shape["sp"]
    zigzag = ring_attention and cfg.attn_window is None

    def grad_fn(params: dict, inputs, targets):
        S = inputs.shape[1]
        if S % sp:
            raise ValueError(f"sequence {S} not divisible by sp {sp}")
        positions = reorder = None
        if zigzag:
            from tpushare_torch.workloads.ops.ring_attention import (
                zigzag_split)

            def reorder(x):
                return zigzag_split(x, sp, axis=1)
            positions = zigzag_split(torch.arange(S), sp, axis=0)

        def one(params, d, i, t):
            return group_loss(params, d, i, t, cfg, mesh, attn=attn,
                              positions=positions)

        def joint(params, per_rank):
            return moe_dp_loss(params, per_rank, cfg, mesh, attn=attn)
        return mesh_loss_and_grads(params, inputs, targets, mesh, one,
                                   accum_steps, joint=joint if moe else None,
                                   reorder=reorder)

    return grad_fn


def _mesh_step(cfg, optimizer: AdamW, mesh: Mesh, ring_attention: bool,
               accum_steps: int, moe: bool = False):
    grad_fn = mesh_grad_fn(cfg, mesh, ring_attention, accum_steps, moe)

    def step(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        loss, grads = grad_fn(state["params"], inputs, targets)
        optimizer.update(grads, state["opt"], state["params"])
        state["step"] += 1
        return state, loss

    return step


def make_moe_train_step(cfg, optimizer: AdamW, device="cuda"):
    """Returns ``step(state, inputs, targets) -> (state, loss)`` over the
    MoE model (``init_state(init_moe_params(...), optimizer)``): the
    gradient of ``moe_loss_fn`` (on the card the attention runs the
    flash forward with LSE and its dQ / dK/dV backward), then one AdamW
    update in place — the reference's ``make_moe_train_step``. A
    :class:`Mesh` trains over (dp, tp, ep) shards (:func:`place_moe_state`):
    the experts over ep as ``moe_ffn``'s ep form runs them. A mesh with
    sp > 1 is refused: routing slots tokens by a cumsum over the whole
    sequence."""
    from tpushare_torch.workloads.models.moe import moe_loss_fn
    if isinstance(device, Mesh):
        if device.shape["sp"] > 1:
            raise ValueError(
                f"the MoE step composes dp, tp and ep (mesh has sp="
                f"{device.shape['sp']}): routing slots tokens by a cumsum "
                "over the whole sequence")
        return _mesh_step(cfg, optimizer, device, False, 1, moe=True)
    dev = _one_device(device)

    def step(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        loss, grads = loss_and_grads(state["params"], inputs.to(dev),
                                     targets.to(dev), cfg, moe_loss_fn)
        optimizer.update(grads, state["opt"], state["params"])
        state["step"] += 1
        return state, loss

    return step


def make_train_loop(cfg: TransformerConfig, optimizer: AdamW, device,
                    n_steps: int, ring_attention: bool = False,
                    accum_steps: int = 1):
    """Returns ``loop(state, inputs, targets) -> (state, losses)``:
    ``n_steps`` optimizer steps on the same batch, losses (n_steps,);
    ``device`` as :func:`make_train_step` takes it, a mesh included."""
    body = make_train_step(cfg, optimizer, device, ring_attention,
                           accum_steps)

    def loop(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        losses = []
        for _ in range(n_steps):
            state, loss = body(state, inputs, targets)
            losses.append(loss)
        return state, torch.stack(losses)

    return loop
