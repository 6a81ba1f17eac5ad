"""Pipeline parallelism (the ``pp`` axis), and the sharded forward every
training mesh runs — the port of ``tpushare/workloads/parallel/
pipeline.py``.

The reference writes its pipelined step as one fully manual
``shard_map``: each device runs the same program on its shards, with
explicit collectives. The port runs that program from one controller,
device by device (:mod:`~tpushare_torch.workloads.parallel.mesh`): one dp
rank at a time, its (sp, tp) group of shards layer by layer, the
collectives as :func:`mesh.all_reduce` / :func:`mesh.all_gather` — fp32
sums in rank order — and stage-to-stage hops as ``.to`` copies.

- **Inside a stage** (:func:`_tp_layer_block`): manual megatron. Every
  tp rank holds the residual stream; its column shards of ``wq`` /
  ``wk`` / ``wv`` give its H/tp heads (and Hkv/tp K/V heads) and of
  ``w1`` / ``w3`` its F/tp hidden columns; the row-parallel ``wo`` /
  ``w2`` products are summed over tp in fp32 in rank order
  (``psum_tp``). Each shard's q/k/v come out of its own column split,
  so they are contiguous and the attention kernels launch on them as
  they are.
- **Embedding and head**: each tp rank looks up its ``embed`` columns
  and the ranks' blocks are gathered in rank order; ``out`` splits the
  vocabulary over tp and the cross entropy is a distributed logsumexp
  (the ranks' max, then a fp32 sum of exp over ranks), the target logit
  taken from the rank that holds it (:func:`_sharded_ce`). At tp = 1 it
  is the single-device ``log_softmax``.
- **Sequence parallelism**: each sp rank holds its chunk; attention is
  the ring (``ops/ring_attention``), contiguous or banded inside
  pipeline stages (:func:`_make_sp_ring_attn`), and the per-chunk mean
  cross entropies are averaged in rank order.
- **GPipe** (:func:`pp_loss_fn`): stage p owns L/pp consecutive layers;
  the batch shard of a dp rank splits into ``n_micro`` microbatches and
  the schedule runs n_micro + pp - 1 steps, stage p taking microbatch
  t - p at step t. Bubble steps are skipped, not computed on masked
  dummies (the reference's ``shard_map`` must run every rank every
  step). The last stage computes each microbatch's cross entropy at
  once. The backward is autograd's through the copies, as the
  reference's is ``jax.grad``'s through ``ppermute``.
- **Stages on several processes** (pp across a pod group): each process
  runs its own stages' steps of the same schedule; a handoff to another
  process is a ``mesh.SendStage`` / ``RecvStage`` pair whose backward
  carries the gradient back, and the microbatches' cross entropies and
  auxes are gathered so every process forms the one-process loss
  (:func:`_gather_terms`).
- **MoE** (:func:`moe_pp_loss_fn`): attention and routing on the
  stage's first device, each ep rank's E/ep experts on its device
  (``models/moe.moe_ffn``'s ep form).

:func:`mesh_loss_and_grads` (``train.py``) drives any of these group
losses over the dp ranks and sums every replicated leaf's gradient over
its replicas in rank order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         apply_rope,
                                                         attention,
                                                         embed_lookup,
                                                         rmsnorm,
                                                         rope_tables,
                                                         unbind_layers)
from tpushare_torch.workloads.parallel.mesh import (RecvStage, Reduce,
                                                    SendStage, all_gather,
                                                    all_reduce,
                                                    assert_divisible,
                                                    exchange, fp32_sum,
                                                    moe_param_specs,
                                                    param_specs, place_tree)

EXPERT_LEAVES = ("w1", "w3", "w2")


def pp_param_specs() -> dict:
    """``param_specs`` with the stacked-layer axis split over pp."""
    specs = param_specs()
    specs["layers"] = {k: ("pp", *spec[1:])
                       for k, spec in specs["layers"].items()}
    return specs


def place_pp_params(params: dict, mesh) -> dict:
    return place_tree(params, pp_param_specs(), mesh)


def place_pp_state(state: dict, mesh) -> dict:
    """``train.place_state`` with the pipeline's rules: params and the
    AdamW moments split over pp on the layer axis."""
    from tpushare_torch.workloads.train import place_state
    return place_state(state, mesh, shard_tree=pp_param_specs())


def _check_pp(cfg: TransformerConfig, mesh, n_micro: int,
              batch: int | None = None, moe: bool = False) -> int:
    pp = mesh.shape["pp"]
    if pp < 2:
        raise ValueError("pipeline step needs a pp axis > 1 "
                         "(use make_train_step otherwise)")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp}")
    dp = mesh.shape["dp"]
    if batch is not None and batch % (dp * n_micro):
        raise ValueError(f"batch {batch} not divisible by dp*n_micro "
                         f"{dp}*{n_micro} (each dp rank runs its own "
                         "GPipe schedule over its batch shard)")
    banned = ("ep",) if not moe else ("sp", "tp")
    for axis in banned:
        if mesh.shape[axis] > 1:
            kind = "dp, tp and sp" if not moe else "dp and ep"
            raise ValueError(
                f"{'MoE ' if moe else ''}pipeline parallelism composes "
                f"with {kind} (mesh has {axis}={mesh.shape[axis]}); "
                "see pipeline.py")
    return pp


def _make_sp_ring_attn(cfg: TransformerConfig, mesh):
    """Sequence-parallel attention inside pp stages: the ring over sp,
    contiguous causal, or banded for a windowed config (hops capped at
    the band's reach). The zigzag balance is not used here: its layout
    would have to ride through the embedding, the targets and every
    stage boundary."""
    from tpushare_torch.workloads.ops.ring_attention import (
        make_ring_attention)
    return make_ring_attention(mesh, causal=True,
                               window=getattr(cfg, "attn_window", None))


# ---------------------------------------------------------------------------
# one (sp, tp) group of shards
# ---------------------------------------------------------------------------

class _Group:
    """The shards of dp rank ``d`` in pipeline stage ``p``: keys (sp
    rank, tp rank), each with its grid device (ep rank 0)."""

    def __init__(self, mesh, d: int, p: int) -> None:
        self.mesh, self.d, self.p = mesh, d, p
        self.sp, self.tp = mesh.shape["sp"], mesh.shape["tp"]
        self.keys = [(s, t) for s in range(self.sp) for t in range(self.tp)]

    def device(self, s: int, t: int, e: int = 0) -> torch.device:
        return self.mesh.device(dp=self.d, sp=s, tp=t, ep=e, pp=self.p)

    def leaf(self, leaf, s: int, t: int, e: int = 0) -> torch.Tensor:
        return leaf.at(dp=self.d, sp=s, tp=t, ep=e, pp=self.p)

    def layers(self, layers: dict, moe: bool = False) -> list:
        """Per layer of the stage: ``{key: layer dict}`` of the (sp, tp)
        shards, and for MoE the experts as ``[ep rank][tp rank]`` dicts
        of ``w1`` / ``w3`` / ``w2`` blocks."""
        dense = [n for n in layers if not (moe and n in EXPERT_LEAVES)]
        per_key = {k: unbind_layers({"layers": {
            n: self.leaf(layers[n], *k) for n in dense}})
            for k in self.keys}
        n_layers = len(next(iter(per_key.values())))
        out = [{k: per_key[k][i] for k in self.keys}
               for i in range(n_layers)]
        if not moe:
            return out
        ep = self.mesh.shape["ep"]
        experts = [[unbind_layers({"layers": {
            n: self.leaf(layers[n], 0, t, e) for n in EXPERT_LEAVES}})
            for t in range(self.tp)] for e in range(ep)]
        return [(out[i], [[experts[e][t][i] for t in range(self.tp)]
                          for e in range(ep)]) for i in range(n_layers)]

    def ropes(self, cfg, seq: int, positions=None) -> dict:
        """Every shard's RoPE rows: its sp chunk of ``positions``
        (default the natural order) on its device."""
        sl = seq // self.sp
        out = {}
        for s, t in self.keys:
            dev = self.device(s, t)
            cos, sin = rope_tables(cfg, seq, dev)
            if positions is not None:
                rows = positions[s * sl:(s + 1) * sl].to(dev)
                cos, sin = cos[rows], sin[rows]
            elif self.sp > 1:
                cos, sin = cos[s * sl:(s + 1) * sl], sin[s * sl:(s + 1) * sl]
            out[(s, t)] = (cos, sin)
        return out

    def chunks(self, tokens: torch.Tensor) -> dict:
        """(b, S) tokens as every shard's sp chunk on its device."""
        sl = tokens.shape[1] // self.sp
        return {(s, t): tokens[:, s * sl:(s + 1) * sl].to(self.device(s, t))
                for s, t in self.keys}

    def embed(self, embed, tokens: torch.Tensor, dtype) -> dict:
        """The residual stream of every shard: each tp rank's ``embed``
        columns looked up, gathered in rank order."""
        toks = self.chunks(tokens)
        xs = {}
        for s in range(self.sp):
            keys = [(s, t) for t in range(self.tp)]
            parts = [embed_lookup(self.leaf(embed, *k), toks[k], dtype)
                     for k in keys]
            xs.update(zip(keys, all_gather(parts, dim=-1)))
        return xs


def _row_parallel(xs: dict, hs: dict, lps: dict, name: str) -> dict:
    """``x + psum_tp(h @ w)`` for every sp rank: the tp ranks' partial
    products summed in rank order in fp32."""
    out = {}
    for s in sorted({s for s, _ in xs}):
        keys = sorted(k for k in xs if k[0] == s)
        ys = all_reduce([hs[k] @ lps[k][name] for k in keys])
        out.update({k: xs[k] + y for k, y in zip(keys, ys)})
    return out


def _attention_half(xs: dict, lps: dict, cfg, ropes: dict, attn) -> dict:
    """Norm, q/k/v from each shard's column split, RoPE, attention and
    the row-parallel ``wo``: the residual stream after attention."""
    hd = cfg.head_dim
    qs, ks, vs, os_ = {}, {}, {}, {}
    for key, x in xs.items():
        lp, (cos, sin) = lps[key], ropes[key]
        B, S = x.shape[:2]
        h = rmsnorm(x, lp["ln1"])
        qs[key] = apply_rope((h @ lp["wq"]).reshape(B, S, -1, hd), cos, sin)
        ks[key] = apply_rope((h @ lp["wk"]).reshape(B, S, -1, hd), cos, sin)
        vs[key] = (h @ lp["wv"]).reshape(B, S, -1, hd)
    for key, o in attn(qs, ks, vs).items():
        os_[key] = o.reshape(*o.shape[:2], -1)
    return _row_parallel(xs, os_, lps, "wo")


def _tp_layer_block(xs: dict, lps: dict, cfg, ropes: dict, attn) -> dict:
    """One transformer layer on manual tp shards (module docstring):
    numerically the plain ``layer_block`` up to the order of the tp sums,
    and the same ops when tp = 1."""
    xs = _attention_half(xs, lps, cfg, ropes, attn)
    hs = {k: rmsnorm(x, lps[k]["ln2"]) for k, x in xs.items()}
    ys = {k: F.silu(h @ lps[k]["w1"]) * (h @ lps[k]["w3"])
          for k, h in hs.items()}
    return _row_parallel(xs, ys, lps, "w2")


def _ep_moe_layer_block(xs: dict, lps: dict, experts: list, cfg,
                        ropes: dict, attn, capacity: int):
    """One MoE layer: attention as :func:`_tp_layer_block`'s; the router
    and the dispatch on the first shard's device, each ep rank's experts
    on its devices (``moe.moe_ffn`` with ``experts``), the combined
    output handed to every tp rank. Returns (xs, aux)."""
    from tpushare_torch.workloads.models.moe import moe_ffn
    from tpushare_torch.workloads.parallel.mesh import Broadcast
    xs = _attention_half(xs, lps, cfg, ropes, attn)
    home = sorted(xs)[0]
    h = rmsnorm(xs[home], lps[home]["ln2"])
    y, aux, stats = moe_ffn(h, lps[home], cfg, capacity, experts=experts,
                            with_stats=True)
    keys = sorted(xs)
    ys = [y] if len(keys) == 1 else Broadcast.apply(
        y, *(xs[k].device for k in keys))
    return {k: xs[k] + yk for k, yk in zip(keys, ys)}, (aux, stats)


def _sharded_ce(group: _Group, params: dict, xs: dict,
                targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the stage's output: per sp rank from the tp
    ranks' vocabulary blocks of ``out`` — a distributed logsumexp (max
    over ranks, exact as a shift; fp32 sum of exp in rank order) and the
    target logit from the rank that holds it — then the rank-order mean
    over sp. At tp = 1 the single-device ``log_softmax``."""
    tgts = group.chunks(targets)
    ces = []
    for s in range(group.sp):
        keys = [(s, t) for t in range(group.tp)]
        home = group.device(*keys[0])
        logits = []
        for k in keys:
            xn = rmsnorm(xs[k], group.leaf(params["norm_f"], *k))
            logits.append(xn.float() @ group.leaf(params["out"], *k).float())
        if group.tp == 1:
            logp = torch.log_softmax(logits[0], dim=-1)
            ll = torch.gather(logp, -1, tgts[keys[0]].long()[..., None])
            ces.append(-ll[..., 0].mean())
            continue
        m = torch.stack([lg.detach().amax(dim=-1, keepdim=True).to(home)
                         for lg in logits]).amax(dim=0)
        se = Reduce.apply(home, torch.float32, *(
            torch.exp(lg - m.to(lg.device)).sum(dim=-1, keepdim=True)
            for lg in logits))
        lse = (m + torch.log(se))[..., 0]
        parts = []
        for t, (k, lg) in enumerate(zip(keys, logits)):
            vl = lg.shape[-1]
            loc = tgts[k].long() - t * vl
            own = (loc >= 0) & (loc < vl)
            tl = torch.gather(lg, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
            parts.append(torch.where(own, tl, torch.zeros_like(tl)))
        tlog = Reduce.apply(home, torch.float32, *parts)
        ces.append(-(tlog - lse).mean())
    if group.sp == 1:
        return ces[0]
    return fp32_sum(ces, ces[0].device) / group.sp


def _layer_attention(cfg, mesh, stage_attn=None):
    """The attention core of a group's layers: ``stage_attn`` (the sp
    ring, the step's mesh policy) or, per shard, the single-device
    ``transformer.attention`` on the shard's local tensors (the kernel
    per shard on a card)."""
    if stage_attn is not None:
        return stage_attn
    return lambda qs, ks, vs: {key: attention(qs[key], ks[key], vs[key], cfg)
                               for key in qs}


def group_loss(params: dict, d: int, inputs: torch.Tensor,
               targets: torch.Tensor, cfg, mesh, *, n_stages: int = 1,
               n_micro: int = 1, attn=None, positions=None,
               moe: bool = False, aux_stats: bool = False):
    """The mean loss of dp rank ``d``'s batch shard ``inputs`` /
    ``targets`` (b, S) over the mesh: the GPipe schedule over
    ``n_stages`` stages (1: the plain step, every layer on the pp=0
    devices) and ``n_micro`` microbatches, bubble steps skipped. Returns
    a 0-d fp32 tensor on the last stage's first device: the mean of the
    microbatches' cross entropies, plus ``router_aux_coef`` x the mean
    per-layer aux for MoE — or, with ``aux_stats``, (the cross entropy,
    every layer's routing (importance, load)) for a caller that averages
    them over dp ranks first (:func:`moe_dp_loss`)."""
    attn = _layer_attention(cfg, mesh, attn)
    B, S = inputs.shape
    mb = B // n_micro
    groups = [_Group(mesh, d, p) for p in range(n_stages)]
    owner = [mesh.owner(dp=d, pp=p) for p in range(n_stages)]
    mine = [o == mesh.process_index for o in owner]
    stage_layers = [g.layers(params["layers"], moe) if mine[p] else None
                    for p, g in enumerate(groups)]
    ropes = [g.ropes(cfg, S, positions) if mine[p] else None
             for p, g in enumerate(groups)]
    capacity = cfg.expert_capacity if moe else None
    remat = cfg.remat and torch.is_grad_enabled()

    def run_stage(p: int, xs: dict):
        auxes = []
        for lp in stage_layers[p]:
            if moe:
                def layer(xs, lp, p=p):
                    return _ep_moe_layer_block(xs, lp[0], lp[1], cfg,
                                               ropes[p], attn, capacity)
            else:
                def layer(xs, lp, p=p):
                    return _tp_layer_block(xs, lp, cfg, ropes[p], attn), None
            xs, aux = (checkpoint(layer, xs, lp, use_reentrant=False)
                       if remat else layer(xs, lp))
            auxes.append(aux)
        return xs, auxes

    def tag(p: int, m: int) -> int:
        # the handoff into stage p of microbatch m: one tag per shard
        return ((d * n_stages + p) * n_micro + m) * len(groups[p].keys)

    # ces by microbatch; auxes by (stage, microbatch, layer), inserted in
    # the schedule's order; zeros: the cross-process sends' anchors
    recv, ces, auxes, zeros = {}, {}, {}, []
    for step in range(n_micro + n_stages - 1):
        for p in range(n_stages):
            m = step - p
            if not 0 <= m < n_micro or not mine[p]:
                continue            # a bubble, or another process's stage
            rows = slice(m * mb, (m + 1) * mb)
            g = groups[p]
            if p == 0:
                xs = g.embed(params["embed"], inputs[rows], cfg.dtype)
            elif mine[p - 1]:
                xs = recv.pop((p, m))
            else:
                anchor = g.leaf(params["layers"]["ln1"], *g.keys[0])
                metas = [((mb, S // g.sp, cfg.d_model), cfg.dtype,
                          g.device(*k)) for k in g.keys]
                xs = dict(zip(g.keys, RecvStage.apply(
                    anchor, owner[p - 1], tag(p, m), metas)))
            xs, aux = run_stage(p, xs)
            auxes.update(((p, m, i), a) for i, a in enumerate(aux))
            if p == n_stages - 1:
                ces[m] = _sharded_ce(g, params, xs, targets[rows])
            elif mine[p + 1]:
                nxt = groups[p + 1]
                recv[(p + 1, m)] = {k: x.to(nxt.device(*k))
                                    for k, x in xs.items()}
            else:
                zeros.append(SendStage.apply(owner[p + 1], tag(p + 1, m),
                                             *(xs[k] for k in g.keys)))
    home = next(iter(ces.values())).device if ces else mesh.first_device()
    if not all(mine):
        _gather_terms(ces, auxes, moe, home)
    ces = [ces[m] for m in range(n_micro)]
    auxes = [auxes[k] for k in sorted(auxes, key=lambda k: (k[0] + k[1],
                                                            k[0], k[2]))]
    loss = ces[0] if n_micro == 1 else fp32_sum(ces, home) / n_micro
    if aux_stats:
        return loss, [st for _, st in auxes]
    if moe:
        aux = torch.stack([a.to(home) for a, _ in auxes]).mean()
        loss = loss + cfg.router_aux_coef * aux
    for z in zeros:
        loss = loss + z.to(home)
    return loss


def _gather_terms(ces: dict, auxes: dict, moe: bool, home) -> None:
    """Fill in the microbatches' cross entropies and (MoE) the layers'
    auxes that other processes' stages made, gathered on ``home``: every
    process then forms the one-process loss from the same values — its
    own live, the others' constant — so the gradient reaches each term
    on the process that made it. A process without the last stage adds
    its sends' zeros to that loss, which leaves its value as it is."""
    values = {("ce", m): ce.detach() for m, ce in ces.items()}
    if moe:
        values.update({("aux", *k): a[0].detach() for k, a in auxes.items()})
    for key, v in exchange(values).items():
        if key[0] == "ce" and key[1] not in ces:
            ces[key[1]] = v.to(home)
        elif key[0] == "aux" and key[1:] not in auxes:
            auxes[key[1:]] = (v.to(home), None)


def moe_dp_loss(params: dict, per_rank: dict, cfg, mesh,
                attn=None) -> torch.Tensor:
    """The MoE loss over every dp rank at once, as the reference's
    global-batch step has it: the cross entropies' rank-order mean, and
    each layer's aux from the dp ranks' mean importance and load (the
    load-balancing term is a product of batch means, so per-rank auxes
    would not average to it). ``per_rank`` is ``{dp rank: (inputs,
    targets)}`` of this process's ranks; on a mesh over several
    processes the other ranks' cross entropies, importances and loads
    are gathered, so the aux is the global one, while the gradient
    flows back only through this process's own terms — none is counted
    twice."""
    dp = mesh.shape["dp"]
    ces, stats = {}, {}
    for d, (i, t) in sorted(per_rank.items()):
        ces[d], stats[d] = group_loss(params, d, i, t, cfg, mesh, attn=attn,
                                      moe=True, aux_stats=True)
    if len(per_rank) < dp:
        values = {("ce", d): ce.detach() for d, ce in ces.items()}
        for d, st in stats.items():
            for li, (imp, load) in enumerate(st):
                values[("imp", d, li)] = imp.detach()
                values[("load", d, li)] = load.detach()
        got = exchange(values)
        dev = next(iter(ces.values())).device
        n_layers = len(next(iter(stats.values())))
        for d in range(dp):
            if d not in ces:
                ces[d] = got[("ce", d)].to(dev)
                stats[d] = [(got[("imp", d, li)].to(dev),
                             got[("load", d, li)].to(dev))
                            for li in range(n_layers)]
    ces = [ces[d] for d in range(dp)]
    stats = [stats[d] for d in range(dp)]
    home = ces[0].device
    ce = ces[0] if dp == 1 else fp32_sum(ces, home) / dp
    auxes = []
    for layer in zip(*stats):
        if dp == 1:
            imp, load = layer[0]
        else:
            imp = fp32_sum([st[0] for st in layer], home) / dp
            load = fp32_sum([st[1] for st in layer], home) / dp
        auxes.append(cfg.n_experts * torch.sum(imp * load).to(home))
    return ce + cfg.router_aux_coef * torch.stack(auxes).mean()


# ---------------------------------------------------------------------------
# the pipelined losses and steps
# ---------------------------------------------------------------------------

def _dp_mean(params, inputs, targets, mesh, fn) -> torch.Tensor:
    """The global mean of ``fn(params, d, rows, rows)`` over the dp
    ranks' equal batch shards, summed in rank order."""
    dp = mesh.shape["dp"]
    bs = inputs.shape[0] // dp
    losses = [fn(params, d, inputs[d * bs:(d + 1) * bs],
                 targets[d * bs:(d + 1) * bs]) for d in range(dp)]
    return losses[0] if dp == 1 else \
        fp32_sum(losses, losses[0].device) / dp


def pp_loss_fn(params: dict, inputs: torch.Tensor, targets: torch.Tensor,
               cfg: TransformerConfig, mesh, n_micro: int) -> torch.Tensor:
    """Mean CE of the pipelined forward over placed params
    (:func:`place_pp_state`) — numerically the plain forward's (equal
    microbatches: the mean of means)."""
    pp = _check_pp(cfg, mesh, n_micro, inputs.shape[0])
    S, sp = inputs.shape[1], mesh.shape["sp"]
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp {sp}")
    attn = _make_sp_ring_attn(cfg, mesh).shards if sp > 1 else None

    def one(params, d, i, t):
        return group_loss(params, d, i, t, cfg, mesh, n_stages=pp,
                          n_micro=n_micro, attn=attn)
    return _dp_mean(params, inputs, targets, mesh, one)


def moe_pp_param_specs() -> dict:
    """``moe_param_specs`` with the layer axis over pp and the experts
    over ep; tp stripped (the MoE pipeline composes pp x ep)."""
    specs = moe_param_specs()
    specs["layers"] = {
        k: ("pp", *[None if ax == "tp" else ax for ax in spec[1:]])
        for k, spec in specs["layers"].items()}
    return specs


def place_moe_pp_state(state: dict, mesh) -> dict:
    from tpushare_torch.workloads.train import place_state
    return place_state(state, mesh, shard_tree=moe_pp_param_specs())


def moe_pp_loss_fn(params: dict, inputs: torch.Tensor,
                   targets: torch.Tensor, cfg, mesh,
                   n_micro: int) -> torch.Tensor:
    """CE + router aux of the pipelined MoE forward: GPipe over pp, each
    ep rank's experts on its device inside every stage. The aux is the
    mean over layers and microbatches (it is quadratic in batch
    statistics, so it equals the plain step's only at n_micro = 1)."""
    pp = _check_pp(cfg, mesh, n_micro, inputs.shape[0], moe=True)
    ep = mesh.shape["ep"]
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"ep {ep}")

    def one(params, d, i, t):
        return group_loss(params, d, i, t, cfg, mesh, n_stages=pp,
                          n_micro=n_micro, moe=True)
    return _dp_mean(params, inputs, targets, mesh, one)


def pp_grad_fn(cfg, mesh, n_micro: int = 4, moe: bool = False):
    """``grad_fn(params, inputs, targets) -> (loss, grads)`` of the
    pipelined step over placed params — the step's body before the
    update."""
    from tpushare_torch.workloads.train import mesh_loss_and_grads
    pp, sp = mesh.shape["pp"], mesh.shape["sp"]
    attn = _make_sp_ring_attn(cfg, mesh).shards if sp > 1 else None

    def grad_fn(params: dict, inputs: torch.Tensor, targets: torch.Tensor):
        _check_pp(cfg, mesh, n_micro, inputs.shape[0], moe=moe)
        if inputs.shape[1] % sp:
            raise ValueError(f"sequence {inputs.shape[1]} not divisible "
                             f"by sp {sp}")

        def one(params, d, i, t):
            return group_loss(params, d, i, t, cfg, mesh, n_stages=pp,
                              n_micro=n_micro, attn=attn, moe=moe)
        return mesh_loss_and_grads(params, inputs, targets, mesh, one)

    return grad_fn


def _pp_step(cfg, optimizer, mesh, n_micro: int, moe: bool):
    grad_fn = pp_grad_fn(cfg, mesh, n_micro, moe)

    def step(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        loss, grads = grad_fn(state["params"], inputs, targets)
        optimizer.update(grads, state["opt"], state["params"])
        state["step"] += 1
        return state, loss

    return step


def make_pp_train_step(cfg: TransformerConfig, optimizer, mesh,
                       n_micro: int = 4):
    """Pipelined training step over a state placed by
    :func:`place_pp_state`: the GPipe schedule over pp (dp, tp and sp
    compose), autograd's backward through it, the replicas' gradients
    summed, one AdamW update in place per shard. ``step(state, inputs,
    targets) -> (state, loss)``."""
    assert_divisible(cfg, mesh)
    _check_pp(cfg, mesh, n_micro)
    return _pp_step(cfg, optimizer, mesh, n_micro, moe=False)


def make_moe_pp_train_step(cfg, optimizer, mesh, n_micro: int = 4):
    """Pipelined MoE training step (pp x ep, dp) over a state placed by
    :func:`place_moe_pp_state`."""
    assert_divisible(cfg, mesh)
    _check_pp(cfg, mesh, n_micro, moe=True)
    return _pp_step(cfg, optimizer, mesh, n_micro, moe=True)
