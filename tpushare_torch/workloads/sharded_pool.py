"""Sharded serving: the device programs of a tp×pp ``PagedServingEngine``
— the port of ``tpushare/workloads/sharded_pool.py``.

One engine, one controller, a grid of devices (``parallel/mesh.Mesh``).
The KV page pool ``(L, n_pages, ps, Hkv, hd)`` splits its layer axis
over pp (each pipeline stage holds the pages of its own layers) and its
KV-head axis over tp: shard (s, r) is one contiguous ``(L/pp, n_pages,
ps, Hkv/tp, hd)`` tensor on device (r, s) — an int8 pool's ``q`` and
``s`` planes split together —, held as ``pool[s][r]``. Per-head softmax
needs no collective, so each shard's read walks only its heads' pages,
with the decode kernel launched on the shard: K5 (K5-int8) runs
``layers × tp`` times a decode step. Every program that touches the pool
— the decode step's write and read, the chunked and pipelined prefill,
the page install / load / copy, the speculative verify, the handoff
extract / install — runs shard by shard here, through the unsharded
engine's own helpers (``decode.make_paged_attn_core``,
``make_paged_chunk_core``, ``make_cached_attn_core``,
``scatter_scratch_pages``, ...) at the shard's head counts, so there is
one rule for each, sharded or not.

The model step is the reference's exactness-preserving layout
(``_manual_layer``, reference ``:144-176``): rank r projects its heads
and hidden columns (``mesh.place_serving_params``), attends over its
pool shard, and the activations are gathered in rank order (a copy to
the stage's rank-0 device and a ``torch.cat``) before the unsplit
down-projections, never summed from partial products. The replicated
ops of a stage — norms, down-projections, residual adds — run once, on
its rank-0 device. Under pp the stages are a pure re-ordering of the
same ops, and prefill chunks follow the reference's GPipe schedule
(``_run_pipeline``, ``:179-213``): at schedule step t, stage s runs
chunk t - s, so chunk c + 1 reaches stage s one step after stage s
wrote chunk c's K/V. The reference computes its bubble steps on clamped
inputs with gated writes (an SPMD program runs every stage every
step); the one controller skips them. Embedding, ``lm_head`` and
sampling run on the mesh's first device, on the same activations as the
unsharded engine's.

Host-side accounting is untouched: pages are global (a page holds every
layer's and head's shard of its rows), so the allocator, the admission
forecasts and the leak invariants do not see the shard count; only a
page's bytes split across devices (``paging.kv_bytes_per_el``'s
``shards``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpushare_torch.workloads.decode import (
    cache_fill, copy_pool_page, extract_request_pages, gather_pool_pages,
    make_cached_attn_core, make_paged_attn_core, make_paged_chunk_core,
    scatter_scratch_pages, stage_request_pages)
from tpushare_torch.workloads.decode import kv_view as _kv_view
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, apply_rope, attention, embed_lookup, lm_head, rmsnorm,
    rope_freqs, rope_tables)
from tpushare_torch.workloads.parallel.mesh import serving_degrees

__all__ = ["pool_spec", "scratch_spec", "place_state", "place_scratch",
           "replicate", "decode_layers", "verify_layers",
           "sharded_prefill_chunks", "sharded_prefill",
           "sharded_install_pages", "sharded_load_pool_pages",
           "sharded_copy_pool_page", "sharded_extract_request_pages",
           "sharded_install_request_pages"]


# ---------------------------------------------------------------------------
# layouts / placement
# ---------------------------------------------------------------------------

def pool_spec(codec: str):
    """The mesh axis of each dim of one pool leaf ``(L, n_pages, ps,
    Hkv, hd)``: layers over pp, KV heads over tp — an int8 pool's scale
    plane ``(L, n_pages, ps, Hkv)`` splits on the same axes, so ``q``
    and ``s`` always travel together."""
    q = ("pp", None, None, "tp", None)
    if codec == "int8":
        return {"q": q, "s": ("pp", None, None, "tp")}
    return q


def scratch_spec():
    """The admission / registration prefill scratch ``(L, 1, R, Hkv,
    hd)`` — always dense (an int8 pool quantizes at page install) —
    split like the pool, so the install is shard-local."""
    return ("pp", None, None, "tp", None)


def _home(mesh) -> torch.device:
    return mesh.device(tp=0, pp=0)


def _split(t: torch.Tensor, spec, mesh) -> list[list[torch.Tensor]]:
    """``t`` cut along the spec's named dims: ``[s][r]``, each shard a
    contiguous tensor on device (r, s)."""
    tp, pp = serving_degrees(mesh)
    out = []
    for s in range(pp):
        row = []
        for r in range(tp):
            idx = []
            for dim, axis in enumerate(spec):
                n = t.shape[dim]
                at, of = {"pp": (s, pp), "tp": (r, tp)}.get(axis, (0, 1))
                idx.append(slice(at * n // of, (at + 1) * n // of))
            dev = mesh.device(tp=r, pp=s)
            row.append(t[tuple(idx)].to(dev).contiguous())
        out.append(row)
    return out


def _split_leaf(leaf, spec, mesh) -> list[list]:
    if not isinstance(leaf, dict):
        return _split(leaf, spec, mesh)
    planes = {name: _split(plane, spec[name], mesh)
              for name, plane in leaf.items()}
    return [[{name: planes[name][s][r] for name in leaf}
             for r in range(len(planes["q"][s]))]
            for s in range(len(planes["q"]))]


def place_state(state: dict, mesh, codec: str) -> dict:
    """An engine state dict on the mesh: the pool leaves ("k" / "v")
    split by :func:`pool_spec` into ``[s][r]`` shards, everything else
    (tables, lengths, sampling state) on the mesh's first device, where
    the one controller reads and writes it."""
    spec = pool_spec(codec)
    return {key: (_split_leaf(leaf, spec, mesh) if key in ("k", "v")
                  else leaf.to(_home(mesh)))
            for key, leaf in state.items()}


def place_scratch(sk, sv, mesh):
    """A dense prefill scratch split like the pool."""
    return (_split(sk, scratch_spec(), mesh),
            _split(sv, scratch_spec(), mesh))


def replicate(tree, mesh):
    """Every tensor of ``tree`` on the mesh's first device — the draft
    pool and state of a sharded engine: the draft is small by design,
    so it is not split and runs the single-device draft programs."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree.to(_home(mesh)) if torch.is_tensor(tree) else tree


def _shards(mesh):
    """(s, r, device) of every shard, stage-major."""
    tp, pp = serving_degrees(mesh)
    return [(s, r, mesh.device(tp=r, pp=s))
            for s in range(pp) for r in range(tp)]


# ---------------------------------------------------------------------------
# the model step (exactness-preserving megatron)
# ---------------------------------------------------------------------------

def _local_cfg(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """A shard's view of the model: its heads, KV heads and hidden
    columns, at the same head_dim — what the attention cores read."""
    if tp == 1:
        return cfg
    return dataclasses.replace(
        cfg, d_model=cfg.head_dim * cfg.n_heads // tp,
        n_heads=cfg.n_heads // tp, n_kv_heads=cfg.kv_heads // tp,
        d_ff=cfg.d_ff // tp)


def _gather_last(parts: list[torch.Tensor], dev: torch.device):
    """All-gather a tp-split trailing axis back to full width in rank
    order — byte for byte the unsharded layout (head h of rank r is
    global head r * H/tp + h, the column split's order)."""
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def _manual_layer(x, stage: dict, i: int, hd: int, rope: list, cores: list):
    """Layer ``i`` of a stage on its tp shards — op for op
    ``transformer.layer_block`` with the head and hidden axes split: each
    rank projects its heads and columns, attends over its pool shard
    (``cores[r]``), then the activations are gathered in rank order and
    the unsplit down-projections applied on the stage's rank-0 device.
    ``rope[r]`` is rank r's (device, cos, sin)."""
    lead = stage["lead"]
    B, Q = x.shape[:2]
    h = rmsnorm(x, lead["ln1"][i])
    outs = []
    for lp, core, (dev, cos, sin) in zip(stage["ranks"], cores, rope):
        hr = h.to(dev)
        q = (hr @ lp["wq"][i]).reshape(B, Q, -1, hd)
        k = (hr @ lp["wk"][i]).reshape(B, Q, -1, hd)
        v = (hr @ lp["wv"][i]).reshape(B, Q, -1, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o, _ = core(q, k, v)
        outs.append(o.reshape(B, Q, -1))
    x = x + _gather_last(outs, x.device) @ lead["wo"][i]
    h = rmsnorm(x, lead["ln2"][i])
    ys = []
    for lp, (dev, _, _) in zip(stage["ranks"], rope):
        hr = h.to(dev)
        ys.append(F.silu(hr @ lp["w1"][i]) * (hr @ lp["w3"][i]))
    return x + _gather_last(ys, x.device) @ lead["w2"][i]


def _run_pipeline(pp: int, n_feeds: int, feed, run_stage):
    """The GPipe schedule: ``n_feeds`` microbatches (1 for a decode step,
    the chunk list for a pipelined prefill) through ``pp`` stages in
    ``n_feeds + pp - 1`` steps, stage s running feed t - s at step t and
    taking its input from stage s - 1's output of the same feed.
    Returns the last stage's output of the last feed."""
    outs = {}
    for t in range(n_feeds + pp - 1):
        for s in range(pp):
            m = t - s
            if 0 <= m < n_feeds:
                xin = feed(m) if s == 0 else outs.pop((s - 1, m))
                outs[(s, m)] = run_stage(s, m, xin)
    return outs[(pp - 1, n_feeds - 1)]


def _stage_devices(mesh, s: int) -> list[torch.device]:
    tp, _ = serving_degrees(mesh)
    return [mesh.device(tp=r, pp=s) for r in range(tp)]


def _run_layers(params: dict, mesh, cfg: TransformerConfig, n_feeds: int,
                feed, make_cores, rope_of):
    """Every stage's layers over the pipeline: ``make_cores(s, i, m,
    devices)`` gives layer i's per-rank attention cores for feed m,
    ``rope_of(m, devices)`` each rank's (device, cos, sin). Returns the
    final activations on the mesh's first device."""
    tp, pp = serving_degrees(mesh)
    hd = cfg.head_dim

    def run_stage(s: int, m: int, xin):
        devs = _stage_devices(mesh, s)
        stage = params["stages"][s]
        xin = xin.to(devs[0])
        rope = rope_of(m, devs)
        for i in range(stage["lead"]["wo"].shape[0]):
            xin = _manual_layer(xin, stage, i, hd, rope,
                                make_cores(s, i, m, devs))
        return xin

    return _run_pipeline(pp, n_feeds, feed, run_stage).to(_home(mesh))


def _rope_on(cos, sin):
    def rope_of(_m, devs):
        return [(d, cos.to(d), sin.to(d)) for d in devs]
    return rope_of


# ---------------------------------------------------------------------------
# decode: steps over the sharded pool
# ---------------------------------------------------------------------------

def decode_layers(params: dict, state: dict, x: torch.Tensor,
                  cfg: TransformerConfig, cos, sin, impl: str, mesh,
                  gather_pages_w: int | None = None) -> torch.Tensor:
    """One decode step's layer stack over the sharded pool: each shard
    writes the step's K/V row into its pages and reads them through
    ``decode.make_paged_attn_core`` at its head counts — the paged
    kernel (K5 / K5-int8, launched on each shard) or the gather twin.
    ``x`` (B, 1, D) on the mesh's first device."""
    tp, _ = serving_degrees(mesh)
    lcfg = _local_cfg(cfg, tp)
    lengths, tables = state["lengths"], state["tables"]

    def cores(s, i, _m, devs):
        return [make_paged_attn_core(
            _kv_view(state["k"][s][r], i), _kv_view(state["v"][s][r], i),
            tables.to(d), lengths.to(d), lcfg, impl=impl,
            gather_pages_w=gather_pages_w) for r, d in enumerate(devs)]

    return _run_layers(params, mesh, cfg, 1, lambda m: x, cores,
                       _rope_on(cos, sin))


# ---------------------------------------------------------------------------
# prefill: the chunk list microbatched through the pp stages
# ---------------------------------------------------------------------------

def sharded_prefill_chunks(params: dict, tokens: torch.Tensor, sk, sv,
                           start0: int, rel_last: int,
                           cfg: TransformerConfig, mesh=None,
                           with_logits: bool = True):
    """Run ``M`` equal-width prefill chunks (``tokens`` (M, 1, W), chunk
    m at rows ``start0 + m*W``) through the sharded scratch (``sk[s][r]``
    / ``sv[s][r]``, in place): under pp the chunks follow the GPipe
    schedule through the stages; under tp each layer runs the split
    step, its attention ``decode.make_cached_attn_core`` over the
    shard's scratch. Each chunk is ``decode.chunk_step`` at its start
    row, token for token the unsharded admission. With ``with_logits``
    returns (the last chunk's logits at in-chunk position ``rel_last``,
    sk, sv); K/V fills (full-width chunk groups, prefix registration)
    return (sk, sv) and skip the head."""
    tp, _ = serving_degrees(mesh)
    lcfg = _local_cfg(cfg, tp)
    M, _, W = tokens.shape
    home = _home(mesh)
    tokens = tokens.to(home)
    # per-chunk rope phases — chunk_step's rope=None branch
    angles = ((start0 + torch.arange(M, device=home)[:, None] * W
               + torch.arange(W, device=home)[None, :]).float()[..., None]
              * rope_freqs(cfg, home)[None, None, :])
    cos_all, sin_all = torch.cos(angles), torch.sin(angles)   # (M, W, half)
    R = sk[0][0].shape[2]
    slot_ids = {}

    def cores(s, i, m, devs):
        out = []
        for r, d in enumerate(devs):
            if d not in slot_ids:
                slot_ids[d] = torch.arange(R, device=d)
            out.append(make_cached_attn_core(
                _kv_view(sk[s][r], i), _kv_view(sv[s][r], i),
                start0 + m * W, lcfg, slot_ids[d]))
        return out

    def rope_of(m, devs):
        return [(d, cos_all[m].to(d), sin_all[m].to(d)) for d in devs]

    def feed(m):
        return embed_lookup(params["embed"], tokens[m], cfg.dtype)

    x = _run_layers(params, mesh, cfg, M, feed, cores, rope_of)
    if not with_logits:
        return sk, sv
    return lm_head(params, x[:, rel_last]), sk, sv


def sharded_prefill(params: dict, tokens: torch.Tensor, sk, sv,
                    cfg: TransformerConfig, mesh=None):
    """A prefix registration's prefill over the sharded scratch, in
    place: ``decode.prefill``'s layer — the whole prompt through the
    prefill attention of ``transformer.attention`` (the flash forward,
    K1, on the card; its twin on the CPU) at each shard's heads, its
    K/V written at the scratch origin. The unsharded engine registers
    through ``decode.prefill``, so the pinned pages are the unsharded
    engine's (the reference registers through its chunked prefill, which
    JAX computes bitwise as its one-shot prefill; the port's two
    attention paths round apart). ``tokens`` (1, P). Returns (sk, sv)."""
    tp, _ = serving_degrees(mesh)
    lcfg = _local_cfg(cfg, tp)
    home = _home(mesh)
    tokens = tokens.to(home)
    cos, sin = rope_tables(cfg, tokens.shape[1], home)

    def cores(s, i, _m, devs):
        def core_for(r):
            def core(q, k, v):
                cache_fill(_kv_view(sk[s][r], i), k)
                cache_fill(_kv_view(sv[s][r], i), v)
                return attention(q, k, v, lcfg), None
            return core
        return [core_for(r) for r in range(len(devs))]

    _run_layers(params, mesh, cfg, 1,
                lambda m: embed_lookup(params["embed"], tokens, cfg.dtype),
                cores, _rope_on(cos, sin))
    return sk, sv


# ---------------------------------------------------------------------------
# speculative round: replicated draft, sharded verify
# ---------------------------------------------------------------------------

def verify_layers(params: dict, state: dict, x: torch.Tensor,
                  cfg: TransformerConfig, cos, sin, mesh,
                  gather_pages_w: int | None = None) -> torch.Tensor:
    """A speculative round's verify pass over the sharded pool: each
    lane's k+1 candidates written into its pages and read back through
    ``decode.make_paged_chunk_core`` (the plain gather, as unsharded)
    on every shard. ``x`` (B, Q, D) on the mesh's first device."""
    tp, _ = serving_degrees(mesh)
    lcfg = _local_cfg(cfg, tp)
    lengths, tables = state["lengths"], state["tables"]

    def cores(s, i, _m, devs):
        return [make_paged_chunk_core(
            _kv_view(state["k"][s][r], i), _kv_view(state["v"][s][r], i),
            tables.to(d), lengths.to(d), lcfg,
            gather_pages_w=gather_pages_w) for r, d in enumerate(devs)]

    return _run_layers(params, mesh, cfg, 1, lambda m: x, cores,
                       _rope_on(cos, sin))


# ---------------------------------------------------------------------------
# pool data movers (shard-local: both sides share the pool's split)
# ---------------------------------------------------------------------------

def sharded_install_pages(kp, vp, sk, sv, page_ids: torch.Tensor,
                          skip_pages: int = 0, mesh=None):
    """``serving._install_pages`` over the sharded pool, in place: the
    scratch and the pool split alike, so each shard's install —
    ``decode.scatter_scratch_pages``, quantized on install for an int8
    pool (rowwise over the unsplit head_dim) — is shard-local and equal
    to the unsharded install's slice."""
    for s, r, d in _shards(mesh):
        ids = page_ids.to(d)
        scatter_scratch_pages(kp[s][r], sk[s][r], ids, skip_pages)
        scatter_scratch_pages(vp[s][r], sv[s][r], ids, skip_pages)
    return kp, vp


def sharded_load_pool_pages(sk, sv, kp, vp, page_ids: torch.Tensor,
                            mesh=None):
    """``decode.load_pool_pages`` over the sharded pool: a registered
    prefix's pages gather (dequantized) into the head of a sharded
    admission scratch, shard by shard (``decode.gather_pool_pages``)."""
    for s, r, d in _shards(mesh):
        ids = page_ids.to(d)
        gather_pool_pages(sk[s][r], kp[s][r], ids)
        gather_pool_pages(sv[s][r], vp[s][r], ids)
    return sk, sv


def sharded_copy_pool_page(kp, vp, src: int, dst: int, mesh=None):
    """``decode.copy_pool_page`` over the sharded pool — the
    copy-on-write device copy on every shard, ``q`` and ``s`` planes
    byte for byte."""
    for s, r, _ in _shards(mesh):
        copy_pool_page(kp[s][r], vp[s][r], src, dst)
    return kp, vp


def sharded_extract_request_pages(kp, vp, page_ids: torch.Tensor,
                                  mesh=None):
    """``decode.extract_request_pages`` over the sharded pool: the
    handoff record's pages come out split like the pool (``[s][r]``,
    int8 ``q`` and ``s`` planes together, never transcoded), so a
    same-mesh install scatters them back without moving a byte across
    devices."""
    pk = [[None] * len(row) for row in kp]
    pv = [[None] * len(row) for row in vp]
    for s, r, d in _shards(mesh):
        pk[s][r], pv[s][r] = extract_request_pages(kp[s][r], vp[s][r],
                                                   page_ids.to(d))
    return pk, pv


def sharded_install_request_pages(kp, vp, pk, pv, page_ids: torch.Tensor,
                                  mesh=None):
    """``decode.install_request_pages`` over the sharded pool, in place
    and all or nothing: every shard's planes are checked and staged on
    its device before the first byte is written anywhere."""
    staged = []
    for s, r, d in _shards(mesh):
        ids = page_ids.to(d)
        staged += [(dst, src, ids) for dst, src in stage_request_pages(
            kp[s][r], vp[s][r], pk[s][r], pv[s][r], ids)]
    for dst, src, ids in staged:
        dst[:, ids] = src
    return kp, vp
