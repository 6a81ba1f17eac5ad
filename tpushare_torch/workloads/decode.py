"""KV-cache autoregressive decoding — the port of
``tpushare/workloads/decode.py``: dense bf16/fp32 caches, the ring cache
of sliding-window models, the ragged slot read, the block-paged pool
with its shared-prefix page helpers (gather into a prefill scratch,
copy-on-write page copies), the multi-token paged step and draft scan
of speculative rounds, and the int8 KV codec for both (``cfg.kv_int8``
slot caches, ``kv_codec="int8"`` pools).

A cache or pool leaf is either a dense tensor or an int8 codec leaf
``{"q": int8 (..., hd), "s": fp32 (...)}`` (``kv_quantize``); every
reader and writer dispatches on the leaf type, so the two layouts are
interchangeable downstream, as in the reference.

The reference keeps everything functional under ``jit``/``lax.scan``;
the port runs eagerly and writes caches and pools IN PLACE (a slice
assignment into the preallocated buffer instead of a fresh copy per
layer), which is what keeps a decode step's memory at the cache itself.
Functions still return the cache / pool they were given so call sites
read like the reference's.

All paths — batch forward, prefill, cached chunk steps, the slot and
paged serving steps — run ``transformer.layer_block``, the one
definition of the architecture; the cached steps reach it through
:func:`model_layer`, which gives a MoE config's layers the routed
experts (``models/moe.moe_ffn``) as its FFN. ``mm`` (``quant.qmm`` over
an int8 parameter mirror) rides every dense path.
"""

from __future__ import annotations

import torch

from tpushare_torch import consts
from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.moe import moe_ffn
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig,
    attention,
    embed_lookup,
    layer_block,
    layer_params,
    lm_head,
    rope_freqs,
    rope_tables,
)
from tpushare_torch.workloads.ops.paged_attention import (
    paged_attention_read)
from tpushare_torch.workloads.ops.registry import KIND_CHUNK, select_attention
from tpushare_torch.workloads.quant import (rowwise_absmax_decode,
                                            rowwise_absmax_encode)


def kv_quantize(x: torch.Tensor) -> dict:
    """Per-(position, head) symmetric int8 for K/V rows: x (..., hd) ->
    {"q": int8, "s": fp32 without the hd axis} — the one rowwise codec
    (``quant.rowwise_absmax_encode``) of the slot cache and the pool."""
    return rowwise_absmax_encode(x)


def kv_dequantize(leaf, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Read side of the codec: a ``{"q", "s"}`` leaf decodes to ``q * s``;
    a dense tensor passes through (cast)."""
    if not isinstance(leaf, dict):
        return leaf.to(dtype)
    return rowwise_absmax_decode(leaf["q"], leaf["s"], dtype)


def kv_data(leaf) -> torch.Tensor:
    """The value plane of a leaf — the tensor itself, or a codec leaf's
    int8 ``q`` — for shape queries."""
    return leaf["q"] if isinstance(leaf, dict) else leaf


def kv_planes(leaf) -> list:
    """The leaf's tensors: ``[leaf]``, or a codec leaf's ``[q, s]`` — for
    copies that move both planes together and never requantize."""
    return [leaf["q"], leaf["s"]] if isinstance(leaf, dict) else [leaf]


def kv_view(leaf, index):
    """A view of a leaf at a leading-axis ``index`` (``k[layer]``, a slot
    slice), dense or codec: both planes share the leading axes."""
    if isinstance(leaf, dict):
        return {"q": leaf["q"][index], "s": leaf["s"][index]}
    return leaf[index]


def kv_store(leaf, index, new: torch.Tensor):
    """Write rows ``new`` (..., hd) at a leading-axis ``index`` of a leaf,
    in place: cast for a dense leaf, quantized (both planes) for a codec
    leaf — the one write rule of every cache and pool path."""
    if isinstance(leaf, dict):
        nq = kv_quantize(new)
        leaf["q"][index] = nq["q"]
        leaf["s"][index] = nq["s"]
    else:
        leaf[index] = new.to(leaf.dtype)
    return leaf


def _kv_zeros(cfg: TransformerConfig, shape: tuple, int8: bool,
              device: torch.device):
    """A zeroed leaf: dense in the model dtype, or a codec leaf with
    q = 0 and s = 1."""
    if int8:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.ones(shape[:-1], dtype=torch.float32,
                                device=device)}
    return torch.zeros(shape, dtype=cfg.dtype, device=device)


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed KV cache: k/v (L, B, max_seq, Hkv, hd) in the model dtype —
    or, with ``cfg.kv_int8``, codec leaves (int8 ``q`` and fp32 ``s`` per
    (position, head)) — length 0 (a host int: eager positions are always
    concrete)."""
    dev = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, S, cfg.kv_heads, cfg.head_dim)
    return {"k": _kv_zeros(cfg, shape, cfg.kv_int8, dev),
            "v": _kv_zeros(cfg, shape, cfg.kv_int8, dev),
            "length": 0}


def cache_max_seq(cache: dict) -> int:
    """Row capacity of a cache, dense or codec."""
    return kv_data(cache["k"]).shape[2]


def slot_view(leaf, slot: int):
    """One slot's (L, 1, S, ...) view of a (L, n_slots, S, ...) cache
    leaf, dense or codec — the one slot-cache layout helper of the
    engine's admission, prefix install and the speculative slot round.
    A view: writes through it land in the engine's cache."""
    return kv_view(leaf, (slice(None), slice(slot, slot + 1)))


def slot_unview(leaf, sub, slot: int):
    """Write a :func:`slot_view`-shaped ``sub`` into ``leaf`` at ``slot``,
    in place from row 0 (both planes of a codec leaf, never requantized;
    ``sub`` may hold fewer rows, as a prefix does)."""
    for dst, src in zip(kv_planes(leaf), kv_planes(sub)):
        dst[:, slot:slot + 1, :src.shape[2]] = src
    return leaf


def cache_fill(kc, new: torch.Tensor):
    """Write (B, P, Hkv, hd) rows at the cache origin, in place (dense or
    codec)."""
    return kv_store(kc, (slice(None), slice(0, new.shape[1])), new)


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: dict, mm=None, logit_pos: int | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt (B, P) through the model, filling cache[:, :, :P].
    Returns (logits (B, vocab) fp32 at ``logit_pos`` — default the last
    position — and the cache). On the card the registry's rows pick the
    kernel: splash for an MHA prompt of 4096 or more that tiles its
    block grid, else flash, which needs no tiled prompt (unlike the
    reference's Pallas grid). Dense models only, as in the reference: a
    MoE prompt goes through ``moe_decode.moe_prefill`` or chunked
    admission."""
    P = tokens.shape[1]
    cos, sin = rope_tables(cfg, P, tokens.device)

    def attn_core(q, k, v):
        return attention(q, k, v, cfg), (k, v)

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        x, (k, v) = layer_block(x, layer_params(params, i), cfg, cos, sin,
                                attn_core, mm=mm)
        cache_fill(kv_view(cache["k"], i), k)
        cache_fill(kv_view(cache["v"], i), v)
    x_last = x[:, -1] if logit_pos is None else x[:, logit_pos]
    return lm_head(params, x_last), {**cache, "length": P}


def scatter_token_rows(cache, new: torch.Tensor, index: tuple):
    """Write one token's (B, 1, Hkv, hd) K/V at per-row cache positions,
    in place, dense or codec. ``index`` addresses one row per batch
    element — ``(rows, pos)`` on a (B, S, ...) cache, ``(layer, rows,
    pos)`` on a stacked (L, B, S, ...) one: the one definition of the
    per-row write shared by the dense slot step and the ragged path."""
    return kv_store(cache, index, new[:, 0])


def kv_scale_bhgqk(scales: torch.Tensor) -> torch.Tensor:
    """Per-(position, head) scales (B, S, Hkv) laid out against the
    (B, Hkv, G, Q, S) score tensor."""
    return scales.transpose(1, 2)[:, :, None, None, :]


def cached_attn_einsum(q: torch.Tensor, kc, vc, pos, cfg: TransformerConfig,
                       slot_ids: torch.Tensor) -> torch.Tensor:
    """The einsum core of :func:`make_cached_attn_core`: q (B, Q, H, hd)
    at ``pos`` against every row of a cache that already holds the
    chunk's K/V, grouped fp32 einsums with the rows a query may not see
    masked at -1e30 — the reference's core op for op, and the plain twin
    of the offset flash kernel. Returns (B, Q, H, hd) in q's dtype."""
    hd = cfg.head_dim
    G = cfg.n_heads // cfg.kv_heads
    R = slot_ids.shape[0]                 # cache rows (== max_seq dense)
    B, Q = q.shape[:2]
    if torch.is_tensor(pos):
        qpos = pos[:, None, None]                              # (B, 1, 1)
    else:
        qpos = (pos + torch.arange(Q, device=q.device))[None, :, None]
    if cfg.attn_window is not None:
        p = qpos - ((qpos - slot_ids[None, None, :]) % R)
        mask = (p >= 0) & (p > qpos - cfg.attn_window)
    else:
        mask = slot_ids[None, None, :] <= qpos                 # (B|1, Q, S)
    kmat, vmat = kv_data(kc).float(), kv_data(vc).float()
    qg = q.float().reshape(B, Q, kmat.shape[2], G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
    if isinstance(kc, dict):
        s = s * kv_scale_bhgqk(kc["s"])
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if isinstance(vc, dict):
        # the V scales fold into the probabilities; the values read stay
        # int8
        p = p * kv_scale_bhgqk(vc["s"])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
    return o.reshape(B, Q, cfg.n_heads, hd).to(q.dtype)


def make_cached_attn_core(kc, vc, pos, cfg: TransformerConfig,
                          slot_ids: torch.Tensor):
    """The per-layer cached-attention closure shared by the dense decode
    loop, the chunk step and the slot engine: write this step's K/V into
    the cache at ``pos`` (in place), then attend over the cache.

    The read is the registry's chunk kind (``KIND_CHUNK``), decided from
    the inputs alone: on the card a chunk of Q >= 2 queries at an int
    ``pos`` over a dense bf16 cache with no window runs the offset flash
    kernel, which reads the cache's first pos + Q rows in place
    (``attention.flash_chunk_attention``); decode steps, per-row
    positions, codec and ring caches, other dtypes and CPU tensors keep
    the reference's grouped fp32 einsums over the whole static cache
    (:func:`cached_attn_einsum`).

    A codec cache (``{q, s}`` leaves) quantizes on write and is read at
    int8 width with its scales folded in: the scores are
    ``einsum(q, k_q) * hd^-0.5 * k_s``, and the V scales multiply the
    probabilities after the softmax, before the einsum over ``v_q``. The
    chunk's own rows are read back quantized, as in the reference.

    ``pos`` is an int (every row at the same position; with Q > 1 tokens
    they land at pos..pos+Q-1 with intra-chunk causal masking) or a (B,)
    tensor (each slot at its own length, Q = 1).

    Windowed configs use ring arithmetic over the R = len(slot_ids) rows:
    position p lands in row p % R, and the mask reconstructs each row's
    absolute position as the newest value <= the query's,
    ``qpos - ((qpos - row) % R)`` (unwritten rows reconstruct negative),
    then keeps ``p > qpos - attn_window``. With R covering every position
    this is the banded causal mask. Callers that wrap (the ring cache)
    keep R >= attn_window + Q - 1. Returns attn_core(q, k, v) ->
    (o, (kc, vc))."""
    per_row = torch.is_tensor(pos)
    quantized = isinstance(kc, dict)
    R = slot_ids.shape[0]                 # cache rows (== max_seq dense)
    ring = cfg.attn_window is not None

    def write(cache, new):
        Q = new.shape[1]
        wpos = pos % R if ring else pos
        if per_row:
            rows = torch.arange(new.shape[0], device=new.device)
            return scatter_token_rows(cache, new, (rows, wpos))
        if wpos + Q > R:
            # a ring chunk straddling the wrap point: an index write
            wrows = (pos + torch.arange(Q, device=new.device)) % R
            return kv_store(cache, (slice(None), wrows), new)
        return kv_store(cache, (slice(None), slice(wpos, wpos + Q)), new)

    def attn_core(q, k, v):
        write(kc, k)
        write(vc, v)
        read = select_attention(
            KIND_CHUNK, seq=q.shape[1], window=cfg.attn_window,
            n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, platform=q.device.type,
            codec="int8" if quantized else None, dtype=kv_data(kc).dtype,
            per_row=per_row).fn
        if read is not None:
            return read(q, kc, vc, pos), (kc, vc)
        return cached_attn_einsum(q, kc, vc, pos, cfg, slot_ids), (kc, vc)

    return attn_core


def ragged_block_k(S: int) -> int:
    """K-chunk width of the reference's ragged kernel: the largest of its
    tuned sizes that tiles the cache rows. The CUDA kernel walks rows and
    needs no chunk; the rule stays because it is the reference's row
    gate."""
    for bk in (512, 256):
        if S % bk == 0:
            return bk
    raise ValueError(f"cache rows {S} not divisible by 256 "
                     "(ragged_decode needs block-tileable max_seq)")


def check_ragged_config(cfg: TransformerConfig, n_rows: int,
                        mesh=None) -> None:
    """Fail fast on configs the ragged read cannot serve (the engine
    calls this at construction so the error names the knob); the guards
    are the registry's decode rows, raising ``KernelUnavailable`` — a
    mesh's tp must tile the heads (``mesh:heads-untiled``)."""
    from tpushare_torch.workloads.ops.registry import KIND_DECODE, decide
    decide(KIND_DECODE, seq=n_rows, window=cfg.attn_window,
           mesh_shape={"tp": mesh.shape.get("tp", 1)}
           if mesh is not None else None,
           n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
           head_dim=cfg.head_dim, impl="ragged")


def make_ragged_attn_core(kf, vf, layer: int, lengths: torch.Tensor,
                          cfg: TransformerConfig, mesh=None):
    """Per-layer attention closure for the ragged slot step: write the
    step's K/V into the full stacked (L, B, S, Hkv, hd) cache at
    ``(layer, row, lengths[row])``, then read through the registry's
    ``ragged`` choice — the CUDA kernel on the card, its twin on the CPU
    — so the bytes read scale with each slot's live length. A codec
    cache is written quantized and read by the kernel's int8 rung.
    With ``mesh`` the read is the registry's sharded form: heads over
    tp and slots over dp where they tile, one launch per shard. Returns
    attn_core(q, k, v) -> (o, (kf, vf))."""
    from tpushare_torch.workloads.ops.registry import (KIND_DECODE,
                                                       select_attention)
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    read = select_attention(
        KIND_DECODE, impl="ragged", seq=kv_data(kf).shape[2],
        window=cfg.attn_window, mesh=mesh,
        n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, batch=lengths.shape[0]).fn

    def attn_core(q, k, v):
        scatter_token_rows(kf, k, (layer, rows, lengths))
        scatter_token_rows(vf, v, (layer, rows, lengths))
        o = read(q[:, 0], kf, vf, lengths, layer=layer)
        return o[:, None], (kf, vf)

    return attn_core


def model_layer(x: torch.Tensor, lp: dict, cfg, cos: torch.Tensor,
                sin: torch.Tensor, attn_core, mm=None):
    """Route one layer to the dense or the MoE body by the config's shape
    — the one switch through which every cached-step path (chunk_step,
    the slot, ragged, ring and paged steps, chunked admission) runs MoE
    models too: it only chooses ``layer_block``'s FFN. A MoE layer's
    expert capacity follows the chunk's width (``cfg.capacity_for``, pads
    included); its load-balancing term does not matter here and is
    dropped. ``mm`` applies to the dense body only. Returns (x, the
    attention core's aux)."""
    ffn = None
    if hasattr(cfg, "n_experts"):
        if mm is not None:
            raise NotImplementedError(
                "no quantized/LoRA MoE path: the mm hook only applies to "
                "the dense layer body")
        capacity = cfg.capacity_for(x.shape[1])

        def ffn(h, lp):
            return moe_ffn(h, lp, cfg, capacity=capacity)[0]
    return layer_block(x, lp, cfg, cos, sin, attn_core, mm=mm, ffn=ffn)


def chunk_step(params: dict, tokens: torch.Tensor, cache: dict,
               cfg: TransformerConfig, rope=None, mm=None,
               logit_pos: int | None = None) -> tuple[torch.Tensor, dict]:
    """Cached multi-token step: write Q tokens' K/V at cache['length']
    and return logits at every position (B, Q, vocab) fp32 — or, with
    ``logit_pos`` (an in-chunk index), only there, (B, vocab).

    An overflowing write raises instead of clamping (slice assignment
    past the cache would corrupt nothing but also write nothing), and so
    does a position past a bounded rope table. Windowed caches are ring
    buffers (:func:`make_cached_attn_core`): a write past the last row
    wraps, legal whenever rows >= attn_window + Q - 1."""
    B, Q = tokens.shape
    max_seq = cache_max_seq(cache)
    pos = int(cache["length"])
    ring = (cfg.attn_window is not None
            and max_seq >= cfg.attn_window + Q - 1)
    if not ring and pos + Q > max_seq:
        raise ValueError(f"KV cache overflow: length {pos} + chunk {Q} > "
                         f"max_seq {max_seq}; grow the cache or stop "
                         "decoding")
    if rope is not None and pos + Q > rope[0].shape[0]:
        raise ValueError(f"rope table overflow: position {pos} + chunk {Q} "
                         f"> table rows {rope[0].shape[0]}; pass rope=None "
                         "for unbounded decode")
    if rope is not None:
        cos, sin = rope[0][pos:pos + Q], rope[1][pos:pos + Q]
    else:
        angles = ((pos + torch.arange(Q, device=tokens.device)).float()[:, None]
                  * rope_freqs(cfg, tokens.device)[None, :])
        cos, sin = torch.cos(angles), torch.sin(angles)

    x = embed_lookup(params["embed"], tokens, cfg.dtype)     # (B, Q, D)
    slot_ids = torch.arange(max_seq, device=tokens.device)
    for i in range(cfg.n_layers):
        core = make_cached_attn_core(kv_view(cache["k"], i),
                                     kv_view(cache["v"], i), pos, cfg,
                                     slot_ids)
        x, _ = model_layer(x, layer_params(params, i), cfg, cos, sin, core,
                           mm=mm)
    if logit_pos is not None:
        x = x[:, logit_pos]
    return lm_head(params, x), {**cache, "length": pos + Q}


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: TransformerConfig, rope=None, mm=None
                ) -> tuple[torch.Tensor, dict]:
    """One token (B,) at position cache['length'] -> (logits, cache): the
    Q=1 case of :func:`chunk_step`."""
    return chunk_step(params, token[:, None], cache, cfg, rope=rope, mm=mm,
                      logit_pos=0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0) -> torch.Tensor:
    """(B, vocab) fp32 logits -> (B,) next tokens: greedy argmax at
    temperature <= 0 (or no generator), else softmax sampling from the
    truncated distribution with the caller's generator."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    logits = truncate_top_p(truncate_top_k(logits / temperature, top_k), top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def truncate_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus truncation: mask (B, vocab) logits outside each row's
    smallest descending-probability prefix whose mass reaches ``top_p``
    (the first crossing token is kept). ``top_p`` is a scalar or a (B,)
    tensor; values <= 0 or >= 1 keep everything."""
    if isinstance(top_p, (int, float)) and (top_p <= 0.0 or top_p >= 1.0):
        return logits
    p = torch.as_tensor(top_p, dtype=torch.float32,
                        device=logits.device).reshape(-1, 1)
    p = torch.where((p <= 0) | (p >= 1), 2.0, p)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thresh = torch.where(keep, sorted_logits, torch.inf).min(
        dim=-1, keepdim=True).values
    return torch.where(logits < thresh, -1e30, logits)


def truncate_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask (B, vocab) logits below each row's k-th highest to -1e30;
    top_k <= 0 is a no-op, top_k beyond the vocab keeps everything."""
    if top_k <= 0:
        return logits
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return torch.where(logits < kth, -1e30, logits)


# ---------------------------------------------------------------------------
# offline generation
# ---------------------------------------------------------------------------

def run_generate(prefill_fn, decode_step_fn, params: dict,
                 prompt: torch.Tensor, cfg, steps: int,
                 max_seq: int | None = None, temperature: float = 0.0,
                 top_k: int = 0, generator: torch.Generator | None = None,
                 top_p: float = 0.0) -> torch.Tensor:
    """Size the cache, prefill, then decode step by step with per-step
    sampling. Returns (B, steps) token ids."""
    B, P = prompt.shape
    need = P + steps
    S = max_seq or -(-need // 128) * 128
    if need > S:
        raise ValueError(f"prompt {P} + steps {steps} exceeds max_seq {S}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    cache = init_cache(cfg, B, S, device=prompt.device)
    logits, cache = prefill_fn(params, prompt, cfg, cache)
    token = sample_token(logits, generator, temperature, top_k, top_p)
    rope = rope_tables(cfg, S, prompt.device)
    out = [token]
    for _ in range(steps - 1):
        logits, cache = decode_step_fn(params, token, cache, cfg, rope)
        token = sample_token(logits, generator, temperature, top_k, top_p)
        out.append(token)
    return torch.stack(out, dim=1)


def generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
             steps: int, max_seq: int | None = None,
             temperature: float = 0.0, top_k: int = 0,
             generator: torch.Generator | None = None,
             top_p: float = 0.0) -> torch.Tensor:
    """Decode ``steps`` tokens after the (B, P) prompt — greedy by
    default; temperature/top-k/top-p sampling with a ``generator``."""
    return run_generate(
        prefill, lambda p, t, c, cf, rope: decode_step(p, t, c, cf, rope=rope),
        params, prompt, cfg, steps, max_seq, temperature, top_k, generator,
        top_p)


class BucketOverflowError(ValueError):
    """A prompt remainder fits no prefill bucket."""


def prefill_chunk_layout(plen: int, buckets) -> list[tuple[int, int, int]]:
    """The chunked-prefill layout shared by the engine and the
    ``chunked_generate`` oracle: (start, piece_len, padded_len) — full
    largest-bucket chunks, then the remainder padded to its bucket.
    ``buckets`` sorted ascending."""
    bmax = buckets[-1]
    chunks, pos = [], 0
    while plen - pos > bmax:
        chunks.append((pos, bmax, bmax))
        pos += bmax
    rem = plen - pos
    for b in buckets:
        if b >= rem:
            return chunks + [(pos, rem, b)]
    raise BucketOverflowError(
        f"length {rem} exceeds the largest bucket {bmax}")


def chunked_generate(params: dict, prompt: torch.Tensor,
                     cfg: TransformerConfig, steps: int,
                     buckets: tuple[int, ...], max_seq: int, mm=None,
                     rows: int | None = None) -> torch.Tensor:
    """Offline greedy decode with the serving engine's chunked-prefill
    semantics (same bucket layout, same pad widths, same per-chunk
    ``chunk_step``) — the exact oracle for engine tests. B must be 1.

    ``rows`` mirrors the engine's ring cache (``ServingEngine``
    ``ring_rows``): the cache holds that many rows while positions stay
    absolute. Needs ``cfg.attn_window`` and rows >= window + the largest
    bucket (the engine's own exactness bound)."""
    B, plen = prompt.shape
    if B != 1:
        raise ValueError("chunked_generate mirrors one engine lane (B=1)")
    bs = tuple(sorted(b for b in buckets if b <= max_seq))
    if not bs:
        raise ValueError(f"no bucket <= max_seq {max_seq}")
    if rows is not None:
        if cfg.attn_window is None:
            raise ValueError("rows (ring oracle) requires cfg.attn_window")
        if rows < cfg.attn_window + bs[-1]:
            raise ValueError(f"rows {rows} < attn_window + largest bucket "
                             f"{cfg.attn_window + bs[-1]}")
    cache = init_cache(cfg, 1, rows or max_seq, device=prompt.device)
    rope = rope_tables(cfg, max_seq, prompt.device)
    logits = None
    for start, piece, padded in prefill_chunk_layout(plen, bs):
        toks = prompt[:, start:start + piece]
        if padded > piece:
            toks = torch.nn.functional.pad(toks, (0, padded - piece))
        cache = {**cache, "length": start}
        logits, cache = chunk_step(params, toks, cache, cfg, mm=mm,
                                   logit_pos=piece - 1)
    cache = {**cache, "length": plen}
    out = []
    cur = torch.argmax(logits, dim=-1)
    for _ in range(steps):
        out.append(cur)
        lg, cache = decode_step(params, cur, cache, cfg, rope=rope, mm=mm)
        cur = torch.argmax(lg, dim=-1)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# ring-buffer decode for sliding-window models
# ---------------------------------------------------------------------------

def ring_decode_step(params: dict, token: torch.Tensor, cache: dict,
                     cfg: TransformerConfig, mm=None
                     ) -> tuple[torch.Tensor, dict]:
    """One decode step over the ring cache; cache['length'] is the
    absolute position (it keeps growing past the cache rows). RoPE phases
    come from the absolute position, so no O(total-length) table exists:
    :func:`chunk_step`'s Q=1 case without a rope table."""
    if cfg.attn_window is None:
        raise ValueError("ring decode requires cfg.attn_window")
    R = cache_max_seq(cache)
    if R < cfg.attn_window:
        # a wrap would overwrite an in-band key and the mask would still
        # report the stale row as live
        raise ValueError(f"ring cache rows {R} < attn_window "
                         f"{cfg.attn_window}")
    return chunk_step(params, token[:, None], cache, cfg, mm=mm,
                      logit_pos=0)


def ring_generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
                  steps: int, rows: int | None = None, mm=None
                  ) -> torch.Tensor:
    """Greedy decode for a sliding-window model with bounded memory: the
    cache holds ``rows`` = 128-rounded max(prompt, window) rows whatever
    ``steps`` is. The attended key set equals the full-cache banded
    decode's at every step. Returns (B, steps) token ids."""
    B, P = prompt.shape
    if cfg.attn_window is None:
        raise ValueError("ring_generate requires cfg.attn_window")
    R = rows or -(-max(P, cfg.attn_window) // 128) * 128
    if R < P or R < cfg.attn_window:
        raise ValueError(f"rows {R} must cover prompt {P} and window "
                         f"{cfg.attn_window}")
    cache = init_cache(cfg, B, R, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache, mm=mm)
    cur = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(steps):
        out.append(cur)
        lg, cache = ring_decode_step(params, cur, cache, cfg, mm=mm)
        cur = torch.argmax(lg, dim=-1)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# block-paged pool
# ---------------------------------------------------------------------------

def check_paged_config(cfg: TransformerConfig, mesh=None,
                       kv_codec: str = "bf16") -> None:
    """Fail fast on configs the paged engine cannot serve (the engine
    calls this at construction so the error names the knob). The pool's
    codec is the engine's knob: ``cfg.kv_int8`` is the slot cache's
    layout and is refused here, as in the reference. A serving mesh
    must be tiled by the model (``parallel/mesh.check_serving_mesh``)."""
    if kv_codec not in consts.KV_CODECS:
        raise ValueError(f"kv_codec {kv_codec!r} not in {consts.KV_CODECS}")
    if cfg.kv_int8:
        raise ValueError(consts.ERR_KV_CODEC_MISMATCH_FMT.format(
            pool=kv_codec, cache="int8 (cfg.kv_int8)"))
    if cfg.attn_window is not None:
        raise ValueError(
            "windowed models already serve from the O(window) ring cache "
            "(ServingEngine ring_rows); the paged pool would re-reserve "
            "rows the window is designed to drop")
    if cfg.ragged_decode:
        raise ValueError(
            "cfg.ragged_decode routes the SLOT engine's reads; the paged "
            "engine picks its kernel via attn_impl — unset the flag")
    if mesh is not None:
        from tpushare_torch.workloads.parallel.mesh import check_serving_mesh
        check_serving_mesh(cfg, mesh)


def init_page_pool(cfg: TransformerConfig, n_pages: int, page_size: int,
                   kv_codec: str = "bf16",
                   device: str | torch.device = "cuda") -> dict:
    """Zeroed block-paged K/V pool, ``(L, n_pages, page_size, Hkv, hd)``
    each for K and V: in the model dtype, or with ``kv_codec="int8"`` as
    codec leaves ``{"q": int8 pages, "s": fp32 (L, n_pages, page_size,
    Hkv) scale planes initialised to 1}`` — about half the bytes per
    page (``paging.kv_bytes_per_el``), quantized at page install and at
    every decode write, dequantized at every read."""
    check_paged_config(cfg, kv_codec=kv_codec)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads, cfg.head_dim)
    int8 = kv_codec == "int8"
    return {"k": _kv_zeros(cfg, shape, int8, dev),
            "v": _kv_zeros(cfg, shape, int8, dev)}


def pool_page_size(pool_leaf) -> int:
    """Rows per page of a pool leaf (stacked or one layer, dense or
    codec)."""
    return kv_data(pool_leaf).shape[-3]


def scatter_scratch_pages(pool, scratch: torch.Tensor,
                          page_ids: torch.Tensor, skip_pages: int = 0):
    """The scratch -> pool page-install rule for one side (K or V), in
    place: scratch rows ``[skip_pages*ps, (skip_pages+n)*ps)`` land
    page-wise at ``pool[:, page_ids]``, quantized on install for an int8
    pool (the same codec as every decode write)."""
    ps = pool_page_size(pool)
    n_used = page_ids.shape[0]
    rows = scratch[:, 0, skip_pages * ps:(skip_pages + n_used) * ps]
    chunk = rows.reshape(rows.shape[0], n_used, ps, *rows.shape[2:])
    return kv_store(pool, (slice(None), page_ids), chunk)


def gather_pool_pages(scratch, pool, page_ids: torch.Tensor):
    """The pool -> scratch prefix-gather rule for one side (K or V), in
    place: ``pool[:, page_ids]`` lands (dequantized for an int8 pool) at
    the head of a contiguous dense scratch — the inverse of
    :func:`scatter_scratch_pages`."""
    n = page_ids.shape[0]
    ps = pool_page_size(pool)
    # (L, n, ps, Hkv, hd); a dense page round-trips fp32 exactly
    g = kv_dequantize(kv_view(pool, (slice(None), page_ids)))
    rows = g.reshape(g.shape[0], n * ps, *g.shape[3:])
    scratch[:, 0, :n * ps] = rows.to(scratch.dtype)
    return scratch


def load_pool_pages(sk, sv, kp, vp, page_ids: torch.Tensor):
    """Gather pool pages into the head of a contiguous prefill scratch,
    in place: ``pool[:, page_ids]`` lands at scratch rows ``[0, n *
    page_size)`` — how a shared-prefix subscriber's admission scratch
    acquires the registered prefix's K/V without recomputing it. sk/sv
    are ``(L, 1, R, Hkv, hd)`` dense scratches, kp/vp the stacked pools,
    dense or codec (gathered pages dequantize into the scratch: the
    suffix chunks attend over the prefix as the decode read serves it).
    Rows past the prefix inside its tail page carry the registration
    scratch's zeros, masked and then overwritten by the suffix chunks."""
    return (gather_pool_pages(sk, kp, page_ids),
            gather_pool_pages(sv, vp, page_ids))


def copy_pool_page(kp, vp, src: int, dst: int):
    """Copy one page's K/V across every layer, in place: ``pool[:, dst]
    = pool[:, src]`` — the device half of copy-on-write. A codec page
    copies its ``q`` and ``s`` planes byte for byte, never requantized.
    The engine queues this before the block-table row that points at
    ``dst``, on the same stream, so no reader sees a half-copied page."""
    for plane in kv_planes(kp) + kv_planes(vp):
        plane[:, dst] = plane[:, src]
    return kp, vp


def extract_request_pages(kp, vp, page_ids: torch.Tensor):
    """Gather one request's (or one pinned prefix's) pages out of a
    pool, byte for byte: ``pool[:, page_ids]`` across every layer, K and
    V — the read half of the cross-pool handoff. A codec leaf gathers
    its ``q`` and ``s`` planes together and is never dequantized. The
    source pool is only read."""
    def grab(leaf):
        if isinstance(leaf, dict):
            return {"q": leaf["q"][:, page_ids], "s": leaf["s"][:, page_ids]}
        return leaf[:, page_ids]
    return grab(kp), grab(vp)


def install_request_pages(kp, vp, pk, pv, page_ids: torch.Tensor):
    """Scatter extracted pages into another pool's reserved ``page_ids``,
    in place: ``pool[:, page_ids] = pages`` — the write half of the
    handoff, ``q`` and ``s`` planes together, nothing requantized. The
    pages may come from another device (the wire lands them on the
    host): every plane is on the pool's device, and every shape and
    dtype checked, before the first byte is written, so a layout
    mismatch raises, and an out-of-memory in the copy leaves the pool
    as it was."""
    for dst, src in stage_request_pages(kp, vp, pk, pv, page_ids):
        dst[:, page_ids] = src
    return kp, vp


def stage_request_pages(kp, vp, pk, pv, page_ids: torch.Tensor) -> list:
    """The checks and staging of :func:`install_request_pages`: every
    extracted plane checked against its pool plane and copied onto the
    pool's device, nothing written. Returns (pool plane, staged pages)
    pairs."""
    pairs = []
    for pool, pages in ((kp, pk), (vp, pv)):
        if isinstance(pool, dict) != isinstance(pages, dict):
            raise ValueError("handoff pages and pool differ in codec")
        for dst, src in zip(kv_planes(pool), kv_planes(pages)):
            want = (dst.shape[0], page_ids.shape[0], *dst.shape[2:])
            if tuple(src.shape) != want or src.dtype != dst.dtype:
                raise ValueError(
                    f"handoff pages {tuple(src.shape)} {src.dtype} do not "
                    f"fit the pool's {want} {dst.dtype}")
            pairs.append((dst, src.to(dst.device)))
    return pairs


def make_paged_attn_core(kp, vp, tables: torch.Tensor, lengths: torch.Tensor,
                         cfg: TransformerConfig, impl: str = "xla",
                         gather_pages_w: int | None = None):
    """Per-layer attention closure for the paged serving step: write the
    step's K/V row into each lane's current page (block-table indirect,
    in place, quantized for an int8 pool — retired lanes' all-zero
    tables route their dead-lane writes into the reserved trash page 0),
    then read through :func:`ops.paged_attention.paged_attention_read`
    (the CUDA kernel or the gather twin; ``impl`` resolved at engine
    construction, the codec taken from the leaf type).

    ``gather_pages_w`` bounds the read to the first W table slots (the
    engine's power-of-two rung over the longest live lane); rows past a
    lane's length are masked either way."""
    ps = pool_page_size(kp)
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    rtables = tables if gather_pages_w is None \
        else tables[:, :gather_pages_w]
    page_ids = tables[rows, lengths // ps]
    offs = lengths % ps

    def attn_core(q, k, v):
        kv_store(kp, (page_ids, offs), k[:, 0])
        kv_store(vp, (page_ids, offs), v[:, 0])
        o = paged_attention_read(q, kp, vp, rtables, lengths + 1, cfg,
                                 impl=impl)
        return o, (kp, vp)

    return attn_core


def make_paged_chunk_core(kp, vp, tables: torch.Tensor, lengths: torch.Tensor,
                          cfg: TransformerConfig,
                          gather_pages_w: int | None = None):
    """Per-layer attention closure for a multi-token paged step — the
    block-table twin of the Q > 1 case of :func:`make_cached_attn_core`,
    serving the speculative verify (a lane's k+1 candidates in one
    dispatch) and the draft mirror's teacher-forced ingest. Each lane's
    Q tokens land at ``lengths[b] .. lengths[b] + Q - 1`` (block-table
    scatter, in place, quantized for an int8 pool by the same
    ``kv_store`` as every other pool write), and each query attends over
    the lane's pages up to its own position: the gathered fp32 view and
    the dense causal range test, op for op the reference's.

    The read is the plain gather, as in the reference (whose Pallas
    paged kernel is a Q = 1 walker): no kernel, no registry decision.
    The caller guarantees every active lane's table covers ``lengths +
    Q`` rows; inactive lanes' zeroed tables send their writes to the
    trash page."""
    from tpushare_torch.workloads.ops.paged_attention import _gather_dequant
    ps = pool_page_size(kp)
    hd = cfg.head_dim
    G = cfg.n_heads // cfg.kv_heads
    rtables = tables if gather_pages_w is None \
        else tables[:, :gather_pages_w]

    def positions(Q):
        return lengths[:, None] + torch.arange(Q, device=lengths.device)

    def write(cache, new):
        pos = positions(new.shape[1])                          # (B, Q)
        page_ids = torch.gather(tables, 1, (pos // ps).long())
        return kv_store(cache, (page_ids, pos % ps), new)

    def attn_core(q, k, v):
        B, Q = q.shape[:2]
        write(kp, k)
        write(vp, v)
        kmat = _gather_dequant(kp, rtables)        # (B, R, Hkv, hd) fp32
        vmat = _gather_dequant(vp, rtables)
        R = kmat.shape[1]
        qpos = positions(Q)[:, :, None]                        # (B, Q, 1)
        mask = torch.arange(R, device=q.device)[None, None, :] <= qpos
        qg = q.float().reshape(B, Q, cfg.kv_heads, G, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
        s = torch.where(mask[:, None, None, :, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
        return o.reshape(B, Q, cfg.n_heads, hd).to(q.dtype), (kp, vp)

    return attn_core


def spec_draft_scan(dparams: dict, dstate: dict, tokens: torch.Tensor,
                    active: torch.Tensor, dcfg: TransformerConfig, rope_d,
                    k: int, gather_pages_w: int | None = None):
    """The draft phase of a batched paged speculative round: ``k``
    greedy single-token steps of the draft model over its block-table
    mirror, always through the plain gather read (the paged kernel is
    the target's decode walker). Writes the draft pool in place; the
    draft lengths are left for the round to set. Returns (drafts (B, k),
    the draft K pool, the draft V pool); inactive lanes' tokens and
    lengths stay frozen and their writes ride the zeroed tables into the
    trash page."""
    tok, dlen = tokens, dstate["lengths"]
    drafts = []
    for _ in range(k):
        cos = rope_d[0][dlen][:, None]
        sin = rope_d[1][dlen][:, None]
        x = embed_lookup(dparams["embed"], tok, dcfg.dtype)[:, None]
        for i in range(dcfg.n_layers):
            core = make_paged_attn_core(kv_view(dstate["k"], i),
                                        kv_view(dstate["v"], i),
                                        dstate["tables"], dlen, dcfg,
                                        impl="xla",
                                        gather_pages_w=gather_pages_w)
            x, _ = model_layer(x, layer_params(dparams, i), dcfg, cos, sin,
                               core)
        nxt = torch.argmax(lm_head(dparams, x[:, 0]), dim=-1)
        tok = torch.where(active, nxt, tok)
        drafts.append(tok)
        dlen = torch.where(active, dlen + 1, dlen)
    return torch.stack(drafts, dim=1), dstate["k"], dstate["v"]
