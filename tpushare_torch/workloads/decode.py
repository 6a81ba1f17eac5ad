"""KV-cache autoregressive decoding — the port of
``tpushare/workloads/decode.py``, dense bf16/fp32 caches only (no ring
cache, no int8 codec in this slice).

The reference keeps everything functional under ``jit``/``lax.scan``;
the port runs eagerly and writes caches and pools IN PLACE (a slice
assignment into the preallocated buffer instead of a fresh copy per
layer), which is what keeps a decode step's memory at the cache itself.
Functions still return the cache / pool they were given so call sites
read like the reference's.

All paths — batch forward, prefill, cached chunk steps and the paged
serving step — run ``transformer.layer_block``, the one definition of
the architecture.
"""

from __future__ import annotations

import torch

from tpushare_torch import consts
from tpushare_torch.device import resolve_device
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


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed KV cache: k/v (L, B, max_seq, Hkv, hd) in the model dtype,
    length 0 (a host int — eager positions are always concrete)."""
    if cfg.kv_int8:
        raise NotImplementedError("the int8 KV codec is not ported yet")
    dev = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, S, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "length": 0}


def cache_max_seq(cache: dict) -> int:
    return cache["k"].shape[2]


def cache_fill(kc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write (B, P, Hkv, hd) rows at the cache origin, in place."""
    kc[:, :new.shape[1]] = new.to(kc.dtype)
    return kc


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt (B, P) through the model, filling cache[:, :, :P].
    Returns (logits (B, vocab) fp32 at the last position, and the
    cache). Any P runs the flash kernel on the card: unlike the
    reference's Pallas grid, it needs no tiled prompt."""
    P = tokens.shape[1]
    cos, sin = rope_tables(cfg, P, tokens.device)

    def attn_core(q, k, v):
        return attention(q, k, v, cfg), (k, v)

    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, (k, v) = layer_block(x, layer_params(params, i), cfg, cos, sin,
                                attn_core)
        cache_fill(cache["k"][i], k)
        cache_fill(cache["v"][i], v)
    return lm_head(params, x[:, -1]), {**cache, "length": P}


def make_cached_attn_core(kc: torch.Tensor, vc: torch.Tensor, pos: int,
                          cfg: TransformerConfig, slot_ids: torch.Tensor):
    """Per-layer cached attention for a scalar position: write this
    chunk's Q tokens' K/V at rows pos..pos+Q-1 (in place), then attend
    over the whole static cache with grouped fp32 einsums, masking rows
    past each query's position at -1e30 — the reference's dense branch
    op for op. Returns attn_core(q, k, v) -> (o, (kc, vc))."""
    hd = cfg.head_dim
    G = cfg.n_heads // cfg.kv_heads

    def attn_core(q, k, v):
        B, Q = q.shape[:2]
        kc[:, pos:pos + Q] = k.to(kc.dtype)
        vc[:, pos:pos + Q] = v.to(vc.dtype)
        qpos = (pos + torch.arange(Q, device=q.device))[None, :, None]
        mask = slot_ids[None, None, :] <= qpos                  # (1, Q, S)
        qg = q.float().reshape(B, Q, kc.shape[2], G, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * (hd ** -0.5)
        s = torch.where(mask[:, None, None, :, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vc.float())
        return o.reshape(B, Q, cfg.n_heads, hd).to(q.dtype), (kc, vc)

    return attn_core


def chunk_step(params: dict, tokens: torch.Tensor, cache: dict,
               cfg: TransformerConfig, rope=None, logit_pos: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Cached multi-token step: write Q tokens' K/V at cache['length']
    and return logits at every position (B, Q, vocab) fp32 — or, with
    ``logit_pos`` (an in-chunk index), only there, (B, vocab).

    An overflowing write raises instead of clamping (slice assignment
    past the cache would corrupt nothing but also write nothing), and so
    does a position past a bounded rope table."""
    B, Q = tokens.shape
    max_seq = cache_max_seq(cache)
    pos = int(cache["length"])
    if pos + Q > max_seq:
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

    x = embed_lookup(params["embed"], tokens)                # (B, Q, D)
    slot_ids = torch.arange(max_seq, device=tokens.device)
    for i in range(cfg.n_layers):
        core = make_cached_attn_core(cache["k"][i], cache["v"][i], pos, cfg,
                                     slot_ids)
        x, _ = layer_block(x, layer_params(params, i), cfg, cos, sin, core)
    if logit_pos is not None:
        x = x[:, logit_pos]
    return lm_head(params, x), {**cache, "length": pos + Q}


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: TransformerConfig, rope=None
                ) -> tuple[torch.Tensor, dict]:
    """One token (B,) at position cache['length'] -> (logits, cache): the
    Q=1 case of :func:`chunk_step`."""
    return chunk_step(params, token[:, None], cache, cfg, rope=rope,
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
                     buckets: tuple[int, ...], max_seq: int) -> torch.Tensor:
    """Offline greedy decode with the serving engine's chunked-prefill
    semantics (same bucket layout, same pad widths, same per-chunk
    ``chunk_step``) — the exact oracle for engine tests. B must be 1."""
    B, plen = prompt.shape
    if B != 1:
        raise ValueError("chunked_generate mirrors one engine lane (B=1)")
    bs = tuple(sorted(b for b in buckets if b <= max_seq))
    if not bs:
        raise ValueError(f"no bucket <= max_seq {max_seq}")
    cache = init_cache(cfg, 1, max_seq, device=prompt.device)
    rope = rope_tables(cfg, max_seq, prompt.device)
    logits = None
    for start, piece, padded in prefill_chunk_layout(plen, bs):
        toks = prompt[:, start:start + piece]
        if padded > piece:
            toks = torch.nn.functional.pad(toks, (0, padded - piece))
        cache = {**cache, "length": start}
        logits, cache = chunk_step(params, toks, cache, cfg,
                                   logit_pos=piece - 1)
    cache = {**cache, "length": plen}
    out = []
    cur = torch.argmax(logits, dim=-1)
    for _ in range(steps):
        out.append(cur)
        lg, cache = decode_step(params, cur, cache, cfg, rope=rope)
        cur = torch.argmax(lg, dim=-1)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# block-paged pool
# ---------------------------------------------------------------------------

def check_paged_config(cfg: TransformerConfig) -> None:
    """Fail fast on configs the paged engine cannot serve. The pool
    stores the model dtype (the reference's "bf16" codec); the int8 page
    codec is a later slice."""
    if cfg.kv_int8:
        raise ValueError(consts.ERR_KV_CODEC_MISMATCH_FMT.format(
            pool="bf16", cache="int8 (cfg.kv_int8)"))
    if cfg.attn_window is not None:
        raise ValueError(
            "windowed models serve from the ring cache, not the paged "
            "pool (the ring cache is not ported yet)")
    if cfg.ragged_decode:
        raise ValueError(
            "cfg.ragged_decode routes the SLOT engine's reads; the paged "
            "engine picks its kernel via attn_impl — unset the flag")


def init_page_pool(cfg: TransformerConfig, n_pages: int, page_size: int,
                   device: str | torch.device = "cuda") -> dict:
    """Zeroed block-paged K/V pool, ``(L, n_pages, page_size, Hkv, hd)``
    each for K and V, in the model dtype."""
    check_paged_config(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def pool_page_size(pool_leaf: torch.Tensor) -> int:
    """Rows per page of a pool leaf (stacked or one layer)."""
    return pool_leaf.shape[-3]


def scatter_scratch_pages(pool: torch.Tensor, scratch: torch.Tensor,
                          page_ids: torch.Tensor,
                          skip_pages: int = 0) -> torch.Tensor:
    """The scratch -> pool page-install rule for one side (K or V), in
    place: scratch rows ``[skip_pages*ps, (skip_pages+n)*ps)`` land
    page-wise at ``pool[:, page_ids]``."""
    ps = pool_page_size(pool)
    n_used = page_ids.shape[0]
    rows = scratch[:, 0, skip_pages * ps:(skip_pages + n_used) * ps]
    chunk = rows.reshape(rows.shape[0], n_used, ps, *rows.shape[2:])
    pool[:, page_ids] = chunk.to(pool.dtype)
    return pool


def make_paged_attn_core(kp: torch.Tensor, vp: torch.Tensor,
                         tables: torch.Tensor, lengths: torch.Tensor,
                         cfg: TransformerConfig, impl: str = "xla",
                         gather_pages_w: int | None = None):
    """Per-layer attention closure for the paged serving step: write the
    step's K/V row into each lane's current page (block-table indirect,
    in place — retired lanes' all-zero tables route their dead-lane
    writes into the reserved trash page 0), then read through
    :func:`ops.paged_attention.paged_attention_read` (the CUDA kernel or
    the gather twin; ``impl`` resolved at engine construction).

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
        kp[page_ids, offs] = k[:, 0].to(kp.dtype)
        vp[page_ids, offs] = v[:, 0].to(vp.dtype)
        o = paged_attention_read(q, kp, vp, rtables, lengths + 1, cfg,
                                 impl=impl)
        return o, (kp, vp)

    return attn_core
