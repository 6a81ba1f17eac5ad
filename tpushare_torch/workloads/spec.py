"""Speculative decoding — the port of ``tpushare/workloads/spec.py``:
draft k tokens cheaply, verify them in one chunk.

Greedy speculative decoding is exact: the emitted tokens equal the
target model's plain greedy decode whatever the draft model is; the
draft only sets the speed. Each round the draft decodes ``k`` tokens
serially, then the target scores all k+1 positions in one cached
``decode.chunk_step``. The longest prefix of draft tokens matching the
target's greedy choices is accepted, plus the target's own next token.

Bookkeeping (round start): both caches hold K/V for every emitted
position < L, and ``cur`` (the token at L) is not cached yet.
Acceptance is capped at k-1 so the draft cache — which wrote K/V for
[cur, d1..d_{k-1}] at L..L+k-1 — always covers the accepted prefix; the
rewind is setting both lengths, and rows past them are overwritten
before any read can see them.

The reference runs :func:`spec_generate` as one ``lax.while_loop`` with
a fixed-size emit buffer; the port runs the same rounds as a host loop
over ``chunk_step`` (one device read per round: the accepted count
decides the next round), writing the caches in place, with the same
buffer and the same cap.

"Exact" means exact against the chunked evaluation of the target: in
bf16 the chunk and the single-step reads reduce in different orders, so
a near-tie argmax may break differently than ``generate``'s. Token
identity is asserted in f32.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.decode import (
    chunk_step, decode_step, init_cache, prefill, slot_view)
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, rope_tables)

__all__ = ["spec_generate", "spec_slot_round"]


def _accept(drafts: torch.Tensor, g: torch.Tensor, k: int):
    """Raw matches of the longest draft prefix the target agrees with,
    and the accepted count capped at k-1 (see the module doc)."""
    ok = (drafts == g[..., :k]).to(torch.int32)
    acc = torch.cumprod(ok, dim=-1).sum(dim=-1)
    return acc, torch.clamp(acc, max=k - 1)


def spec_generate(params_t: dict, params_d: dict, prompt: torch.Tensor,
                  cfg_t: TransformerConfig, cfg_d: TransformerConfig,
                  steps: int, k: int = 4) -> tuple[torch.Tensor, dict]:
    """Greedy speculative decode of ``steps`` tokens after a (1, P)
    prompt. Returns ((1, steps) tokens — identical to
    ``decode.generate(params_t, ...)`` in f32 — and stats {rounds,
    drafted, accepted, accepted_capped}: ``accepted`` counts raw draft
    matches (a perfect draft scores 1.0), ``accepted_capped`` the tokens
    emitted from the draft, at most (k-1)/k of drafted).

    ``k`` is the draft length per round (k >= 2 to be useful: at k = 1
    every round emits one token and the draft is pure overhead)."""
    B, P = prompt.shape
    if B != 1:
        raise ValueError("spec_generate is the batch=1 latency path; "
                         "batch serving belongs to ServingEngine")
    if k < 1:
        raise ValueError(f"draft length k={k} must be >= 1")
    dev = prompt.device
    # headroom: a round may write k+1 cache rows past the final kept token
    S = -(-(P + steps + k + 1) // 128) * 128
    tcache = init_cache(cfg_t, 1, S, device=dev)
    dcache = init_cache(cfg_d, 1, S, device=dev)
    t_logits, tcache = prefill(params_t, prompt, cfg_t, tcache)
    _, dcache = prefill(params_d, prompt, cfg_d, dcache)
    cur = torch.argmax(t_logits, dim=-1)                       # (1,)
    rope_t = rope_tables(cfg_t, S, dev)
    rope_d = rope_tables(cfg_d, S, dev)
    out = torch.zeros((steps + k + 1,), dtype=torch.int64, device=dev)
    out[0] = cur[0]
    n, rounds, accepted, emitted = 1, 0, 0, 0
    while n < steps:
        L = tcache["length"]
        tok, drafts = cur, []
        for _ in range(k):
            lg, dcache = decode_step(params_d, tok, dcache, cfg_d,
                                     rope=rope_d)
            tok = torch.argmax(lg, dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts)                             # (k,)
        chunk = torch.cat([cur, drafts])[None, :]              # (1, k+1)
        lg, tcache = chunk_step(params_t, chunk, tcache, cfg_t, rope=rope_t)
        g = torch.argmax(lg[0], dim=-1)                        # (k+1,)
        acc, a = _accept(drafts, g, k)
        out[n:n + k + 1] = g
        acc, a = int(acc), int(a)          # the round's one device read
        cur = g[a:a + 1]
        tcache = {**tcache, "length": L + a + 1}
        dcache = {**dcache, "length": L + a + 1}
        n, rounds = n + a + 1, rounds + 1
        accepted, emitted = accepted + acc, emitted + a
    stats = {"rounds": rounds, "drafted": rounds * k, "accepted": accepted,
             "accepted_capped": emitted}
    return out[:steps][None, :], stats


def spec_slot_round(params_t: dict, params_d: dict, slots: dict,
                    dslots: dict, slot: int, cfg_t: TransformerConfig,
                    cfg_d: TransformerConfig, k: int,
                    length: int | None = None):
    """One speculative round on a serving engine's slot: draft ``k``
    greedy tokens against the draft slot cache, verify all k+1 in one
    target chunk over the main slot cache, accept the matching prefix
    (capped at k-1, as :func:`spec_generate`) and rewind both lengths.
    Works on single-slot views of the engine's (L, n_slots, S, ...)
    caches, which the chunk steps write in place (no write-back), so the
    other slots are untouched; the caller guarantees ``slot`` is the
    only active one and has k+1 rows of headroom. ``length`` is the
    caller's host mirror of the slot's length (read from the device when
    None).

    Returns (cands (k+1,) — the target's greedy tokens, of which the
    first a+1 are emitted —, their logprobs (k+1,) fp32, a (0-d tensor,
    the accepted count), slots, dslots)."""
    L = int(slots["lengths"][slot]) if length is None else length
    cur = slots["tokens"][slot:slot + 1]                       # (1,)
    tc = {"k": slot_view(slots["k"], slot), "v": slot_view(slots["v"], slot),
          "length": L}
    dc = {"k": slot_view(dslots["k"], slot),
          "v": slot_view(dslots["v"], slot), "length": L}
    tok, drafts = cur, []
    for _ in range(k):
        # rope=None: per-position phases, no table
        lg, dc = chunk_step(params_d, tok[:, None], dc, cfg_d, logit_pos=0)
        tok = torch.argmax(lg, dim=-1)
        drafts.append(tok)
    drafts = torch.cat(drafts)                                 # (k,)
    chunk = torch.cat([cur, drafts])[None, :]                  # (1, k+1)
    lg, tc = chunk_step(params_t, chunk, tc, cfg_t)            # (1, k+1, V)
    g = torch.argmax(lg[0], dim=-1)                            # (k+1,)
    logp = torch.log_softmax(lg[0].float(), dim=-1)[
        torch.arange(k + 1, device=g.device), g]
    _, a = _accept(drafts, g, k)
    L2 = L + a + 1
    slots["lengths"][slot] = L2
    slots["tokens"][slot] = g[a]
    slots["logps"][slot] = logp[a]
    dslots["lengths"][slot] = L2
    dslots["tokens"][slot] = g[a]
    return g, logp, a, slots, dslots
