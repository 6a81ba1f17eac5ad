"""Beam search over the KV-cache decode path — the port of
``tpushare/workloads/beam.py``.

The ``W`` beams are the batch dimension of one shared cache. Each step
scores every (beam, token) candidate, keeps the ``W`` best of the
flattened (W, V) table (``torch.topk``, as ``lax.top_k``) and reorders
the cache and the output buffers by the surviving parents — a per-step
copy of the cache, the price beam search pays for quality. The first
expansion is seeded from the prefill logits (every beam's first token
comes from the one real prefix); lanes beyond the vocabulary stay at
-inf. ``W = 1`` is greedy decode; with ``W >= vocab`` and ``steps <= 2``
the search is exhaustive. A fixed step count, no eos early exit, as in
the reference.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.decode import decode_step, init_cache, prefill
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, rope_tables)

__all__ = ["beam_search"]


def _map_planes(leaf, fn):
    """Apply ``fn`` to a cache leaf's tensor, or to both planes of a
    codec leaf."""
    if isinstance(leaf, dict):
        return {name: fn(plane) for name, plane in leaf.items()}
    return fn(leaf)


def beam_search(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
                steps: int, beam_width: int = 4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Search ``steps`` tokens after a (1, P) prompt with ``beam_width``
    beams. Returns ((1, steps) best sequence, its total logprob as a 0-d
    fp32 tensor)."""
    B, P = prompt.shape
    if B != 1:
        raise ValueError("beam_search expands one prompt into W beams; "
                         "batch it at the caller")
    W = beam_width
    if W < 1:
        raise ValueError(f"beam_width {W} must be >= 1")
    if steps < 1:
        raise ValueError(f"steps {steps} must be >= 1")
    dev = prompt.device
    S = -(-(P + steps) // 128) * 128
    cache = init_cache(cfg, 1, S, device=dev)
    logits, cache = prefill(params, prompt, cfg, cache)
    logp0 = torch.log_softmax(logits.float(), dim=-1)[0]
    # broadcast the single prefill across the W beam lanes
    cache = {"k": _map_planes(cache["k"],
                              lambda x: x.repeat_interleave(W, dim=1)),
             "v": _map_planes(cache["v"],
                              lambda x: x.repeat_interleave(W, dim=1)),
             "length": cache["length"]}
    top0, tok0 = torch.topk(logp0, min(W, logp0.shape[-1]))
    scores = torch.full((W,), -torch.inf, dtype=torch.float32, device=dev)
    scores[:top0.shape[0]] = top0
    tokens = torch.zeros((W,), dtype=torch.int64, device=dev)
    tokens[:tok0.shape[0]] = tok0
    out = torch.zeros((W, steps), dtype=torch.int64, device=dev)
    out[:, 0] = tokens
    rope = rope_tables(cfg, S, dev)
    V = cfg.vocab
    for n in range(1, steps):
        logits, cache = decode_step(params, tokens, cache, cfg, rope=rope)
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = (scores[:, None] + logp).reshape(-1)            # (W * V,)
        scores, flat = torch.topk(cand, W)
        parent = flat // V
        tokens = flat % V
        # reorder every per-beam buffer by the surviving parents
        cache = {"k": _map_planes(cache["k"], lambda x: x[:, parent]),
                 "v": _map_planes(cache["v"], lambda x: x[:, parent]),
                 "length": cache["length"]}
        out = out[parent]
        out[:, n] = tokens
    best = torch.argmax(scores)
    return out[best][None, :], scores[best]
