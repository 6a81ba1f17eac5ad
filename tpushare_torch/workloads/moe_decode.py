"""KV-cache decoding for the MoE transformer — the port of
``tpushare/workloads/moe_decode.py``.

The same cache discipline as ``decode.py`` (a fixed (L, B, S, Hkv, hd)
cache written in place), with the SwiGLU replaced by the routed
experts. Prefill routes the prompt at the max_seq-sized capacity
(``cfg.expert_capacity``, the batch forward's numerics); each decode
step routes one token per row through ``decode.model_layer`` at
``capacity_for(1)``. A decoded token therefore never competes for
capacity with earlier tokens, where the batch forward may drop it: the
two agree exactly when the forward dropped nothing (the reference's
note).
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.decode import (cache_fill, decode_step, kv_view,
                                             run_generate)
from tpushare_torch.workloads.models.moe import MoEConfig, moe_layer_block
from tpushare_torch.workloads.models.transformer import (
    attention, embed_lookup, layer_params, lm_head, rope_tables)


def moe_prefill(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the (B, P) prompt through the model, filling cache[:, :, :P]
    in place. Returns (last-position logits (B, vocab) fp32, cache). On
    the card the attention is the flash forward (K1)."""
    P = tokens.shape[1]
    cos, sin = rope_tables(cfg, P, tokens.device)

    def attn_core(q, k, v):
        return attention(q, k, v, cfg), (k, v)

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        x, (_, (k, v)) = moe_layer_block(x, layer_params(params, i), cfg,
                                         cos, sin, attn_core)
        cache_fill(kv_view(cache["k"], i), k)
        cache_fill(kv_view(cache["v"], i), v)
    return lm_head(params, x[:, -1]), {**cache, "length": P}


def moe_decode_step(params: dict, token: torch.Tensor, cache: dict,
                    cfg: MoEConfig, rope=None) -> tuple[torch.Tensor, dict]:
    """One token (B,) at position cache['length'] -> (logits, cache):
    ``decode.decode_step``, whose ``model_layer`` routes the experts at
    ``capacity_for(1)``. Kept as a named entry point beside
    :func:`moe_prefill`."""
    return decode_step(params, token, cache, cfg, rope=rope)


def moe_generate(params: dict, prompt: torch.Tensor, cfg: MoEConfig,
                 steps: int, max_seq: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 generator: torch.Generator | None = None,
                 top_p: float = 0.0) -> torch.Tensor:
    """Decode ``steps`` tokens after the (B, P) prompt through the MoE
    model — greedy by default, sampling with a ``generator``."""
    return run_generate(
        moe_prefill,
        lambda p, t, c, cf, rope: moe_decode_step(p, t, c, cf, rope=rope),
        params, prompt, cfg, steps, max_seq, temperature, top_k, generator,
        top_p)
