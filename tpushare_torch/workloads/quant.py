"""Int8 storage — the port of ``tpushare/workloads/quant.py``: the rowwise
KV codec and int8 weight-only quantization.

The rowwise codec (``rowwise_absmax_encode`` / ``rowwise_absmax_decode``)
is shared by the slot cache (``cfg.kv_int8``) and the int8 page pool
(``kv_codec="int8"``) through ``decode.kv_quantize`` /
``decode.kv_dequantize``: each row of the last axis keeps one fp32 scale,
``s = absmax / 127``, and its values as ``q = round(x / s)`` in int8, so
``x ≈ q * s``. Zero rows get ``s = 1`` (q is 0 there), which keeps the
division finite. ``torch.round`` rounds half to even, as ``jnp.round``
does.

Weights: ``quantize_params`` turns the dense parameter dict into a
mirror whose matmul leaves are ``{"q": int8, "s": fp32}`` — one scale per
output channel (per layer for the stacked ``(L, D, N)`` leaves), per row
for the embedding table — and the norm scales stay in the model dtype.
There is no quantized copy of the model: ``transformer.layer_block``,
``forward``, ``lm_head``, ``embed_lookup`` and the decode and serving
paths run that mirror through their ``mm`` hook with :func:`qmm`.

:func:`qmm` is ``(x @ q.to(x.dtype)) * s`` with the product accumulated
and kept in fp32 until after the rescale, as the reference asks of XLA
(``preferred_element_type=f32``): rounding the product to bf16 first
loses its low bits on near-cancelling dots. On the card the product is
one cuBLAS call with bf16 operands and an fp32 output; on the CPU it is
the fp32 product of the bf16-cast operands, which is the same sum.
The conversion is eager, so each call writes and reads a bf16 copy of
the weight on the card (XLA fuses it into the operand load); a fused
dequantizing read is a performance item of ROADMAP.md. As an autograd
function :func:`qmm` saves the int8 leaf and its scales, never that
bf16 copy, so a frozen int8 base (QLoRA, ``workloads/lora.py``) keeps
its int8 footprint through the backward: ``dx = (dy * s) @ q^T``, in
fp32, the transpose JAX derives for the same product.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         param_count)

__all__ = [
    "rowwise_absmax_encode", "rowwise_absmax_decode",
    "quantize", "quantize_rows", "quantize_params", "dequantize_params",
    "qmm", "quantized_param_bytes", "qprefill", "qdecode_step", "qgenerate",
]


def rowwise_absmax_encode(x: torch.Tensor) -> dict:
    """x (..., n) -> {"q": int8 (..., n), "s": fp32 (...)}."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / s[..., None]).to(torch.int8)
    return {"q": q, "s": s}


def rowwise_absmax_decode(q: torch.Tensor, s: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse up to rounding: ``q * s`` with the scale broadcast
    over the last axis, in fp32, then cast to ``dtype``."""
    return (q.float() * s[..., None]).to(dtype)


def quantize(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8, ``w ≈ q * s``: the scales
    reduce over the in-dim (axis -2) only, so a stacked (L, D, N) weight
    keeps one scale set per layer, (L, 1, N). Zero channels get scale 1."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return {"q": torch.round(wf / s).to(torch.int8), "s": s}


def quantize_rows(w: torch.Tensor) -> dict:
    """Per-row symmetric int8 for gather-only tables (the embedding): one
    scale per vocab row, (V, 1) — the rowwise codec with the scale kept
    as a column."""
    enc = rowwise_absmax_encode(w)
    return {"q": enc["q"], "s": enc["s"][..., None]}


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result: on the card one cuBLAS product of
    the bf16 operands as given (accumulated in fp32 and not rounded
    back), on the CPU — or for fp32 operands — the fp32 product."""
    if a.is_cuda and a.dtype != torch.float32:
        lead = a.shape[:-1]
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*lead, b.shape[-1])
    return a.float() @ b.float()


class _QMatmul(torch.autograd.Function):
    """x @ {q, s}: the fp32 product of x and q in x's dtype, rescaled in
    fp32 (in place on the fresh product), then one cast. Saves q and s,
    not the copy of q the product reads."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        y = _mm_f32(x, q.to(x.dtype))
        return y.mul_(s.reshape(1, -1)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        q, s = ctx.saved_tensors
        dx = (dy.float() * s.reshape(1, -1)) @ q.float().t()
        return dx.to(dy.dtype), None, None


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """The dequantizing matmul for the ``mm`` hook: a ``{q, s}`` leaf is
    read at int8 and rescaled per output channel; a plain tensor passes
    through to ``@``, so mixed parameter dicts work."""
    if not isinstance(w, dict):
        return x @ w
    return _QMatmul.apply(x, w["q"], w["s"])


QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_params(params: dict) -> dict:
    """Dense parameter dict (``transformer.init_params``) -> its int8
    mirror: matmul leaves and the output projection per output channel,
    the embedding per row, the norm scales as they are."""
    layers = dict(params["layers"])
    for name in QUANT_LEAVES:
        layers[name] = quantize(layers[name])
    return {"embed": quantize_rows(params["embed"]), "layers": layers,
            "norm_f": params["norm_f"], "out": quantize(params["out"])}


def dequantize_params(qparams: dict,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The inverse up to rounding: ``{q, s}`` leaves -> dense tensors of
    ``dtype`` (``q * s`` in fp32, then cast)."""
    def deq(leaf):
        return (leaf["q"].float() * leaf["s"]).to(dtype)

    layers = dict(qparams["layers"])
    for name in QUANT_LEAVES:
        layers[name] = deq(layers[name])
    return {"embed": deq(qparams["embed"]), "layers": layers,
            "norm_f": qparams["norm_f"], "out": deq(qparams["out"])}


def quantized_param_bytes(cfg: TransformerConfig) -> int:
    """Bytes of the int8 weights: 1 per quantized parameter, 4 per fp32
    scale, the norm scales at 2 (bf16) — the reference's count."""
    D, F_, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    KD = cfg.kv_dim
    # embed: one scale per vocab row; per layer wq/wo/w2 (3D) + wk/wv
    # (2KD) + w1/w3 (2F) output channels; the output projection's V
    n_scales = V + L * (3 * D + 2 * KD + 2 * F_) + V
    norm_params = L * 2 * D + D
    return param_count(cfg) - norm_params + norm_params * 2 + n_scales * 4


def qprefill(qparams: dict, tokens: torch.Tensor, cfg: TransformerConfig,
             cache: dict) -> tuple[torch.Tensor, dict]:
    """``decode.prefill`` over int8 weights (the same function, qmm
    hook)."""
    from tpushare_torch.workloads.decode import prefill
    return prefill(qparams, tokens, cfg, cache, mm=qmm)


def qdecode_step(qparams: dict, token: torch.Tensor, cache: dict,
                 cfg: TransformerConfig, rope=None
                 ) -> tuple[torch.Tensor, dict]:
    """``decode.decode_step`` over int8 weights."""
    from tpushare_torch.workloads.decode import decode_step
    return decode_step(qparams, token, cache, cfg, rope=rope, mm=qmm)


def qgenerate(qparams: dict, prompt: torch.Tensor, cfg: TransformerConfig,
              steps: int, max_seq: int | None = None,
              temperature: float = 0.0, top_k: int = 0,
              generator: torch.Generator | None = None,
              top_p: float = 0.0) -> torch.Tensor:
    """``decode.generate`` over int8 weights: prefill, then ``steps - 1``
    decode steps, the same sampling surface."""
    from tpushare_torch.workloads.decode import run_generate
    return run_generate(qprefill, qdecode_step, qparams, prompt, cfg, steps,
                        max_seq, temperature, top_k, generator, top_p)
