"""The rowwise int8 KV codec — the port of the codec half of
``tpushare/workloads/quant.py`` (``rowwise_absmax_encode`` /
``rowwise_absmax_decode``).

One definition shared by the slot cache (``cfg.kv_int8``) and the int8
page pool (``kv_codec="int8"``) through ``decode.kv_quantize`` /
``decode.kv_dequantize``: each row of the last axis keeps one fp32 scale,
``s = absmax / 127``, and its values as ``q = round(x / s)`` in int8, so
``x ≈ q * s``. Zero rows get ``s = 1`` (q is 0 there), which keeps the
division finite. ``torch.round`` rounds half to even, as ``jnp.round``
does.

Weight quantization (``quantize``, ``qmm``, ``quantize_params``, ...)
is not ported yet (ROADMAP A.7).
"""

from __future__ import annotations

import torch


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
