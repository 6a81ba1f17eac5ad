"""Ragged decode attention: the CUDA kernel's wrapper and its twin.

Port of ``tpushare/workloads/ops/ragged_decode.py``. The slot engine's
caches are allocated at ``max_seq`` rows per slot, but a slot's live
sequence is usually far shorter, and decode is bandwidth-bound: the
dense cached attention (``decode.make_cached_attn_core``) masks the dead
rows but still reads them. This read scales with each slot's live
length instead.

- ``ragged_decode_attention`` wraps ``kernels/ragged_decode.cu``, the
  Hopper counterpart of the reference's Pallas ``_kernel``: its row loop
  stops at each slot's length, so dead rows are never loaded and the
  result does not depend on the allocated S.
- ``ragged_decode_plain`` is the twin, the per-row branch of the
  reference's ``make_cached_attn_core`` op for op — what CPU tensors
  get.

A stacked ``(L, B, S, Hkv, hd)`` cache is read at ``layer`` through the
contiguous view ``k[layer]``: the kernel is handed the view's pointer, so
no slice is copied (the reference had to thread the stacked cache through
its scan carry to get the same).
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _layer_views(k, v, layer):
    return (k, v) if layer is None else (k[layer], v[layer])


def ragged_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, *,
                        layer: int | None = None) -> torch.Tensor:
    """The twin: fp32 grouped einsums, the dot scaled by hd^-0.5 after
    it, rows past ``lengths[b]`` masked at -1e30, fp32 softmax, output in
    q's dtype. Arguments as :func:`ragged_decode_attention`."""
    k, v = _layer_views(k, v, layer)
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, 1, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (hd ** -0.5)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= lengths[:, None, None])                          # (B, 1, S)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            layer: int | None = None) -> torch.Tensor:
    """Single-token cached attention with per-slot live lengths.

    q (B, H, hd) is each slot's query at its current position; k/v are
    (B, S, Hkv, hd) caches, or with ``layer`` the full stacked
    (L, B, S, Hkv, hd) caches of which ``k[layer]`` is read; lengths (B,)
    int32 — slot b attends rows [0, lengths[b]] inclusive (the current
    token's K/V is already written at ``lengths[b]``). Returns (B, H, hd)
    in q's dtype.

    A CUDA tensor launches the kernel; what it cannot take raises. A CPU
    tensor gets :func:`ragged_decode_plain`."""
    if q.device.type == "cpu":
        return ragged_decode_plain(q, k, v, lengths, layer=layer)
    k, v = _layer_views(k, v, layer)
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k must be (B={B}, S, Hkv, {hd}) (one layer), "
                         f"got {tuple(k.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous() or t.shape != (B, S, Hkv, hd):
            raise ValueError(f"{name} must be a contiguous (B, S, Hkv, {hd}) "
                             "cache (or a stacked cache with layer=)")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.shape != (B,):
        raise ValueError("lengths must be (B,) int32 on q's device")
    if not q.is_contiguous() or not lengths.is_contiguous():
        raise ValueError("q and lengths must be contiguous")
    if (hd != KERNEL_HEAD_DIM or q.dtype not in KERNEL_DTYPES
            or H % Hkv or H // Hkv not in KERNEL_GROUPS):
        raise ValueError(f"ragged kernel takes head_dim {KERNEL_HEAD_DIM}, "
                         f"dtype in {KERNEL_DTYPES} and query groups in "
                         f"{KERNEL_GROUPS}, got {hd} / {q.dtype} / "
                         f"{H}:{Hkv}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (vector loads)")
    out = torch.empty_like(q)
    lib = build.library("ragged_decode")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_ragged_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, hd,
            int(q.dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "ragged_decode", rc)
    build.LAUNCHES["ragged_decode"] += 1
    return out
