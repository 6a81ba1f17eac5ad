"""Flash-attention forward: the CUDA kernel's wrapper and its plain twin.

Port of the forward half of ``tpushare/workloads/ops/attention.py``
(``flash_attention`` over ``_fwd_kernel``). The kernel lives in
``kernels/flash_fwd.cu``; ``flash_attention_plain`` computes the same
function in plain PyTorch — op for op the fp32 einsum branch of the
reference's ``transformer.attention`` — and is what CPU tensors get.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H, hd): fp32
    einsums, masked scores at -1e30, fp32 softmax, output in q's dtype.
    GQA repeats each K/V head over its query-head group."""
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hkv}")
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        if window is not None:
            ids = torch.arange(s, device=q.device)
            mask &= ids[None, :] > ids[:, None] - window
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Flash-attention forward on (B, S, H|Hkv, hd) tensors.

    A CUDA tensor launches the hand-written kernel (any S, GQA native,
    head_dim 64/128, bf16/fp32); what the kernel cannot take raises —
    nothing falls back. A CPU tensor gets :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if window is not None:
        raise NotImplementedError(
            "the flash kernel's sliding-window grid is not ported yet; "
            "call flash_attention_plain for windowed attention")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.shape != (B, S, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hkv}")
    if hd not in KERNEL_HEAD_DIMS or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and dtype in {KERNEL_DTYPES}, "
                         f"got {hd} / {q.dtype}")
    out = torch.empty_like(q)
    lib = build.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, hd, int(causal), int(q.dtype == torch.bfloat16),
            hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    build.check(lib, "flash_fwd", rc)
    build.LAUNCHES["flash_fwd"] += 1
    return out
