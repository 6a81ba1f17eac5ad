"""Splash attention, forward and backward: the CUDA kernels' wrappers,
the differentiable front door, and their plain twins.

Port of the reference's long-context prefill kernel:
``tpushare/workloads/ops/registry.py::_build_prefill_splash``'s
``splash_attn`` over the upstream ``make_splash_mha`` (block-sparse
causal MHA attention) and its ``custom_vjp``, whose backward runs the
upstream dQ and dK/dV kernels (non-fused: the reference sets
``block_q_dq`` / ``block_kv_dq``). The kernels live in
``kernels/splash_fwd.cu`` and ``kernels/splash_bwd.cu`` and walk the
causal mask's block schedules (``ops/splash_mask.py``).

- :func:`splash_attention` takes the model's ``(B, S, H, hd)`` q, k, v.
  It pre-scales q by ``hd**-0.5`` in q's dtype, outside the
  differentiable function, as the reference does (the scalar rounded to
  q's dtype first, as JAX rounds a weak-typed scalar): the rounding of
  ``q * scale`` is part of the result, and the scale's gradient flows
  through autograd. Without a gradient to take it launches the LSE-free
  forward; otherwise it goes through :class:`SplashAttention`, whose
  backward computes ``di = rowsum(o * dO)`` in fp32 in plain PyTorch
  (as upstream does outside Pallas) and launches the dK/dV and dQ
  kernels.
- :func:`splash_attention_plain` and :func:`splash_attention_bwd_plain`
  are the twins in the upstream algebra: masked scores at
  :data:`MASK_VALUE`, fp32 scores and softmax, output in q's dtype, LSE
  ``m + log l`` fp32 ``(B, H, S)``; in the backward ``p`` and ``ds`` are
  rounded to the input dtype before the dV, dK and dQ products, which
  accumulate in fp32. A CPU tensor gets the twins; a CUDA tensor gets
  the kernels or an error, never the twins.

The kernels take MHA only (one K/V head per query head), head_dim 128
or 256 (the reference's gate is ``head_dim % 128 == 0``), bf16 or fp32,
and S a multiple of 128; what they cannot take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpushare_torch.workloads.kernels import build
from tpushare_torch.workloads.ops import splash_mask
from tpushare_torch.workloads.ops.attention import (bwd_delta, check_stats,
                                                    cuda_stream)

KERNEL_HEAD_DIMS = (128, 256)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# upstream splash_attention_kernel.DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def prescale(q: torch.Tensor) -> torch.Tensor:
    """q * hd**-0.5 in q's dtype, the scalar rounded to that dtype first
    (the reference's ``q * scale`` on a weak-typed scalar)."""
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    return q * scale


def _scores(qs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 (B, H, S, S) scores of the pre-scaled q, causally masked at
    :data:`MASK_VALUE`."""
    S = qs.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    keep = torch.ones((S, S), dtype=torch.bool, device=qs.device).tril()
    return torch.where(keep, s, MASK_VALUE)


def splash_attention_plain(qs: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, with_lse: bool = False):
    """The forward twin on the pre-scaled q, (B, S, H, hd) each -> o in
    qs's dtype, or (o, lse) with ``with_lse``: fp32 masked scores and
    softmax, lse = m + log(l) fp32 (B, H, S)."""
    s = _scores(qs, k)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                     v.float()).to(qs.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if with_lse else o


def splash_attention_bwd_plain(qs, k, v, o, lse, do
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The backward twin: p = exp(s - lse), dp = dO v^T, ds = p (dp - di)
    with di = rowsum(o dO); dv = round(p)^T dO, dk = round(ds)^T qs,
    dq = round(ds) k, ``round`` to the input dtype, products in fp32.
    Returns (dqs, dk, dv) in qs's / k's / v's dtypes — dqs is the
    gradient of the pre-scaled q."""
    p = torch.exp(_scores(qs, k) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - bwd_delta(do, o)[..., None])
    p, ds = p.to(do.dtype).float(), ds.to(do.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _kernel_shape(qs, k, v, extra=()) -> tuple[int, int, int, int]:
    """Check what the kernels take; returns (B, S, H, hd)."""
    B, S, H, hd = qs.shape
    for name, t in (("q", qs), ("k", k), ("v", v), *extra):
        if t.device != qs.device or t.dtype != qs.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if t.shape != qs.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q's "
                             f"{tuple(qs.shape)} (splash is MHA only)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in KERNEL_HEAD_DIMS or qs.dtype not in KERNEL_DTYPES:
        raise ValueError(f"splash kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS} and dtype in {KERNEL_DTYPES}, "
                         f"got {hd} / {qs.dtype}")
    if S % splash_mask.MIN_BLOCK:
        raise ValueError(f"seq {S} does not tile the splash block grid "
                         f"(a multiple of {splash_mask.MIN_BLOCK})")
    return B, S, H, hd


def _schedule_args(sched: splash_mask.BlockSchedule) -> tuple:
    return (sched.offsets.data_ptr(), sched.blocks.data_ptr(),
            sched.kinds.data_ptr())


def splash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               with_lse: bool = False):
    """The splash forward on the pre-scaled q: o, or (o, lse) with
    ``with_lse``. A CUDA tensor launches the kernel; a CPU tensor gets
    :func:`splash_attention_plain`."""
    if qs.device.type == "cpu":
        return splash_attention_plain(qs, k, v, with_lse=with_lse)
    B, S, H, hd = _kernel_shape(qs, k, v)
    sched = splash_mask.fwd_schedule(S, qs.device)
    out = torch.empty_like(qs)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=qs.device)
           if with_lse else None)
    lib = build.library("splash_fwd")
    with torch.cuda.device(qs.device):
        rc = lib.tpushare_splash_fwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, *_schedule_args(sched),
            B, S, H, hd, sched.block, int(qs.dtype == torch.bfloat16),
            cuda_stream())
    build.check(lib, "splash_fwd", rc)
    build.LAUNCHES["splash_fwd"] += 1
    return (out, lse) if with_lse else out


def splash_bwd_dq(qs, k, v, do, lse, di) -> torch.Tensor:
    """dQ of the pre-scaled q through the dQ kernel (CUDA tensors; ``do``
    contiguous)."""
    B, S, H, hd = _kernel_shape(qs, k, v, extra=(("do", do),))
    check_stats(B, H, S, qs.device, lse=lse, di=di)
    sched = splash_mask.fwd_schedule(S, qs.device)
    dq = torch.empty_like(qs)
    lib = build.library("splash_bwd")
    with torch.cuda.device(qs.device):
        rc = lib.tpushare_splash_bwd_dq(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            *_schedule_args(sched), B, S, H, hd, sched.block,
            int(qs.dtype == torch.bfloat16), cuda_stream())
    build.check(lib, "splash_bwd_dq", rc)
    build.LAUNCHES["splash_bwd_dq"] += 1
    return dq


def splash_bwd_dkv(qs, k, v, do, lse, di
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) through the dK/dV kernel (CUDA tensors)."""
    B, S, H, hd = _kernel_shape(qs, k, v, extra=(("do", do),))
    check_stats(B, H, S, qs.device, lse=lse, di=di)
    sched = splash_mask.dkv_schedule(S, qs.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.library("splash_bwd")
    with torch.cuda.device(qs.device):
        rc = lib.tpushare_splash_bwd_dkv(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_schedule_args(sched), B, S, H, hd, sched.block,
            int(qs.dtype == torch.bfloat16), cuda_stream())
    build.check(lib, "splash_bwd_dkv", rc)
    build.LAUNCHES["splash_bwd_dkv"] += 1
    return dk, dv


def splash_attention_bwd(qs, k, v, o, lse, do
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dqs, dk, dv) from the forward's residuals: di in plain PyTorch,
    then the dK/dV and dQ kernels on a CUDA tensor;
    :func:`splash_attention_bwd_plain` on a CPU one."""
    if qs.device.type == "cpu":
        return splash_attention_bwd_plain(qs, k, v, o, lse, do)
    # autograd may hand a strided gradient; the kernels read dense rows
    do = do.contiguous()
    di = bwd_delta(do, o)
    dk, dv = splash_bwd_dkv(qs, k, v, do, lse, di)
    dq = splash_bwd_dq(qs, k, v, do, lse, di)
    return dq, dk, dv


class SplashAttention(torch.autograd.Function):
    """The counterpart of upstream splash's ``custom_vjp`` on the
    pre-scaled q: the forward saves (qs, k, v, o, lse), the backward runs
    the dK/dV and dQ kernels (their plain twin on a CPU tensor)."""

    @staticmethod
    def forward(ctx, qs, k, v):
        o, lse = splash_fwd(qs, k, v, with_lse=True)
        ctx.save_for_backward(qs, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return splash_attention_bwd(*ctx.saved_tensors, do)


def splash_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Differentiable causal splash attention on (B, S, H, hd) tensors,
    the reference's ``splash_attn``. A CUDA tensor runs the hand-written
    kernels; a CPU tensor the plain twins. Only a call that a gradient
    will flow through pays for the LSE output."""
    qs = prescale(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return SplashAttention.apply(qs, k, v)
    return splash_fwd(qs, k, v)
