"""Paged-attention decode read: the CUDA kernel's wrapper and its twin.

Port of ``tpushare/workloads/ops/paged_attention.py``. The serving
engine stores K/V as a page pool ``(L, n_pages, page_size, Hkv, hd)``
with per-lane block tables; this module is the READ — attention of one
query token per lane over its block-table pages.

- ``paged_decode`` wraps ``kernels/paged_decode.cu``, the Hopper
  counterpart of the upstream Pallas paged kernel the reference runs on
  a TPU: it walks each lane's table in the kernel, so the bytes read
  scale with each lane's live rows.
- ``xla_paged_read`` gathers the lane's pages into a contiguous view and
  runs the reference's grouped-einsum attention op for op — the plain
  twin, what CPU tensors get, and the engine's "xla" path.

Both address each table slot independently, so tables whose entries
alias another lane's pages read correctly.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

PAGED_IMPLS = ("auto", "paged", "xla")
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def resolve_paged_impl(impl: str, platform: str) -> str:
    """Map the engine's ``attn_impl`` knob to "paged" or "xla" through
    the registry's decision table: ``auto`` degrades with a counted
    fallback event, an explicit ``paged`` the platform cannot run raises
    ``KernelUnavailable`` at engine construction."""
    if impl not in PAGED_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {PAGED_IMPLS}")
    from tpushare_torch.workloads.ops import registry
    chosen, reason = registry.decide(registry.KIND_PAGED, impl=impl,
                                     platform=platform)
    if impl == registry.IMPL_AUTO and chosen == registry.IMPL_XLA:
        registry.record_fallback(registry.IMPL_PAGED, reason)
    return chosen


def gather_pages(pool_layer: torch.Tensor,
                 tables: torch.Tensor) -> torch.Tensor:
    """Contiguous per-lane view of one layer's pool: ``(n_pages, ps,
    Hkv, hd)`` through ``(B, P)`` tables -> ``(B, P * ps, Hkv, hd)``.
    Rows past a lane's live length are garbage the caller masks."""
    B, P = tables.shape
    ps = pool_layer.shape[1]
    g = pool_layer[tables]                         # (B, P, ps, Hkv, hd)
    return g.reshape(B, P * ps, *pool_layer.shape[2:])


def xla_paged_read(q, kp, vp, tables, kv_lens, n_heads: int,
                   kv_heads: int) -> torch.Tensor:
    """The gather twin, op for op the reference's: q (B, Q, H, hd),
    grouped fp32 einsums, rows >= kv_lens masked at -1e30, fp32 softmax,
    output in q's dtype."""
    B, Q = q.shape[:2]
    hd = q.shape[-1]
    G = n_heads // kv_heads
    kmat = gather_pages(kp, tables).float()
    vmat = gather_pages(vp, tables).float()
    R = kmat.shape[1]
    qg = q.float().reshape(B, Q, kv_heads, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
    mask = (torch.arange(R, device=q.device)[None, None, :]
            < kv_lens[:, None, None])                          # (B, 1, R)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
    return o.reshape(B, Q, n_heads, hd).to(q.dtype)


def paged_decode(q1: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 tables: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """One decode token per lane over one layer's pool: q1 (B, H, hd),
    kp/vp (n_pages, ps, Hkv, hd), tables (B, P) int32 (row stride may
    exceed P: a narrowed read passes a column slice), kv_lens (B,)
    int32 -> (B, H, hd).

    A CUDA tensor launches the kernel; what it cannot take raises. A CPU
    tensor gets :func:`xla_paged_read`."""
    H, hd = q1.shape[1], q1.shape[2]
    Hkv = kp.shape[2]
    if q1.device.type == "cpu":
        return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                              H, Hkv)[:, 0]
    B = q1.shape[0]
    n_pages, ps = kp.shape[0], kp.shape[1]
    for name, t in (("kp", kp), ("vp", vp)):
        if t.device != q1.device or t.dtype != q1.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous() or t.shape != (n_pages, ps, Hkv, hd):
            raise ValueError(f"{name} must be a contiguous (n_pages, ps, "
                             f"Hkv, {hd}) pool layer")
    for name, t in (("tables", tables), ("kv_lens", kv_lens)):
        if t.device != q1.device or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on q's device")
    if not q1.is_contiguous() or not kv_lens.is_contiguous():
        raise ValueError("q and kv_lens must be contiguous")
    if tables.dim() != 2 or tables.shape[0] != B or tables.stride(1) != 1:
        raise ValueError("tables must be (B, P) with unit column stride")
    if (hd not in KERNEL_HEAD_DIMS or q1.dtype not in KERNEL_DTYPES
            or H % Hkv or H // Hkv not in KERNEL_GROUPS):
        raise ValueError(f"paged kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"dtype in {KERNEL_DTYPES} and query groups in "
                         f"{KERNEL_GROUPS}, got {hd} / {q1.dtype} / "
                         f"{H}:{Hkv}")
    out = torch.empty_like(q1)
    lib = build.library("paged_decode")
    with torch.cuda.device(q1.device):
        rc = lib.tpushare_paged_decode(
            q1.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            tables.stride(0), tables.shape[1], kv_lens.data_ptr(),
            out.data_ptr(), B, H, Hkv, hd, ps,
            int(q1.dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "paged_decode", rc)
    build.LAUNCHES["paged_decode"] += 1
    return out


def paged_attention_read(q, kp, vp, tables, kv_lens, cfg,
                         impl: str = "xla") -> torch.Tensor:
    """One decode step's attention read over paged K/V: q (B, 1, H, hd),
    kp/vp one layer's pool, tables (B, P), kv_lens (B,) valid rows per
    lane (current position + 1). ``impl`` is already resolved
    ("paged" | "xla", :func:`resolve_paged_impl`)."""
    from tpushare_torch.workloads.ops.registry import (KIND_PAGED,
                                                       select_attention)
    choice = select_attention(
        KIND_PAGED, impl=impl, n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, platform=q.device.type)
    return choice.fn(q[:, 0], kp, vp, tables, kv_lens)[:, None]
