"""Paged-attention decode read: the CUDA kernel's wrapper and its twin.

Port of ``tpushare/workloads/ops/paged_attention.py``. The serving
engine stores K/V as a page pool ``(L, n_pages, page_size, Hkv, hd)``
with per-lane block tables; this module is the READ — attention of one
query token per lane over its block-table pages.

- ``paged_decode`` wraps ``kernels/paged_decode.cu``, the Hopper
  counterpart of the upstream Pallas paged kernel the reference runs on
  a TPU: a split-row read — one CTA per ``CHUNK_ROWS`` rows of a lane
  and kv head walks that chunk's table slots and writes its fp32
  softmax state, and a second kernel combines a lane's live chunks in
  index order. A chunk past a lane's length exits before any load, so
  the bytes read scale with each lane's live rows, and the chunks'
  bounds do not depend on the table's width, so neither does the
  result.
- ``xla_paged_read`` gathers the lane's pages into a contiguous view and
  runs the reference's grouped-einsum attention op for op — the plain
  twin, what CPU tensors get, and the engine's "xla" path.

Both address each table slot independently, so tables whose entries
alias another lane's pages read correctly.

Both also serve the int8 page codec (``PagedServingEngine(kv_codec=
"int8")``): the pool leaves arrive as ``{"q": int8 pages, "s": fp32
scale planes}``. The twin dequantizes the gathered pages (``q * s`` in
fp32, the reference's ``_gather_dequant``); the kernel's int8 rung reads
the int8 rows and one scale per (row, head), folding ``k_s`` into the
score and ``v_s`` into the probability. The codec is taken from the
leaf type, so an int8 pool is never read as raw rows.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

PAGED_IMPLS = ("auto", "paged", "xla")
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# rows a pass-1 CTA reads: ``CHUNK`` in kernels/paged_decode.cu
CHUNK_ROWS = 512


def n_chunks(rows: int) -> int:
    """Pass 1's chunks over a table of ``rows`` = width x page_size rows
    (its grid's first axis)."""
    return -(-rows // CHUNK_ROWS)


def resolve_paged_impl(impl: str, platform: str,
                       kv_codec: str = "bf16") -> str:
    """Map the engine's ``attn_impl`` knob to "paged" or "xla" through
    the registry's decision table: ``auto`` degrades with a counted
    fallback event, an explicit ``paged`` the platform cannot run raises
    ``KernelUnavailable`` at engine construction. ``kv_codec`` rides into
    the decision, so an int8 pool's row names the int8 rung."""
    if impl not in PAGED_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {PAGED_IMPLS}")
    from tpushare_torch.workloads.ops import registry
    chosen, reason = registry.decide(registry.KIND_PAGED, impl=impl,
                                     platform=platform, codec=kv_codec)
    if impl == registry.IMPL_AUTO and chosen == registry.IMPL_XLA:
        registry.record_fallback(registry.IMPL_PAGED, reason)
    return chosen


def gather_pages(pool_layer: torch.Tensor,
                 tables: torch.Tensor) -> torch.Tensor:
    """Contiguous per-lane view of one layer's pool: ``(n_pages, ps,
    Hkv, ...)`` through ``(B, P)`` tables -> ``(B, P * ps, Hkv, ...)``
    (rank-generic, so a scale plane gathers through it too). Rows past a
    lane's live length are garbage the caller masks."""
    B, P = tables.shape
    ps = pool_layer.shape[1]
    g = pool_layer[tables]                         # (B, P, ps, Hkv, ...)
    return g.reshape(B, P * ps, *pool_layer.shape[2:])


def _gather_dequant(pool_layer, tables: torch.Tensor) -> torch.Tensor:
    """Gathered fp32 view of one layer's pool, dense or codec
    (``q * s`` per (row, head), as ``decode.kv_dequantize`` reads)."""
    if isinstance(pool_layer, dict):
        return (gather_pages(pool_layer["q"], tables).float()
                * gather_pages(pool_layer["s"], tables)[..., None])
    return gather_pages(pool_layer, tables).float()


def xla_paged_read(q, kp, vp, tables, kv_lens, n_heads: int,
                   kv_heads: int) -> torch.Tensor:
    """The gather twin, op for op the reference's: q (B, Q, H, hd),
    the pages gathered (and dequantized for an int8 pool) to fp32,
    grouped fp32 einsums, rows >= kv_lens masked at -1e30, fp32 softmax,
    output in q's dtype."""
    B, Q = q.shape[:2]
    hd = q.shape[-1]
    G = n_heads // kv_heads
    kmat = _gather_dequant(kp, tables)
    vmat = _gather_dequant(vp, tables)
    R = kmat.shape[1]
    qg = q.float().reshape(B, Q, kv_heads, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
    mask = (torch.arange(R, device=q.device)[None, None, :]
            < kv_lens[:, None, None])                          # (B, 1, R)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
    return o.reshape(B, Q, n_heads, hd).to(q.dtype)


def _check_pool_layer(name: str, t: torch.Tensor, shape: tuple,
                      dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on q's device")
    if not t.is_contiguous() or t.shape != shape:
        raise ValueError(f"{name} must be a contiguous {shape} pool layer")


def paged_decode(q1: torch.Tensor, kp, vp, tables: torch.Tensor,
                 kv_lens: torch.Tensor) -> torch.Tensor:
    """One decode token per lane over one layer's pool: q1 (B, H, hd),
    kp/vp (n_pages, ps, Hkv, hd) in q's dtype — or int8 codec leaves
    ``{"q": int8 (n_pages, ps, Hkv, hd), "s": fp32 (n_pages, ps, Hkv)}``
    — tables (B, P) int32 (row stride may exceed P: a narrowed read
    passes a column slice), kv_lens (B,) int32 -> (B, H, hd).

    A CUDA tensor launches the kernel (its int8 rung for codec leaves);
    what it cannot take raises. A CPU tensor gets
    :func:`xla_paged_read`."""
    H, hd = q1.shape[1], q1.shape[2]
    int8 = isinstance(kp, dict)
    kq, vq = (kp["q"], vp["q"]) if int8 else (kp, vp)
    Hkv = kq.shape[2]
    if q1.device.type == "cpu":
        return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                              H, Hkv)[:, 0]
    B = q1.shape[0]
    n_pages, ps = kq.shape[0], kq.shape[1]
    rows = (n_pages, ps, Hkv, hd)
    for name, t in (("k", kq), ("v", vq)):
        _check_pool_layer(name, t, rows, torch.int8 if int8 else q1.dtype,
                          q1.device)
    if int8:
        for name, t in (("k scales", kp["s"]), ("v scales", vp["s"])):
            _check_pool_layer(name, t, rows[:-1], torch.float32, q1.device)
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
    if any(t.data_ptr() % 16 for t in (q1, kq, vq)):
        raise ValueError("q, k and v must be 16-byte aligned (vector loads)")
    out = torch.empty_like(q1)
    lib = build.library("paged_decode")
    ks, vs = (kp["s"].data_ptr(), vp["s"].data_ptr()) if int8 else (None,
                                                                     None)
    chunks = n_chunks(tables.shape[1] * ps)
    # the chunks' fp32 partials: acc (hd floats) and (m, l) per chunk and
    # query head; one chunk writes the output directly
    ws = (torch.empty(B * H * chunks * (hd + 2), dtype=torch.float32,
                      device=q1.device) if chunks > 1 else None)
    with torch.cuda.device(q1.device):
        rc = lib.tpushare_paged_decode(
            q1.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            tables.data_ptr(), tables.stride(0), tables.shape[1],
            kv_lens.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), chunks, B, H, Hkv, hd, ps,
            int(q1.dtype == torch.bfloat16), int(int8), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    name = "paged_decode_int8" if int8 else "paged_decode"
    build.check(lib, name, rc)
    build.LAUNCHES[name] += 1
    return out


def paged_attention_read(q, kp, vp, tables, kv_lens, cfg,
                         impl: str = "xla") -> torch.Tensor:
    """One decode step's attention read over paged K/V: q (B, 1, H, hd),
    kp/vp one layer's pool (dense or codec leaves), tables (B, P),
    kv_lens (B,) valid rows per lane (current position + 1). ``impl`` is
    already resolved ("paged" | "xla", :func:`resolve_paged_impl`); the
    codec is a property of the pool bytes, taken from the leaf type so
    the read can never disagree with the storage."""
    from tpushare_torch.workloads.ops.registry import (KIND_PAGED,
                                                       select_attention)
    codec = "int8" if isinstance(kp, dict) else "bf16"
    choice = select_attention(
        KIND_PAGED, impl=impl, n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, platform=q.device.type, codec=codec)
    return choice.fn(q[:, 0], kp, vp, tables, kv_lens)[:, None]
