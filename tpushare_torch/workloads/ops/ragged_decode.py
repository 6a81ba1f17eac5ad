"""Ragged decode attention: the CUDA kernel's wrapper and its twin.

Port of ``tpushare/workloads/ops/ragged_decode.py``. The slot engine's
caches are allocated at ``max_seq`` rows per slot, but a slot's live
sequence is usually far shorter, and decode is bandwidth-bound: the
dense cached attention (``decode.make_cached_attn_core``) masks the dead
rows but still reads them. This read scales with each slot's live
length instead.

- ``ragged_decode_attention`` wraps ``kernels/ragged_decode.cu``, the
  Hopper counterpart of the reference's Pallas ``_kernel``: a split-row
  read — one CTA per ``CHUNK_ROWS`` rows of a slot and kv head writes
  that chunk's fp32 softmax state, and a second kernel combines a
  slot's live chunks in index order. A chunk past a slot's length exits
  before any load, so dead rows are never read, and the chunks' bounds
  do not depend on the allocated S, so neither does the result.
- ``ragged_decode_plain`` is the twin, the per-row branch of the
  reference's ``make_cached_attn_core`` op for op — what CPU tensors
  get.

A stacked ``(L, B, S, Hkv, hd)`` cache is read at ``layer`` through the
contiguous view ``k[layer]``: the kernel is handed the view's pointer, so
no slice is copied (the reference had to thread the stacked cache through
its scan carry to get the same). A KV-head slice of a cache
(``k[:, :, h0:h1]``, a tp shard's heads, and any rows of it) is read in
place too: the kernel takes the heads a cache row holds as its row
pitch.

An int8 codec cache (``cfg.kv_int8``: ``{"q": int8 (..., hd), "s": fp32
(...)}`` leaves) is read at int8 width by the kernel's int8 rung, the
scales folded into scores and probabilities as the reference's
``quantized`` kernel folds them; the twin takes the dense core's
quantized branch.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# rows a pass-1 CTA reads: ``CHUNK`` in kernels/ragged_decode.cu
CHUNK_ROWS = 512


def n_chunks(S: int) -> int:
    """Pass 1's chunks over an S-row cache (its grid's first axis)."""
    return -(-S // CHUNK_ROWS)


def _layer_views(k, v, layer):
    if layer is None:
        return k, v
    # imported here: decode.py imports the registry, which imports this
    from tpushare_torch.workloads.decode import kv_view
    return kv_view(k, layer), kv_view(v, layer)


def _row_heads(t: torch.Tensor, shape: tuple) -> int | None:
    """The KV heads a cache row of ``t`` holds: ``t`` of ``shape`` (B, S,
    Hkv[, hd]) laid out as the KV-head slice of a (B', S, row_heads[,
    hd]) contiguous cache — ``Hkv`` itself when ``t`` is contiguous; None
    for any other layout."""
    if tuple(t.shape) != shape:
        return None
    if t.is_contiguous():
        return shape[2]
    inner = shape[3] if len(shape) == 4 else 1
    pitch = t.stride(1) // inner
    want = (shape[1] * pitch * inner, pitch * inner, inner, 1)[:len(shape)]
    fits = all(n == 1 or st == w
               for n, st, w in zip(shape, t.stride(), want))
    return pitch if fits and pitch >= shape[2] else None


def ragged_decode_plain(q: torch.Tensor, k, v, lengths: torch.Tensor, *,
                        layer: int | None = None) -> torch.Tensor:
    """The twin: fp32 grouped einsums, the dot scaled by hd^-0.5 after
    it (then by the K scales of a codec cache), rows past ``lengths[b]``
    masked at -1e30, fp32 softmax (then times the V scales), output in
    q's dtype. Arguments as :func:`ragged_decode_attention`."""
    from tpushare_torch.workloads.decode import kv_scale_bhgqk
    k, v = _layer_views(k, v, layer)
    quantized = isinstance(k, dict)
    kmat = (k["q"] if quantized else k).float()
    vmat = (v["q"] if quantized else v).float()
    B, H, hd = q.shape
    S, Hkv = kmat.shape[1], kmat.shape[2]
    qg = q.float().reshape(B, 1, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
    if quantized:
        s = s * kv_scale_bhgqk(k["s"])
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= lengths[:, None, None])                          # (B, 1, S)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if quantized:
        p = p * kv_scale_bhgqk(v["s"])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
    return o.reshape(B, H, hd).to(q.dtype)


def ragged_decode_attention(q: torch.Tensor, k, v, lengths: torch.Tensor,
                            *, layer: int | None = None) -> torch.Tensor:
    """Single-token cached attention with per-slot live lengths.

    q (B, H, hd) is each slot's query at its current position; k/v are
    (B, S, Hkv, hd) caches — in q's dtype, or int8 codec leaves
    ``{"q": int8 (B, S, Hkv, hd), "s": fp32 (B, S, Hkv)}`` — or with
    ``layer`` the full stacked (L, B, ...) caches of which ``k[layer]``
    is read — contiguous, or a KV-head slice of a contiguous cache (all
    planes sliced alike); lengths (B,) int32 — slot b attends rows [0,
    lengths[b]] inclusive (the current token's K/V is already written
    at ``lengths[b]``). Returns (B, H, hd) in q's dtype.

    A CUDA tensor launches the kernel (its int8 rung for codec leaves);
    what it cannot take raises. A CPU tensor gets
    :func:`ragged_decode_plain`."""
    if q.device.type == "cpu":
        return ragged_decode_plain(q, k, v, lengths, layer=layer)
    k, v = _layer_views(k, v, layer)
    int8 = isinstance(k, dict)
    kq, vq = (k["q"], v["q"]) if int8 else (k, v)
    B, H, hd = q.shape
    if kq.dim() != 4 or kq.shape[0] != B or kq.shape[3] != hd:
        raise ValueError(f"k must be (B={B}, S, Hkv, {hd}) (one layer), "
                         f"got {tuple(kq.shape)}")
    S, Hkv = kq.shape[1], kq.shape[2]
    planes = [("k", kq, (B, S, Hkv, hd), torch.int8 if int8 else q.dtype),
              ("v", vq, (B, S, Hkv, hd), torch.int8 if int8 else q.dtype)]
    if int8:
        planes += [("k scales", k["s"], (B, S, Hkv), torch.float32),
                   ("v scales", v["s"], (B, S, Hkv), torch.float32)]
    pitches = set()
    for name, t, shape, dtype in planes:
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on q's device")
        pitch = _row_heads(t, shape)
        if pitch is None:
            raise ValueError(f"{name} must be a contiguous {shape} cache "
                             "or a KV-head slice of one (or a stacked "
                             "cache with layer=)")
        pitches.add(pitch)
    if len(pitches) != 1:
        raise ValueError(f"k, v and their scales must share one row pitch, "
                         f"got {sorted(pitches)} heads")
    row_heads = pitches.pop()
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
    if any(t.data_ptr() % 16 for t in (q, kq, vq)):
        raise ValueError("q, k and v must be 16-byte aligned (vector loads)")
    out = torch.empty_like(q)
    lib = build.library("ragged_decode")
    ks, vs = (k["s"].data_ptr(), v["s"].data_ptr()) if int8 else (None, None)
    chunks = n_chunks(S)
    # the chunks' fp32 partials: acc (hd floats) and (m, l) per chunk and
    # query head; one chunk writes the output directly
    ws = (torch.empty(B * H * chunks * (hd + 2), dtype=torch.float32,
                      device=q.device) if chunks > 1 else None)
    with torch.cuda.device(q.device):
        rc = lib.tpushare_ragged_decode(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), chunks, B, S, H, Hkv,
            row_heads, hd,
            int(q.dtype == torch.bfloat16), int(int8), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    name = "ragged_decode_int8" if int8 else "ragged_decode"
    build.check(lib, name, rc)
    build.LAUNCHES[name] += 1
    return out
