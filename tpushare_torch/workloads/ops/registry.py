"""Kernel registry of the port: one decision table for the attention
sites this slice serves — the prefill/forward self-attention, the slot
engine's decode read and the paged decode read.

Port of ``tpushare/workloads/ops/registry.py`` (``decide``'s prefill,
decode and paged rows, ``select_attention``, the fallback counters). The
rows keep the reference's shape gates with ``platform == "cuda"`` where
the reference says ``"tpu"``. A serving mesh's tp degree rides
``mesh_shape`` and gates the decode and prefill rows as the reference's
``mesh:heads-untiled`` rows do; a training mesh's sp axis takes the
reference's ``mesh:sp-ring-domain`` row (sequence-sharded attention is
ring attention's), its dp axis the ``batch:untiled`` row, and the ring
kind (``KIND_RING``) its one row, ``ring:spmd-merge``: the ring's merge
is plain PyTorch, as the reference's is XLA einsums. Semantics are the
reference's:

- an explicit implementation that cannot be served raises
  :class:`KernelUnavailable`;
- ``impl="auto"`` may degrade to the plain path, recorded as a counted
  fallback event (:func:`record_fallback`);
- labels are the existing ``consts.KERNEL_IMPLS`` names: the CUDA
  kernels report as ``flash`` / ``ragged`` / ``paged``, the plain-PyTorch
  paths as ``xla``.

The paged pool's storage codec is part of the decision, as in the
reference: ``codec="int8"`` gives the paged rows a ``-int8`` suffix, and
the read the row picks serves the codec leaves (the kernel's int8 rung,
or the dequantizing gather twin). The slot-cache read's int8 rung
follows the cache's leaf type in the ragged wrapper (the reference's
``quantized=`` flag only keyed its build cache).

The prefill rows that involve splash are the reference's: an MHA
prefill at ``seq >= SPLASH_MIN_SEQ`` that splash can serve
(:func:`_splash_servable`: no window, ``seq % 128 == 0``,
``head_dim % 128 == 0``) runs the splash kernels (``longctx:splash``),
one it cannot serve runs flash (``shape:flash``), an explicit
``splash`` is refused with the reference's four messages, and an
``auto`` fallback is charged to splash wherever splash could have
served. Where the port departs from the reference's rows: the flash
kernel takes any S (it masks a partial last tile), so the reference's
Pallas-block gate (``seq:untiled``) is gone and every other CUDA
prefill runs the flash kernel (``cuda:flash``, GQA included); a causal
window runs the kernel's banded grid (``window:flash-banded``). The
decode rows keep the reference's gates (``RAGGED_HEAD_DIM``,
``RAGGED_BLOCK``) so the same configs are refused with the same
reasons.

The chunk kind (``KIND_CHUNK``) is the port's own: the reference
attends a multi-token chunk against its KV cache with the masked fp32
einsums of ``decode.make_cached_attn_core`` and asks no registry. On the
card a chunk of two or more queries at one position for the batch, over
a dense bf16 cache with no window, at a head_dim the flash kernel takes
and grouped heads, runs the offset flash kernel
(``attention.flash_chunk_attention``); every other input keeps the
einsum core, and only a chunk on the card that cannot take the kernel
counts as a fallback.

The sharded forms (the reference's ``shard_mapped`` kernel forms) are
the same kernels launched once per shard on the shard's device, their
outputs concatenated in rank order; per-head softmax makes the
concatenation bitwise one unsharded launch. The training mesh's
prefill forms — :func:`_build_prefill_flash` (B.10: the flash forward
and its dQ / dK/dV backward per (dp, tp) shard) and
:func:`_build_prefill_splash` (B.8: the splash forward and backward per
shard) — are ``ops/attention.ShardedAttention`` objects over the
single-device kernels. A sharded paged engine holds each pool shard as
its own tensor on its device
(``workloads/sharded_pool.py``) and reads it through the mesh-less
paged read. :func:`_build_decode_ragged` with a mesh is the ragged read
with heads over tp and slots over dp over a slot engine's whole cache:
a shard on the cache's device reads its heads and slots in place (the
kernel takes the cache's row pitch), one on another device reads a
copy of them.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Mapping

import torch

from tpushare_torch import consts
from tpushare_torch.workloads.ops.attention import (KERNEL_HEAD_DIMS,
                                                    ShardedAttention,
                                                    check_window,
                                                    flash_attention,
                                                    flash_attention_plain,
                                                    flash_chunk_attention)
from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                          xla_paged_read)
from tpushare_torch.workloads.ops.ragged_decode import (
    ragged_decode_attention)
from tpushare_torch.workloads.ops.splash_attention import splash_attention
from tpushare_torch.workloads.ops.splash_mask import MIN_BLOCK

IMPL_FLASH = "flash"      # kernels/flash_fwd.cu, flash_bwd.cu
IMPL_SPLASH = "splash"    # kernels/splash_fwd.cu, splash_bwd.cu
IMPL_PAGED = "paged"      # kernels/paged_decode.cu
IMPL_RAGGED = "ragged"    # kernels/ragged_decode.cu
IMPL_XLA = "xla"          # the plain-PyTorch twins
IMPLS = consts.KERNEL_IMPLS

IMPL_AUTO = "auto"
IMPL_KERNEL = "kernel"

KIND_PREFILL = "prefill"
KIND_DECODE = "decode"    # single-token read over the contiguous slot cache
KIND_PAGED = "paged"
KIND_RING = "ring"        # sequence-parallel ring attention over sp
KIND_CHUNK = "chunk"      # a multi-token chunk's read of a dense KV cache
KINDS = (KIND_PREFILL, KIND_DECODE, KIND_PAGED, KIND_RING, KIND_CHUNK)
# the chunk kind's einsum rows that are no fallback: a single token at
# one or per-row positions is a decode step, the decode kind's read
CHUNK_DECODE_STEPS = ("chunk:single-token", "pos:per-row")

SPLASH_MIN_SEQ = 4096
SPLASH_HEAD_DIM = 128
RAGGED_BLOCK = 256        # the reference's gate: cache rows % 256 == 0
RAGGED_HEAD_DIM = 128     # the reference's gate: head_dim == 128
PLATFORM = "cuda"


class KernelUnavailable(ValueError):
    """An explicitly requested attention kernel cannot run here."""

    def __init__(self, impl: str, kind: str, detail: str,
                 advice: str | None = None) -> None:
        self.impl = impl
        self.kind = kind
        self.detail = detail
        if advice is None:
            advice = "use impl='auto' for a counted plain-path fallback"
        super().__init__(
            f"attention kernel {impl!r} unavailable (kind={kind!r}): "
            f"{detail} — {advice}")


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One resolved selection. ``fn`` by kind — prefill:
    fn(q, k, v) on (B, S, H|Hkv, hd); decode: ragged
    fn(q1, k, v, lengths, layer=) over the stacked slot cache, xla
    ``decode.make_cached_attn_core`` (the dense masked einsum stays where
    the cache layout lives); paged: fn(q1, kp, vp, tables, kv_lens) over
    one layer's pool; chunk: flash fn(q, k, v, pos) over one layer's
    cache view, xla None (the caller's masked einsum core)."""

    kind: str
    impl: str
    reason: str
    fn: Callable[..., Any]


# ---------------------------------------------------------------------------
# fallback accounting (process-wide)
# ---------------------------------------------------------------------------

_fb_lock = threading.Lock()
_fallbacks: dict[tuple[str, str], int] = {}


def record_fallback(impl: str, reason: str) -> None:
    """Count one auto-mode degradation: ``impl`` is the kernel NOT taken,
    ``reason`` the row that rejected it."""
    with _fb_lock:
        _fallbacks[(impl, reason)] = _fallbacks.get((impl, reason), 0) + 1


def fallback_counts() -> dict[tuple[str, str], int]:
    with _fb_lock:
        return dict(_fallbacks)


def fallback_counts_flat() -> dict[str, int]:
    """``{"impl:reason": count}`` — the JSON-safe shape the serving
    telemetry attaches under ``consts.TELEMETRY_KERNEL_FALLBACKS``."""
    with _fb_lock:
        return {f"{impl}:{reason}": n
                for (impl, reason), n in _fallbacks.items()}


def reset_fallbacks() -> None:
    with _fb_lock:
        _fallbacks.clear()


# ---------------------------------------------------------------------------
# the decision table (pure)
# ---------------------------------------------------------------------------

def _splash_servable(seq: int | None, window: int | None,
                     n_heads: int | None, n_kv_heads: int | None,
                     head_dim: int | None) -> bool:
    """Could the splash kernels serve this shape at all: MHA, full
    causal, block-tiled seq, head_dim % 128 — the reference's rule,
    shared by the decision table and the fallback attribution."""
    if n_kv_heads is None:
        n_kv_heads = n_heads
    return ((n_heads is None or n_kv_heads == n_heads)
            and window is None
            and seq is not None and seq % MIN_BLOCK == 0
            and head_dim is not None and head_dim % SPLASH_HEAD_DIM == 0)


def _axis(mesh_shape: Mapping[str, int] | None, name: str) -> int:
    return int(mesh_shape.get(name, 1)) if mesh_shape else 1


def decide(kind: str, *, seq: int | None = None, window: int | None = None,
           mesh_shape: Mapping[str, int] | None = None,
           n_heads: int | None = None, n_kv_heads: int | None = None,
           head_dim: int | None = None, platform: str | None = None,
           impl: str = IMPL_AUTO, codec: str | None = None,
           batch: int | None = None, dtype: torch.dtype | None = None,
           per_row: bool = False) -> tuple[str, str]:
    """(impl, reason) for one attention site; raises
    :class:`KernelUnavailable` for explicit impls the table cannot
    honour. ``mesh_shape`` is a plain ``{axis: size}`` map (its ``tp``
    shards heads, ``dp`` the ``batch`` rows, ``sp`` the sequence);
    ``platform`` is the tensors' device type ("cuda" / "cpu"); ``codec``
    the paged pool's or the chunk's cache's storage codec
    (``consts.KV_CODECS``). The chunk kind reads ``seq`` as the chunk's
    query count, ``dtype`` as the cache's and ``per_row`` as positions
    given per batch row."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if impl not in IMPLS + (IMPL_AUTO, IMPL_KERNEL):
        raise ValueError(
            f"impl {impl!r} not in {IMPLS + (IMPL_AUTO, IMPL_KERNEL)}")
    if codec is not None and codec not in consts.KV_CODECS:
        raise ValueError(f"codec {codec!r} not in {consts.KV_CODECS}")
    if codec == "int8" and kind not in (KIND_PAGED, KIND_CHUNK):
        raise ValueError("codec='int8' applies to the paged pool read "
                         "(kind='paged') and a chunk's cache read "
                         "(kind='chunk'); a slot cache's int8 rung "
                         "follows its leaf type")
    if n_kv_heads is None:
        n_kv_heads = n_heads
    tp = _axis(mesh_shape, "tp")
    sp = _axis(mesh_shape, "sp")
    dp = _axis(mesh_shape, "dp")

    if kind == KIND_RING:
        # the ring's merge is plain PyTorch by design, as the
        # reference's is XLA einsums; only the sp axis is required
        if impl not in (IMPL_AUTO, IMPL_KERNEL, IMPL_XLA):
            raise KernelUnavailable(
                impl, kind, "ring attention has no Pallas kernel form; its "
                "blockwise merge is XLA einsums under the sp shard_map")
        if mesh_shape is None:
            raise KernelUnavailable(
                IMPL_XLA, kind, "sequence-parallel ring attention needs a "
                "mesh carrying the sp axis",
                advice="no impl choice can serve ring without one — fix "
                "the mesh")
        return IMPL_XLA, "ring:spmd-merge"

    if kind == KIND_PAGED:
        available = platform == PLATFORM
        # an int8 pool's rows name the int8 rung
        tag = "-int8" if codec == "int8" else ""
        if impl in (IMPL_PAGED, IMPL_KERNEL):
            if not available:
                raise KernelUnavailable(
                    IMPL_PAGED, kind,
                    f"the paged-attention kernel needs a CUDA device "
                    f"(platform {platform!r})")
            return IMPL_PAGED, "explicit:paged" + tag
        if impl == IMPL_XLA:
            return IMPL_XLA, "explicit:xla"
        if impl == IMPL_AUTO:
            if available:
                return IMPL_PAGED, "auto:paged" + tag
            return IMPL_XLA, "platform:" + (platform or "none")
        raise KernelUnavailable(
            impl, kind, "the paged read chooses between 'paged' and 'xla'")

    if kind == KIND_DECODE:
        # the fill-proportional ragged slot read vs the dense masked einsum
        if impl not in (IMPL_AUTO, IMPL_KERNEL, IMPL_RAGGED, IMPL_XLA):
            raise KernelUnavailable(
                impl, kind, "the slot-cache read chooses between 'ragged' "
                "and 'xla'")
        if impl == IMPL_XLA:
            return IMPL_XLA, "explicit:xla"
        explicit = impl in (IMPL_RAGGED, IMPL_KERNEL)

        def reject(reason: str, detail: str) -> tuple[str, str]:
            if explicit:
                raise KernelUnavailable(IMPL_RAGGED, kind, detail)
            return IMPL_XLA, reason

        if window is not None:
            return reject(
                "window:ring-cache",
                "ragged_decode composes with full causal attention only: "
                "windowed models already serve from the O(window) ring "
                "cache, which reads no dead rows to begin with")
        if head_dim is not None and head_dim != RAGGED_HEAD_DIM:
            return reject("head_dim:ragged-128",
                          f"ragged_decode needs head_dim "
                          f"{RAGGED_HEAD_DIM}, got {head_dim}")
        if seq is not None and seq % RAGGED_BLOCK:
            return reject("cache-rows:untiled",
                          f"cache rows {seq} not divisible by "
                          f"{RAGGED_BLOCK} (ragged_decode needs "
                          "block-tileable max_seq)")
        if tp > 1 and n_heads is not None and n_kv_heads is not None \
                and (n_heads % tp or n_kv_heads % tp):
            return reject("mesh:heads-untiled",
                          f"ragged_decode under tp={tp} shards heads: "
                          f"n_heads {n_heads} and kv_heads {n_kv_heads} "
                          "must both divide by tp")
        if explicit:
            return IMPL_RAGGED, "explicit:ragged"
        if platform != PLATFORM:
            return IMPL_XLA, "platform:" + (platform or "none")
        return IMPL_RAGGED, "auto:ragged"

    if kind == KIND_CHUNK:
        # Q >= 2 queries at one position for the batch against a dense
        # bf16 cache: the offset flash kernel; anything else keeps the
        # reference's masked einsum core. The inputs alone decide.
        if impl != IMPL_AUTO:
            raise KernelUnavailable(
                impl, kind, "a cached chunk's read is chosen by its inputs "
                "alone", advice="use impl='auto'")
        if per_row:
            return IMPL_XLA, "pos:per-row"
        if seq is None or seq < 2:
            return IMPL_XLA, "chunk:single-token"
        if codec == "int8":
            return IMPL_XLA, "codec:int8"
        if window is not None:
            return IMPL_XLA, "window:ring-cache"
        if dtype != torch.bfloat16:
            return IMPL_XLA, "dtype:" + str(dtype).removeprefix("torch.")
        if head_dim not in KERNEL_HEAD_DIMS:
            return IMPL_XLA, "head_dim:flash-set"
        if n_heads is None or not n_kv_heads or n_heads % n_kv_heads:
            return IMPL_XLA, "heads:ungrouped"
        if platform != PLATFORM:
            return IMPL_XLA, "platform:" + (platform or "none")
        return IMPL_FLASH, "auto:flash-chunk"

    # ---- kind == KIND_PREFILL ------------------------------------------
    if impl in (IMPL_PAGED, IMPL_RAGGED):
        raise KernelUnavailable(
            impl, kind, "prefill chooses between 'flash', 'splash' and "
            "'xla'; paged/ragged are decode-side reads")
    if impl == IMPL_XLA:
        return IMPL_XLA, "explicit:xla"
    heads_tile = (tp == 1 or (n_heads is not None and n_kv_heads is not None
                              and n_heads % tp == 0 and n_kv_heads % tp == 0))
    batch_tiles = dp == 1 or batch is None or batch % dp == 0
    if sp > 1:
        # sequence sharding is ring attention's domain: the prefill
        # forms split batch and heads, never the sequence
        if impl == IMPL_AUTO:
            return IMPL_XLA, "mesh:sp-ring-domain"
        raise KernelUnavailable(
            IMPL_FLASH if impl == IMPL_KERNEL else impl, kind,
            f"sequence-sharded causal attention under sp={sp} is ring "
            "attention's job (kind='ring'), not the (dp, tp) prefill "
            "wrappers'")
    if not heads_tile:
        if impl == IMPL_AUTO:
            return IMPL_XLA, "mesh:heads-untiled"
        raise KernelUnavailable(
            IMPL_FLASH if impl == IMPL_KERNEL else impl, kind,
            f"n_heads {n_heads} and kv_heads {n_kv_heads} must divide the "
            f"tp={tp} head sharding")
    mha = n_heads is None or n_kv_heads == n_heads
    splash_ok = _splash_servable(seq, window, n_heads, n_kv_heads, head_dim)
    if impl in (IMPL_SPLASH, IMPL_FLASH) and not batch_tiles:
        raise KernelUnavailable(
            impl, kind, f"batch {batch} does not divide the dp={dp} sharding")
    if impl == IMPL_SPLASH:
        # the reference's refusals, in its order and words
        if not mha:
            raise KernelUnavailable(
                impl, kind, f"splash_mha is MHA-only: n_kv_heads "
                f"{n_kv_heads} != n_heads {n_heads} (the flash kernel "
                "reads grouped K/V natively — use impl='flash')")
        if window is not None:
            raise KernelUnavailable(
                impl, kind, "windowed attention runs the flash kernel's "
                "compact banded grid — use impl='flash'")
        if head_dim is None or head_dim % SPLASH_HEAD_DIM:
            raise KernelUnavailable(
                impl, kind, f"splash needs head_dim % {SPLASH_HEAD_DIM} "
                f"== 0, got {head_dim}")
        if not splash_ok:
            raise KernelUnavailable(
                impl, kind, f"seq {seq} does not tile the splash block "
                f"grid under tp={tp}")
    if platform != PLATFORM:
        if impl == IMPL_AUTO:
            return IMPL_XLA, "platform:" + (platform or "none")
        kernel = IMPL_SPLASH if impl == IMPL_SPLASH else IMPL_FLASH
        raise KernelUnavailable(
            kernel, kind, f"the {kernel} kernel needs a CUDA device "
            f"(platform {platform!r})")
    if impl == IMPL_SPLASH:
        return IMPL_SPLASH, "explicit:splash"
    if impl == IMPL_FLASH:
        return IMPL_FLASH, "explicit:flash"
    if not batch_tiles:
        if impl == IMPL_KERNEL:
            raise KernelUnavailable(
                IMPL_FLASH, kind,
                f"batch {batch} does not divide the dp={dp} sharding")
        return IMPL_XLA, "batch:untiled"
    # auto/kernel: the flash kernel serves any S, GQA, head_dim and
    # window; splash takes the long MHA rows it can serve
    if window is not None:
        return IMPL_FLASH, "window:flash-banded"
    if mha and seq is not None and seq >= SPLASH_MIN_SEQ:
        if splash_ok:
            return IMPL_SPLASH, "longctx:splash"
        return IMPL_FLASH, "shape:flash"
    return IMPL_FLASH, "cuda:flash"


# ---------------------------------------------------------------------------
# sharded kernel forms: one launch per shard, outputs in rank order
# ---------------------------------------------------------------------------

def _shard(leaf, rows: slice, heads: slice, dev: torch.device):
    """A shard of a ``(B, S, Hkv, ...)`` leaf — its rows and KV heads, a
    codec leaf's ``q`` and ``s`` planes together — for a read on
    ``dev``: a view where the leaf already lives there, else a
    contiguous copy on ``dev``."""
    if isinstance(leaf, dict):
        return {name: _shard(plane, rows, heads, dev)
                for name, plane in leaf.items()}
    part = leaf[rows, :, heads]
    return part if part.device == dev else part.to(dev).contiguous()


def _kv_heads(leaf) -> int:
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[2]


def _build_decode_ragged(mesh: Any, batch: int | None = None,
                         batch_axis: str = "dp", head_axis: str = "tp"
                         ) -> Callable[..., Any]:
    """fn(q1, k, v, lengths, layer=) over the whole stacked ``(L, B, S,
    Hkv, hd)`` slot caches (dense or ``{q, s}`` codec leaves): with a
    mesh, heads over tp and slots over dp where the batch tiles it —
    each (dp, tp) shard's slots and heads are read on its device — in
    place where the cache lives there, else from a copy —, the ragged
    read (K4, its int8 rung for codec caches) launches there, and the
    outputs concatenate in rank order (heads within a dp row, then the
    rows). A batch dp does not tile is not split. The cache writes stay
    with the caller."""
    if mesh is None:
        return ragged_decode_attention
    tp = mesh.shape.get(head_axis, 1)
    dp = mesh.shape.get(batch_axis, 1)
    bdp = dp if (dp > 1 and batch is not None and batch % dp == 0) else 1

    def meshed(q1, kf, vf, lens, layer=None):
        from tpushare_torch.workloads.decode import kv_view
        k, v = ((kf, vf) if layer is None
                else (kv_view(kf, layer), kv_view(vf, layer)))
        B, H = q1.shape[:2]
        bs, hs, ks = B // bdp, H // tp, _kv_heads(k) // tp
        rows_out = []
        for d in range(bdp):
            rows = slice(d * bs, (d + 1) * bs)
            outs = []
            for r in range(tp):
                dev = mesh.device(**{batch_axis: d, head_axis: r})
                heads = slice(r * ks, (r + 1) * ks)
                o = ragged_decode_attention(
                    q1[rows, r * hs:(r + 1) * hs].to(dev).contiguous(),
                    _shard(k, rows, heads, dev), _shard(v, rows, heads, dev),
                    lens[rows].to(dev).contiguous())
                outs.append(o.to(q1.device))
            rows_out.append(torch.cat(outs, dim=1))
        return torch.cat(rows_out, dim=0)

    return meshed


def _mesh_shape(mesh: Any, batch_axis: str = "dp", head_axis: str = "tp",
                seq_axis: str = "sp") -> dict[str, int] | None:
    """A mesh as the decision table's ``{axis: size}`` map, its batch,
    head and sequence axes named dp, tp and sp."""
    if mesh is None:
        return None
    shape = dict(mesh.shape)
    for name, axis in (("dp", batch_axis), ("tp", head_axis),
                       ("sp", seq_axis)):
        shape[name] = int(mesh.shape.get(axis, 1))
    return shape


def _build_prefill_flash(window: int | None, causal: bool, mesh: Any,
                         batch_axis: str = "dp", head_axis: str = "tp"
                         ) -> Callable[..., Any]:
    """B.10: the flash forward and its dQ / dK/dV backward once per
    (dp, tp) shard on the shard's device — batch over dp, heads (and
    GQA's K/V heads) over tp, the sequence whole; causal attention is
    parallel over both, so no shard reads another's data."""
    base = functools.partial(flash_attention, causal=causal, window=window)
    if mesh is None:
        return base
    return ShardedAttention(base, mesh, batch_axis, head_axis)


def _build_prefill_splash(mesh: Any, batch_axis: str = "dp",
                          head_axis: str = "tp") -> Callable[..., Any]:
    """B.8: the splash forward and its dQ / dK/dV backward once per (dp,
    tp) shard over the shard's (B/dp, H/tp) heads — the reference's
    ``make_splash_mha(head_shards=tp)`` under ``shard_map``."""
    if mesh is None:
        return splash_attention
    return ShardedAttention(splash_attention, mesh, batch_axis, head_axis)


def _build_prefill_xla(window: int | None, causal: bool, mesh: Any,
                       batch_axis: str = "dp", head_axis: str = "tp"
                       ) -> Callable[..., Any]:
    """The plain path; on a mesh the same einsums per (dp, tp) shard."""
    base = functools.partial(flash_attention_plain, causal=causal,
                             window=window)
    if mesh is None:
        return base
    return ShardedAttention(base, mesh, batch_axis, head_axis)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

def select_attention(kind: str, *, seq: int | None = None,
                     window: int | None = None, mesh: Any = None,
                     n_heads: int | None = None,
                     n_kv_heads: int | None = None,
                     head_dim: int | None = None,
                     platform: str | None = None, impl: str = IMPL_AUTO,
                     batch: int | None = None, causal: bool = True,
                     codec: str | None = None, batch_axis: str = "dp",
                     head_axis: str = "tp", seq_axis: str = "sp",
                     zigzag: bool = False, reorder: bool = True,
                     dtype: torch.dtype | None = None, per_row: bool = False
                     ) -> KernelChoice:
    """Run :func:`decide` and return the ready-to-call implementation;
    an ``auto`` degradation to the plain path is recorded against the
    kernel the table would otherwise have taken. A window without causal
    masking raises, whatever the implementation. With ``mesh`` the
    prefill forms run once per (dp, tp) shard (B.10, B.8), the ragged
    decode read is the sharded form (:func:`_build_decode_ragged` over
    ``batch`` slots), and the ring kind builds the ring over the mesh's
    ``seq_axis`` (``zigzag`` / ``reorder`` / ``window`` its schedule); a
    sharded paged engine reads each pool shard through the mesh-less
    paged read. The chunk kind counts a fallback only on the card and
    only for a chunk: a decode step (:data:`CHUNK_DECODE_STEPS`) is no
    chunk, and a CPU tensor keeps the reference's einsum core, whose
    telemetry counts nothing there."""
    check_window(causal, window)
    chosen, reason = decide(kind, seq=seq, window=window,
                            mesh_shape=_mesh_shape(mesh, batch_axis,
                                                   head_axis, seq_axis),
                            n_heads=n_heads, n_kv_heads=n_kv_heads,
                            head_dim=head_dim, platform=platform, impl=impl,
                            codec=codec, batch=batch, dtype=dtype,
                            per_row=per_row)
    if kind == KIND_RING:
        if seq_axis not in mesh.shape:
            raise KernelUnavailable(
                IMPL_XLA, kind, f"mesh axes {tuple(mesh.shape)} carry no "
                f"{seq_axis!r} axis for sequence-parallel ring attention",
                advice="no impl choice can serve ring without one — fix "
                "the mesh")
        from tpushare_torch.workloads.ops.ring_attention import (
            build_ring_attention)
        fn = build_ring_attention(
            mesh, axis_name=seq_axis, batch_axis=batch_axis,
            head_axis=head_axis, causal=causal, zigzag=zigzag,
            reorder=reorder, window=window)
        return KernelChoice(kind=kind, impl=chosen, reason=reason, fn=fn)
    if kind == KIND_CHUNK:
        if chosen == IMPL_XLA and platform == PLATFORM \
                and reason not in CHUNK_DECODE_STEPS:
            record_fallback(IMPL_FLASH, reason)
        return KernelChoice(kind=kind, impl=chosen, reason=reason,
                            fn=flash_chunk_attention
                            if chosen == IMPL_FLASH else None)
    if chosen == IMPL_XLA and impl == IMPL_AUTO:
        # charged to the kernel the table would have picked for this
        # shape: splash only where splash could serve it
        wanted = {KIND_PREFILL: IMPL_FLASH, KIND_DECODE: IMPL_RAGGED,
                  KIND_PAGED: IMPL_PAGED}[kind]
        if (kind == KIND_PREFILL and (seq or 0) >= SPLASH_MIN_SEQ
                and _splash_servable(seq, window, n_heads, n_kv_heads,
                                     head_dim)):
            wanted = IMPL_SPLASH
        record_fallback(wanted, reason)
    if kind == KIND_PREFILL and chosen == IMPL_SPLASH:
        if not causal:
            raise ValueError("the splash kernels serve causal attention "
                             "only")
        fn = _build_prefill_splash(mesh, batch_axis, head_axis)
    elif kind == KIND_PREFILL and chosen == IMPL_FLASH:
        fn = _build_prefill_flash(window, causal, mesh, batch_axis,
                                  head_axis)
    elif kind == KIND_PREFILL:
        fn = _build_prefill_xla(window, causal, mesh, batch_axis, head_axis)
    elif kind == KIND_DECODE and chosen == IMPL_RAGGED:
        fn = _build_decode_ragged(mesh, batch)
    elif kind == KIND_DECODE:
        # imported here: decode.py imports this module (via the model)
        from tpushare_torch.workloads.decode import make_cached_attn_core
        fn = make_cached_attn_core
    elif chosen == IMPL_PAGED:
        fn = paged_decode
    else:
        def fn(q1, kp, vp, tables, kv_lens):
            return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                                  q1.shape[1], _kv_heads(kp))[:, 0]
    return KernelChoice(kind=kind, impl=chosen, reason=reason, fn=fn)
