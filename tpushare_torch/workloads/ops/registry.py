"""Kernel registry of the port: one decision table for the attention
sites this slice serves — the prefill/forward self-attention and the
paged decode read.

Port of ``tpushare/workloads/ops/registry.py`` (``decide``'s prefill and
paged rows, ``select_attention``, the fallback counters). The rows keep
the reference's shape gates with ``platform == "cuda"`` where the
reference says ``"tpu"``; there is no mesh in this slice, so the dp/tp/sp
rows are absent. Semantics are the reference's:

- an explicit implementation that cannot be served raises
  :class:`KernelUnavailable`;
- ``impl="auto"`` may degrade to the plain path, recorded as a counted
  fallback event (:func:`record_fallback`);
- labels are the existing ``consts.KERNEL_IMPLS`` names: the CUDA
  kernels report as ``flash`` / ``paged``, the plain-PyTorch paths as
  ``xla``.

Where the port departs from the reference's rows: the flash kernel
takes any S (it masks a partial last tile), so the reference's
Pallas-block gate (``seq:untiled``) is gone and every CUDA prefill runs
the kernel; the reference's ``longctx:splash`` row runs the flash kernel
under its own reason (``longctx:flash-for-splash``) until the splash
kernel has a counterpart; and a windowed config on CUDA raises, under
``auto`` too, until the kernel's banded grid is ported — the plain path
never runs on the card unasked.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable

from tpushare_torch import consts
from tpushare_torch.workloads.ops.attention import (check_window,
                                                    flash_attention,
                                                    flash_attention_plain)
from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                          xla_paged_read)

IMPL_FLASH = "flash"      # kernels/flash_fwd.cu, flash_bwd.cu
IMPL_SPLASH = "splash"    # no Hopper counterpart yet
IMPL_PAGED = "paged"      # kernels/paged_decode.cu
IMPL_RAGGED = "ragged"    # no Hopper counterpart yet
IMPL_XLA = "xla"          # the plain-PyTorch twins
IMPLS = consts.KERNEL_IMPLS

IMPL_AUTO = "auto"
IMPL_KERNEL = "kernel"

KIND_PREFILL = "prefill"
KIND_PAGED = "paged"
KINDS = (KIND_PREFILL, KIND_PAGED)

SPLASH_MIN_SEQ = 4096
SPLASH_HEAD_DIM = 128
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
    fn(q, k, v) on (B, S, H|Hkv, hd); paged: fn(q1, kp, vp, tables,
    kv_lens) over one layer's pool."""

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


def reset_fallbacks() -> None:
    with _fb_lock:
        _fallbacks.clear()


# ---------------------------------------------------------------------------
# the decision table (pure)
# ---------------------------------------------------------------------------

def decide(kind: str, *, seq: int | None = None, window: int | None = None,
           n_heads: int | None = None, n_kv_heads: int | None = None,
           head_dim: int | None = None, platform: str | None = None,
           impl: str = IMPL_AUTO) -> tuple[str, str]:
    """(impl, reason) for one attention site; raises
    :class:`KernelUnavailable` for explicit impls the table cannot
    honour. ``platform`` is the tensors' device type ("cuda" / "cpu")."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if impl not in IMPLS + (IMPL_AUTO, IMPL_KERNEL):
        raise ValueError(
            f"impl {impl!r} not in {IMPLS + (IMPL_AUTO, IMPL_KERNEL)}")
    if n_kv_heads is None:
        n_kv_heads = n_heads

    if kind == KIND_PAGED:
        available = platform == PLATFORM
        if impl in (IMPL_PAGED, IMPL_KERNEL):
            if not available:
                raise KernelUnavailable(
                    IMPL_PAGED, kind,
                    f"the paged-attention kernel needs a CUDA device "
                    f"(platform {platform!r})")
            return IMPL_PAGED, "explicit:paged"
        if impl == IMPL_XLA:
            return IMPL_XLA, "explicit:xla"
        if impl == IMPL_AUTO:
            if available:
                return IMPL_PAGED, "auto:paged"
            return IMPL_XLA, "platform:" + (platform or "none")
        raise KernelUnavailable(
            impl, kind, "the paged read chooses between 'paged' and 'xla'")

    # ---- kind == KIND_PREFILL ------------------------------------------
    if impl in (IMPL_PAGED, IMPL_RAGGED):
        raise KernelUnavailable(
            impl, kind, "prefill chooses between 'flash', 'splash' and "
            "'xla'; paged/ragged are decode-side reads")
    if impl == IMPL_XLA:
        return IMPL_XLA, "explicit:xla"
    if impl == IMPL_SPLASH:
        raise KernelUnavailable(
            impl, kind, "the splash kernel has no Hopper counterpart yet",
            advice="use impl='flash' (or 'auto', whose long-context row "
            "runs the flash kernel)")
    if platform != PLATFORM:
        if impl == IMPL_AUTO:
            return IMPL_XLA, "platform:" + (platform or "none")
        raise KernelUnavailable(
            IMPL_FLASH, kind, f"the flash kernel needs a CUDA device "
            f"(platform {platform!r})")
    if impl == IMPL_FLASH:
        return IMPL_FLASH, "explicit:flash"
    # auto/kernel: the kernel serves any S, GQA, head_dim and window; the
    # distinct rows mark the banded grid and where the reference would
    # run splash
    if window is not None:
        return IMPL_FLASH, "window:flash-banded"
    if (seq is not None and seq >= SPLASH_MIN_SEQ and n_kv_heads == n_heads
            and head_dim is not None and head_dim % SPLASH_HEAD_DIM == 0):
        return IMPL_FLASH, "longctx:flash-for-splash"
    return IMPL_FLASH, "cuda:flash"


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

def select_attention(kind: str, *, seq: int | None = None,
                     window: int | None = None, n_heads: int | None = None,
                     n_kv_heads: int | None = None,
                     head_dim: int | None = None,
                     platform: str | None = None, impl: str = IMPL_AUTO,
                     causal: bool = True) -> KernelChoice:
    """Run :func:`decide` and return the ready-to-call implementation;
    an ``auto`` degradation to the plain path is recorded against the
    kernel the table would otherwise have taken. A window without causal
    masking raises, whatever the implementation."""
    check_window(causal, window)
    chosen, reason = decide(kind, seq=seq, window=window, n_heads=n_heads,
                            n_kv_heads=n_kv_heads, head_dim=head_dim,
                            platform=platform, impl=impl)
    if chosen == IMPL_XLA and impl == IMPL_AUTO:
        record_fallback(IMPL_FLASH if kind == KIND_PREFILL else IMPL_PAGED,
                        reason)
    if kind == KIND_PREFILL and chosen == IMPL_FLASH:
        fn = functools.partial(flash_attention, causal=causal, window=window)
    elif kind == KIND_PREFILL:
        fn = functools.partial(flash_attention_plain, causal=causal,
                               window=window)
    elif chosen == IMPL_PAGED:
        fn = paged_decode
    else:
        def fn(q1, kp, vp, tables, kv_lens):
            return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                                  n_heads, n_kv_heads or n_heads)[:, 0]
    return KernelChoice(kind=kind, impl=chosen, reason=reason, fn=fn)
