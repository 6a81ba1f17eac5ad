"""Flash attention, forward and backward: the CUDA kernels' wrappers,
the differentiable front door, and their plain twins.

Port of ``tpushare/workloads/ops/attention.py``: ``flash_attention`` over
``_fwd_kernel`` (with its LSE output and sliding-window band) and the
``custom_vjp`` whose backward runs ``_dq_kernel`` and ``_dkv_kernel``.
The kernels live in ``kernels/flash_fwd.cu`` and ``kernels/flash_bwd.cu``.

- :func:`flash_attention` is differentiable. Without a gradient to take
  (inference, ``torch.no_grad``, inputs that do not require grad) it
  launches the LSE-free forward, as the reference's undifferentiated
  primal does. Otherwise it goes through :class:`FlashAttention`, whose
  forward also writes the row log-sum-exp and whose backward computes
  ``delta = rowsum(dO * O)`` in plain PyTorch (as the reference does
  outside Pallas) and launches the dQ and dK/dV kernels. dK/dV come
  back grouped, at the K/V heads' width.
- :func:`flash_chunk_attention` is the forward with a query offset over
  a KV cache read in place (the cached chunk's kernel in
  ``flash_fwd.cu``); the reference has no kernel there, and its plain
  form is ``decode.make_cached_attn_core``'s einsum core.
- :func:`flash_attention_plain` (with its ``lse``) and
  :func:`flash_attention_bwd_plain` compute the same functions in plain
  PyTorch. A CPU tensor gets them; a CUDA tensor gets the kernels or an
  error, never the twins.

LSE and delta are fp32 ``(B, H, S)`` arrays; q/o/dO are ``(B, S, H, hd)``
and k/v ``(B, S, Hkv, hd)``, the model's layout, on both paths.

Over a training mesh (B.10, the reference's ``make_sharded_flash``):
:class:`ShardedAttention` runs a single-device attention once per (dp,
tp) shard on the shard's device — batch over dp, heads over tp, GQA's
K/V heads over the same axis — forward and, through autograd, backward;
causal attention is parallel over both, so no shard reads another's
data. :func:`make_mesh_attention` is the step's policy over the
registry, with the reference's ``use_flash`` / ``attn_impl`` modes.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads.kernels import build

KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# masked scores: a finite -1e30, as the reference's kernels use
NEG_INF = -1e30


def check_window(causal: bool, window: int | None) -> None:
    """The reference's validation of a sliding window."""
    if window is None:
        return
    if not causal:
        raise ValueError("sliding window requires causal attention")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _mask(s: int, device, causal: bool,
          window: int | None) -> torch.Tensor | None:
    """(S, S) bool keep-mask of query row i against key column j, or None
    for full attention."""
    if not causal:
        return None
    mask = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    if window is not None:
        ids = torch.arange(s, device=device)
        mask &= ids[None, :] > ids[:, None] - window
    return mask


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    return x.repeat_interleave(group, dim=2) if group > 1 else x


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          with_lse: bool = False):
    """q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H, hd): fp32
    einsums, masked scores at -1e30, fp32 softmax, output in q's dtype.
    GQA repeats each K/V head over its query-head group. With
    ``with_lse`` also returns the rows' log-sum-exp, fp32 (B, H, S)."""
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hkv}")
    check_window(causal, window)
    k, v = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], q.device, causal, window)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1)


def bwd_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O): the backward's fp32 (B, H, S) row term,
    one definition for the kernels' path and the plain backward."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              window: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The flash backward in plain PyTorch, in the reference's algebra:
    P = exp(S - lse), dV = P^T dO, dS = P o (dO V^T - delta),
    dQ = scale dS K, dK = scale dS^T Q, with dK/dV summed over each
    query-head group. Returns (dq, dk, dv) in q's / k's / v's dtypes."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hkv}")
    check_window(causal, window)
    group = H // Hkv
    scale = hd ** -0.5
    qf, dof = q.float(), do.float()
    kf, vf = _repeat_kv(k.float(), group), _repeat_kv(v.float(), group)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                  - lse[..., None])
    mask = _mask(S, q.device, causal, window)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    delta = bwd_delta(do, o)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if group > 1:
        dk = dk.reshape(B, S, Hkv, group, hd).sum(3)
        dv = dv.reshape(B, S, Hkv, group, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _kernel_shape(q, k, v, causal, window, extra=()) -> tuple[int, ...]:
    """Check what the kernels take; returns (B, S, H, Hkv, hd)."""
    check_window(causal, window)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
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
        raise ValueError(f"flash kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS} and dtype in {KERNEL_DTYPES}, "
                         f"got {hd} / {q.dtype}")
    return B, S, H, Hkv, hd


def check_stats(B, H, S, device, **stats) -> None:
    """Row statistics (LSE, delta / di) as the backward kernels read them:
    contiguous fp32 (B, H, S) on q's device."""
    for name, t in stats.items():
        if (t.device != device or t.dtype != torch.float32
                or t.shape != (B, H, S) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 (B, H, S) = "
                             f"{(B, H, S)} tensor on q's device")


def cuda_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        with_lse: bool = False):
    """The flash forward: o, or (o, lse) with ``with_lse``. A CUDA tensor
    launches the kernel (any S, GQA native); a CPU tensor gets
    :func:`flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     with_lse=with_lse)
    B, S, H, Hkv, hd = _kernel_shape(q, k, v, causal, window)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, S, H, Hkv, hd,
            int(causal), window or 0, int(q.dtype == torch.bfloat16),
            hd ** -0.5, cuda_stream())
    build.check(lib, "flash_fwd", rc)
    build.LAUNCHES["flash_fwd"] += 1
    return (out, lse) if with_lse else out


def flash_chunk_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, pos: int) -> torch.Tensor:
    """A cached chunk's attention through the offset flash kernel (bf16
    CUDA tensors): q (B, Q, H, hd) at absolute positions pos .. pos+Q-1
    against the first pos + Q rows of one layer's cache view k / v (B,
    rows, Hkv, hd), read in place at their own row and batch strides;
    key j is kept for query i exactly when j <= pos + i. Returns (B, Q,
    H, hd) in q's dtype. The registry routes a chunk here
    (``KIND_CHUNK``); its plain twin is the einsum core of
    ``decode.make_cached_attn_core``."""
    B, Q, H, hd = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on q's device")
    if k.shape != v.shape or k.stride() != v.stride() or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k.stride(3) != 1 or k.stride(2) != hd:
        raise ValueError("k/v rows must hold their heads' values packed "
                         "(strides (..., hd, 1))")
    if H % Hkv or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the chunk kernel takes H % Hkv == 0 and head_dim "
                         f"in {KERNEL_HEAD_DIMS}, got {H}:{Hkv} / {hd}")
    if pos < 0 or pos + Q > k.shape[1]:
        raise ValueError(f"chunk rows {pos}..{pos + Q} past the cache's "
                         f"{k.shape[1]}")
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = build.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_flash_fwd_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Q,
            pos, H, Hkv, hd, k.stride(0), k.stride(1), hd ** -0.5,
            cuda_stream())
    build.check(lib, "flash_fwd_chunk", rc)
    build.LAUNCHES["flash_fwd_chunk"] += 1
    return out


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: int | None = None) -> torch.Tensor:
    """dQ through the dQ kernel (CUDA tensors; ``do`` contiguous)."""
    B, S, H, Hkv, hd = _kernel_shape(q, k, v, causal, window,
                                     extra=(("do", do),))
    check_stats(B, H, S, q.device, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    lib = build.library("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, Hkv,
            hd, int(causal), window or 0, int(q.dtype == torch.bfloat16),
            hd ** -0.5, cuda_stream())
    build.check(lib, "flash_bwd_dq", rc)
    build.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  window: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped (dK, dV) through the dK/dV kernel (CUDA tensors)."""
    B, S, H, Hkv, hd = _kernel_shape(q, k, v, causal, window,
                                     extra=(("do", do),))
    check_stats(B, H, S, q.device, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.library("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.tpushare_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, Hkv, hd, int(causal), window or 0,
            int(q.dtype == torch.bfloat16), hd ** -0.5, cuda_stream())
    build.check(lib, "flash_bwd_dkv", rc)
    build.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals: the two kernels on a
    CUDA tensor, :func:`flash_attention_bwd_plain` on a CPU one."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    # autograd may hand a strided gradient; the kernels read dense rows
    do = do.contiguous()
    delta = bwd_delta(do, o)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``_flash_rows`` custom_vjp: the
    forward saves (q, k, v, o, lse), the backward runs the dQ and dK/dV
    kernels (their plain twins on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Differentiable flash attention on (B, S, H|Hkv, hd) tensors.

    A CUDA tensor runs the hand-written kernels (any S, GQA native,
    head_dim in :data:`KERNEL_HEAD_DIMS`, bf16/fp32, causal or full, an
    optional sliding ``window``); what they cannot take raises — nothing
    falls back. A CPU tensor runs the plain twins. Only a call that a
    gradient will flow through pays for the LSE output."""
    check_window(causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# over a training mesh (B.10)
# ---------------------------------------------------------------------------

class ShardedAttention:
    """A single-device attention ``base(q, k, v)`` once per (dp, tp)
    shard of a mesh.

    ``attn.shards(qs, ks, vs)`` is the training step's form: dicts of
    per-shard (B/dp, S, H/tp | Hkv/tp, hd) tensors, each on its device,
    one ``base`` call (one kernel launch on a card) per key, outputs
    keyed the same. ``attn(q, k, v)`` takes GLOBAL tensors: each (dp,
    tp) block is copied to its grid device, attended there, and the
    outputs come back concatenated in rank order on q's device — per-head
    softmax makes that bitwise one unsharded launch."""

    def __init__(self, base, mesh, batch_axis: str = "dp",
                 head_axis: str = "tp") -> None:
        self.base = base
        self.mesh = mesh
        self.batch_axis, self.head_axis = batch_axis, head_axis

    def shards(self, qs: dict, ks: dict, vs: dict) -> dict:
        return {key: self.base(qs[key], ks[key], vs[key]) for key in qs}

    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        dp = self.mesh.shape.get(self.batch_axis, 1)
        tp = self.mesh.shape.get(self.head_axis, 1)
        bs, hs, ks = q.shape[0] // dp, q.shape[2] // tp, k.shape[2] // tp
        rows = []
        for d in range(dp):
            outs = []
            for t in range(tp):
                dev = self.mesh.device(**{self.batch_axis: d,
                                          self.head_axis: t})

                def part(x, w, d=d, t=t, dev=dev):
                    return x[d * bs:(d + 1) * bs, :,
                             t * w:(t + 1) * w].to(dev).contiguous()
                o = self.base(part(q, hs), part(k, ks), part(v, ks))
                outs.append(o.to(q.device))
            rows.append(torch.cat(outs, dim=2))
        return torch.cat(rows, dim=0)


def make_sharded_flash(mesh, *, causal: bool = True, batch_axis="dp",
                       head_axis="tp", window: int | None = None):
    """Flash attention over a mesh through the registry (impl='flash'):
    ``flash_attn(q, k, v)`` on GLOBAL (B, S, H|Hkv, hd) tensors, one
    forward launch per (dp, tp) shard and, when a gradient is taken, one
    dQ and one dK/dV launch per shard. An impossible mesh raises the
    registry's :class:`KernelUnavailable`."""
    from tpushare_torch.workloads.ops.registry import (KIND_PREFILL,
                                                       select_attention)

    def flash_attn(q, k, v):
        choice = select_attention(
            KIND_PREFILL, impl="flash", seq=q.shape[1], window=window,
            mesh=mesh, n_heads=q.shape[2], n_kv_heads=k.shape[2],
            head_dim=q.shape[3], platform=q.device.type, causal=causal,
            batch=q.shape[0], batch_axis=batch_axis, head_axis=head_axis)
        return choice.fn(q, k, v)

    return flash_attn


def make_mesh_attention(cfg, mesh, *, batch_axis="dp", head_axis="tp"):
    """The attention policy of a step over a mesh, through the registry's
    table: flash, splash (long context) or the plain path per shape.

    ``cfg.use_flash`` maps onto the registry's modes, as the
    reference's: ``True`` (impl='kernel') requires a kernel — an
    untiled shape raises :class:`KernelUnavailable`, and so does an sp >
    1 mesh, at once; ``None`` ('auto') takes the kernel where every
    shape tiles and counts the fallback otherwise; ``False`` runs the
    plain path. ``cfg.attn_impl`` pins one implementation by name.

    Returns ``attn(qs, ks, vs)`` over one dp group's shards (dicts keyed
    by shard, each tensor on its device — the step's form): the
    decision is taken on the global shape (local heads x tp, local
    batch x dp), then every shard runs it."""
    from tpushare_torch.workloads.ops.registry import (KIND_PREFILL,
                                                       KernelUnavailable,
                                                       select_attention)
    sp = mesh.shape.get("sp", 1)
    window = getattr(cfg, "attn_window", None)
    if cfg.use_flash and sp > 1:
        raise KernelUnavailable(
            "flash", "prefill",
            f"use_flash=True under an sp={sp} mesh: sequence-sharded "
            "causal attention is ring attention's job "
            "(ring_attention=True), not the (dp, tp) shard_map flash "
            "wrapper's")
    impl = getattr(cfg, "attn_impl", None) or (
        "kernel" if cfg.use_flash
        else "xla" if cfg.use_flash is False else "auto")
    tp = mesh.shape.get(head_axis, 1)
    dp = mesh.shape.get(batch_axis, 1)

    def attn(qs: dict, ks: dict, vs: dict) -> dict:
        q, k = next(iter(qs.values())), next(iter(ks.values()))
        choice = select_attention(
            KIND_PREFILL, impl=impl, seq=q.shape[1] * sp, window=window,
            mesh=mesh, n_heads=q.shape[2] * tp, n_kv_heads=k.shape[2] * tp,
            head_dim=q.shape[3], platform=q.device.type,
            batch=q.shape[0] * dp, batch_axis=batch_axis,
            head_axis=head_axis)
        if sp > 1:
            # the plain path over a sequence split without the ring:
            # every rank attends over the gathered K/V
            from tpushare_torch.workloads.ops.ring_attention import (
                gathered_attention)
            return gathered_attention(qs, ks, vs, window)
        return choice.fn.shards(qs, ks, vs)

    return attn
