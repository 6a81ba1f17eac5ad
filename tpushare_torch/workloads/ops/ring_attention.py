"""Ring attention: sequence-parallel causal attention over the ``sp``
axis — the port of ``tpushare/workloads/ops/ring_attention.py``.

Each sp rank's sequence chunk of Q, K and V lives on its device. Every
rank merges its own (diagonal) K/V block first; then each hop copies
every rank's current K/V chunk to the next rank in ring order and every
rank merges what arrived, with the online-softmax recurrence (running
max, running denominator, rescaled fp32 accumulator) of :func:`_merge`.
Hop ``i`` hands rank ``r`` the chunk of rank ``(r - i) mod sp``.

- contiguous layout: a chunk from a later rank is entirely in the
  causal future and is skipped;
- zigzag layout (causal only): rank ``r`` owns blocks ``(r, 2*sp-1-r)``
  of ``2*sp``, so after the diagonal every arriving chunk is exactly
  half live — its head half from an earlier rank, all of it for Q's
  tail half from a later one;
- banded (a sliding window, contiguous layout): only the hops the band
  reaches run (:func:`banded_hops`); the others are skipped, not masked.

The merge is plain PyTorch on every device, as the reference's is XLA
einsums by design (its registry row ``ring:spmd-merge``): no kernel is
launched. Autograd differentiates the ring — the hops are ``.to``
copies, whose backward carries the gradients back along the ring — as
``jax.grad`` does the reference's ``ppermute``. The reference's
``pin_seq_unsharded`` answers a jax CPU partitioner bug in sharded
concatenation; the port concatenates whole tensors and needs nothing in
its place.

NEG_INF is a finite -1e30, so masked scores multiply in exact zeros.
"""

from __future__ import annotations

from functools import partial

import torch

NEG_INF = -1e30


def _merge(q32, kc, vc, carry, mask=None, rows=slice(None)):
    """One score block into the carry. q32 (b, s_q, h, hd) fp32
    pre-scaled; kc / vc (b, s_k, h_kv, hd) with h_kv dividing h (GQA:
    query head h reads kv head h // (h / h_kv)); carry (m, l, acc)
    (b, h, s, ...) of which only ``rows`` update; mask (s_q, s_k) bool
    or None (all visible)."""
    m, l, acc = carry
    m_r, l_r, acc_r = m[:, :, rows], l[:, :, rows], acc[:, :, rows]
    b, sq, h, hd = q32.shape
    sk, hkv = kc.shape[1], kc.shape[2]
    g = h // hkv
    kf, vf = kc.float(), vc.float()
    q5 = q32.reshape(b, sq, hkv, g, hd)
    s_ij = torch.einsum("bqhgd,bkhd->bhgqk", q5, kf).reshape(b, h, sq, sk)
    if mask is not None:
        s_ij = torch.where(mask[None, None], s_ij,
                           torch.tensor(NEG_INF, device=s_ij.device))
    m_new = torch.maximum(m_r, s_ij.amax(dim=-1))
    p = torch.exp(s_ij - m_new[..., None])
    corr = torch.exp(m_r - m_new)
    l_new = l_r * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.reshape(b, hkv, g, sq, sk),
                      vf).reshape(b, h, sq, hd)
    acc_new = acc_r * corr[..., None] + pv
    if rows == slice(None):
        return m_new, l_new, acc_new
    lo = rows.start or 0
    hi = rows.stop if rows.stop is not None else m.shape[2]

    def put(full, part):
        return torch.cat([full[:, :, :lo], part, full[:, :, hi:]], dim=2)
    return put(m, m_new), put(l, l_new), put(acc, acc_new)


def _ring_scan(qs, ks, vs, *, step_fn, n_steps: int | None = None):
    """The ring over one column of sp ranks: ``qs`` / ``ks`` / ``vs``
    lists over the ranks, each chunk (b, s, h|h_kv, hd) on its rank's
    device. Diagonal merge, then (hop -> merge) x ``n_steps`` (default
    sp - 1, the full ring). ``step_fn(i, rank, kv_rank, q32, kc, vc,
    carry, diagonal)`` does one block merge, or returns the carry to
    skip it. Returns the outputs in the same layout, q's dtype."""
    sp = len(qs)
    hops = sp - 1 if n_steps is None else n_steps
    devs = [q.device for q in qs]
    q32 = [q.float() * q.shape[-1] ** -0.5 for q in qs]
    carries = []
    for r, q in enumerate(qs):
        b, s, h, hd = q.shape
        init = (torch.full((b, h, s), NEG_INF, device=q.device),
                torch.zeros((b, h, s), device=q.device),
                torch.zeros((b, h, s, hd), device=q.device))
        carries.append(step_fn(0, r, r, q32[r], ks[r], vs[r], init,
                               diagonal=True))
    kc, vc = list(ks), list(vs)
    for i in range(1, hops + 1):
        kc = [kc[(r - 1) % sp].to(devs[r]) for r in range(sp)]
        vc = [vc[(r - 1) % sp].to(devs[r]) for r in range(sp)]
        for r in range(sp):
            carries[r] = step_fn(i, r, (r - i) % sp, q32[r], kc[r], vc[r],
                                 carries[r], diagonal=False)
    return [(acc / l[..., None]).transpose(1, 2).to(q.dtype)
            for (_, l, acc), q in zip(carries, qs)]


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _step_contiguous(i, rank, kv_rank, q32, kc, vc, carry, *, causal: bool,
                     diagonal: bool):
    s = q32.shape[1]
    if not causal:
        return _merge(q32, kc, vc, carry)
    if diagonal:
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q32.device).tril()
        return _merge(q32, kc, vc, carry, mask)
    # a chunk from an earlier rank is entirely past; a later one (i >
    # rank) entirely future: skipped
    return _merge(q32, kc, vc, carry) if i <= rank else carry


def _step_banded(i, rank, kv_rank, q32, kc, vc, carry, *, window: int,
                 diagonal: bool):
    """Global-position band (qpos >= kpos) & (qpos - kpos < window) over
    the contiguous layout: hop i's pairs sit i*s + (q_local - k_local)
    apart, whatever the rank."""
    s = q32.shape[1]
    ar = torch.arange(s, device=q32.device)
    rel = ar[:, None] - ar[None, :]
    if diagonal:
        return _merge(q32, kc, vc, carry, (rel >= 0) & (rel < window))
    rel = rel + i * s
    if i > rank:        # the causal-future wraparound
        return carry
    return _merge(q32, kc, vc, carry, (rel >= 0) & (rel < window))


def banded_hops(window: int, s_local: int, sp: int) -> int:
    """Hops the band reaches: hop i's nearest key is (i-1)*s_local + 1
    positions behind its furthest query, in band while that distance is
    < window."""
    return min(sp - 1, (window - 2) // s_local + 1 if window >= 2 else 0)


def _zigzag_pos(rank: int, sp: int, half: int, device) -> torch.Tensor:
    """Global positions of a rank's (head, tail) blocks, concatenated."""
    ar = torch.arange(half, device=device)
    return torch.cat([rank * half + ar, (2 * sp - 1 - rank) * half + ar])


def _step_zigzag(i, rank, kv_rank, q32, kc, vc, carry, *, sp: int,
                 diagonal: bool):
    s = q32.shape[1]
    half = s // 2
    if diagonal:
        pos = _zigzag_pos(rank, sp, half, q32.device)
        return _merge(q32, kc, vc, carry, pos[:, None] >= pos[None, :])
    if kv_rank < rank:
        # an earlier rank: its head block is visible to all of Q, its
        # tail block entirely future
        return _merge(q32, kc[:, :half], vc[:, :half], carry)
    # a later rank: all of it is visible to Q's tail half only
    return _merge(q32[:, half:], kc, vc, carry, rows=slice(half, None))


def gathered_attention(qs: dict, ks: dict, vs: dict,
                       window: int | None = None) -> dict:
    """Causal attention over an sp-sharded sequence without the ring:
    each rank gathers every K/V chunk (rank order) to its device and
    attends its own queries at their global positions — the reference's
    plain path under sp > 1 when ring attention is off. Dicts keyed (sp
    rank, tp rank), contiguous layout."""
    sp = 1 + max(s for s, _ in qs)
    out = {}
    for (s, t), q in qs.items():
        dev = q.device
        k = torch.cat([ks[(r, t)].to(dev) for r in range(sp)], dim=1)
        v = torch.cat([vs[(r, t)].to(dev) for r in range(sp)], dim=1)
        b, sl, h, hd = q.shape
        rel = (s * sl + torch.arange(sl, device=dev))[:, None] \
            - torch.arange(k.shape[1], device=dev)[None, :]
        mask = rel >= 0
        if window is not None:
            mask &= rel < window
        init = (torch.full((b, h, sl), NEG_INF, device=dev),
                torch.zeros((b, h, sl), device=dev),
                torch.zeros((b, h, sl, hd), device=dev))
        _, l, acc = _merge(q.float() * hd ** -0.5, k, v, init, mask)
        out[(s, t)] = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# layout reorder helpers
# ---------------------------------------------------------------------------

def zigzag_split(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Reorder a sequence axis into the zigzag layout: rank r gets blocks
    (r, 2*sp-1-r) of 2*sp equal blocks. Shape is preserved."""
    blocks = torch.chunk(x, 2 * sp, dim=axis)
    if len(blocks) != 2 * sp or x.shape[axis] % (2 * sp):
        raise ValueError(f"axis of size {x.shape[axis]} does not split into "
                         f"{2 * sp} equal blocks")
    order = []
    for r in range(sp):
        order += [blocks[r], blocks[2 * sp - 1 - r]]
    return torch.cat(order, dim=axis)


def zigzag_merge(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_split`."""
    blocks = torch.chunk(x, 2 * sp, dim=axis)
    out: list = [None] * (2 * sp)
    for r in range(sp):
        out[r] = blocks[2 * r]
        out[2 * sp - 1 - r] = blocks[2 * r + 1]
    return torch.cat(out, dim=axis)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

class RingAttention:
    """The ring over a mesh's ``sp`` axis, batch over ``dp`` and heads
    over ``tp``.

    ``ring(q, k, v)`` takes GLOBAL (B, S, H|Hkv, hd) tensors: each (dp,
    sp, tp) shard goes to its grid device, the ring runs per (dp, tp)
    column, and the output comes back in rank order on q's device. With
    ``zigzag`` and ``reorder`` the caller's natural order is kept (the
    zigzag reorder runs before and after); with ``reorder=False`` q/k/v
    are already zigzag-ordered and so is the output.

    ``ring.shards(qs, ks, vs)`` is the form the training step calls:
    dicts keyed (sp rank, tp rank) of one dp group's chunks, each on its
    device, already in the ring's layout; returns the outputs keyed the
    same."""

    def __init__(self, mesh, *, axis_name: str = "sp",
                 batch_axis: str | None = "dp",
                 head_axis: str | None = "tp", causal: bool = True,
                 zigzag: bool = False, reorder: bool = True,
                 window: int | None = None) -> None:
        if zigzag and not causal:
            raise ValueError(
                "zigzag scheduling only applies to causal attention")
        if window is not None:
            if not causal:
                raise ValueError("window requires causal attention")
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            if zigzag:
                raise ValueError(
                    "window uses the contiguous banded schedule (the band "
                    "balances itself); zigzag must be off")
        self.mesh = mesh
        self.axes = (batch_axis, axis_name, head_axis)
        self.sp = mesh.shape[axis_name]
        self.zigzag, self.reorder, self.window = zigzag, reorder, window
        if window is not None:
            self.step_fn = partial(_step_banded, window=window)
        elif zigzag:
            self.step_fn = partial(_step_zigzag, sp=self.sp)
        else:
            self.step_fn = partial(_step_contiguous, causal=causal)

    def column(self, qs: list, ks: list, vs: list) -> list:
        """One (dp, tp) column: lists over the sp ranks."""
        s_local = qs[0].shape[1]
        blocks = 2 * self.sp if self.zigzag else self.sp
        if (s_local * self.sp) % blocks:
            raise ValueError(f"sequence {s_local * self.sp} must divide "
                             f"into {blocks} ring blocks")
        if self.zigzag and s_local % 2:
            raise ValueError(f"sequence {s_local * self.sp} must divide "
                             f"into {blocks} ring blocks")
        n_steps = (banded_hops(self.window, s_local, self.sp)
                   if self.window is not None else None)
        return _ring_scan(qs, ks, vs, step_fn=self.step_fn, n_steps=n_steps)

    def shards(self, qs: dict, ks: dict, vs: dict) -> dict:
        out = {}
        for t in sorted({t for _, t in qs}):
            keys = [(s, t) for s in range(self.sp)]
            outs = self.column([qs[k] for k in keys], [ks[k] for k in keys],
                               [vs[k] for k in keys])
            out.update(zip(keys, outs))
        return out

    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        batch_axis, seq_axis, head_axis = self.axes
        shape = self.mesh.shape
        dp = shape.get(batch_axis, 1) if batch_axis else 1
        tp = shape.get(head_axis, 1) if head_axis else 1
        sp = self.sp
        blocks = 2 * sp if self.zigzag else sp
        if q.shape[1] % blocks:
            raise ValueError(f"sequence {q.shape[1]} must divide into "
                             f"{blocks} ring blocks")
        if self.zigzag and self.reorder:
            q, k, v = (zigzag_split(x, sp) for x in (q, k, v))
        B, S, H, _ = q.shape
        bs, ss, hs, ks_ = B // dp, S // sp, H // tp, k.shape[2] // tp
        rows = []
        for d in range(dp):
            cols = []
            for t in range(tp):
                def part(x, w, d=d, t=t):
                    return [x[d * bs:(d + 1) * bs, s * ss:(s + 1) * ss,
                              t * w:(t + 1) * w].to(self.mesh.device(
                                  **{batch_axis: d, seq_axis: s,
                                     head_axis: t})).contiguous()
                            for s in range(sp)]
                outs = self.column(part(q, hs), part(k, ks_), part(v, ks_))
                cols.append(torch.cat([o.to(q.device) for o in outs], dim=1))
            rows.append(torch.cat(cols, dim=2))
        out = torch.cat(rows, dim=0)
        if self.zigzag and self.reorder:
            out = zigzag_merge(out, sp)
        return out


def make_ring_attention(mesh, *, axis_name: str = "sp",
                        batch_axis: str | None = "dp",
                        head_axis: str | None = "tp", causal: bool = True,
                        zigzag: bool = False, reorder: bool = True,
                        window: int | None = None) -> RingAttention:
    """The ring through the kernel registry (``select_attention``,
    kind ``ring``): the registry checks the mesh carries the sp axis
    and records the selection (``ring:spmd-merge``); the schedule is
    :func:`build_ring_attention`."""
    from tpushare_torch.workloads.ops.registry import (KIND_RING,
                                                       select_attention)
    return select_attention(
        KIND_RING, mesh=mesh, seq_axis=axis_name, batch_axis=batch_axis,
        head_axis=head_axis, causal=causal, zigzag=zigzag, reorder=reorder,
        window=window).fn


def build_ring_attention(mesh, *, axis_name: str = "sp",
                         batch_axis: str | None = "dp",
                         head_axis: str | None = "tp", causal: bool = True,
                         zigzag: bool = False, reorder: bool = True,
                         window: int | None = None) -> RingAttention:
    """The ring schedule builder (the registry's ring builder calls it;
    workload code calls :func:`make_ring_attention`)."""
    return RingAttention(mesh, axis_name=axis_name, batch_axis=batch_axis,
                         head_axis=head_axis, causal=causal, zigzag=zigzag,
                         reorder=reorder, window=window)
