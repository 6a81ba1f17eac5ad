"""The ragged decode read's split-row algebra, replayed in plain PyTorch
on the CPU.

``kernels/ragged_decode.cu`` (K4 and its int8 rung K4-int8) reads each
slot's live rows in chunks of ``CHUNK_ROWS`` rows, one CTA a chunk, and
combines the chunks in a second pass:

    pass 1, chunk c of slot b (rows [c C, min((c + 1) C, len)), only
    those): s = (q . k) hd^-0.5 (x k_s on an int8 cache),
    m_c = max s, p = exp(s - m_c), l_c = sum p,
    acc_c = sum p v (int8: sum (p v_s) v_q)
    pass 2, chunks 0 .. ceil(len / C) - 1 in index order:
    M = max m_c, w_c = exp(m_c - M),
    o = (sum w_c acc_c) / (sum w_c l_c), rounded once to q's dtype

A CUDA kernel has no CPU mode, so this file replays that algebra in
fp32 and holds it to the twin (``ragged_decode_plain``) and to the
reference's Pallas ``ragged_decode_attention`` in interpret mode, at
``tests/test_torch_ragged.py``'s limits: fp32 within 1e-5, bf16 element
by element within 1e-2 of max(|value|, 2^-8 x the largest |value|).
Lengths (inclusive) sit at 0, C - 1 (one full chunk), C, C + 1 (a
second chunk of one and two rows) and S - 1. The control, a combine
that adds the chunks without the exp(m_c - M) rescale, must fail those
limits.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.ops import ragged_decode as jrag  # noqa: E402
from tpushare_torch.workloads.decode import kv_quantize  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.ops import ragged_decode as trag  # noqa: E402

C = trag.CHUNK_ROWS
HD = 128
S = max(512, 4 * C)
LENGTHS = np.array([0, C - 1, C, C + 1, S - 1], np.int32)
# tests/test_torch_ragged.py's limits (the int8 reads compare fp32 sums
# over the same planes, as tests/test_torch_kv_codec.py's READ_ATOL)
F32_ATOL = 1e-5
BF16_SHARE, BF16_FLOOR = 1e-2, 2 ** -8


def chunk_state(qg, k, v, ks, vs, r0, r1):
    """Pass 1 over rows [r0, r1) of one slot: (m, l, acc) per (kv head,
    query head of its group), fp32."""
    s = torch.einsum("hgd,nhd->hgn", qg, k[r0:r1]) * (HD ** -0.5)
    if ks is not None:
        s = s * ks[r0:r1].T[:, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if vs is not None:
        p = p * vs[r0:r1].T[:, None, :]
    return m, l, torch.einsum("hgn,nhd->hgd", p, v[r0:r1])


def combine(states, shape, rescale=True):
    """Pass 2: the chunks in index order, each rescaled by exp(m_c - M);
    ``rescale=False`` is the control that adds them as they are."""
    if not states:
        return torch.zeros(shape)
    big_m = torch.stack([m for m, _, _ in states]).amax(0)
    lsum, osum = torch.zeros(shape[:-1]), torch.zeros(shape)
    for m, l, acc in states:
        w = torch.exp(m - big_m) if rescale else torch.ones_like(m)
        lsum = lsum + l * w
        osum = osum + acc * w[..., None]
    return torch.where(lsum[..., None] > 0, osum / lsum[..., None], 0.0)


def replay(q, k, v, lengths, rescale=True):
    """The kernel's split and combine over (B, S, Hkv, hd) caches (dense,
    or int8 ``{q, s}`` leaves): only live rows are read, chunk bounds
    are multiples of C."""
    quantized = isinstance(k, dict)
    kq = (k["q"] if quantized else k).float()
    vq = (v["q"] if quantized else v).float()
    B, H, _ = q.shape
    n_rows, hkv = kq.shape[1], kq.shape[2]
    qg = q.float().reshape(B, hkv, H // hkv, HD)
    out = []
    for b in range(B):
        live = min(max(int(lengths[b]), -1) + 1, n_rows)
        ks, vs = ((k["s"][b], v["s"][b]) if quantized else (None, None))
        states = [chunk_state(qg[b], kq[b], vq[b], ks, vs, r0,
                              min(r0 + C, live))
                  for r0 in range(0, live, C)]
        out.append(combine(states, qg[b].shape, rescale))
    return torch.stack(out).reshape(B, H, HD).to(q.dtype)


def rounded(x, dtype):
    """fp32 draws rounded through ``dtype`` once, as numpy fp32."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def inputs(h, hkv, dtype, int8, n_rows=S, seed=0):
    """(reference args, port args) on the same values: q in ``dtype``;
    K/V caches in ``dtype``, or int8 leaves quantized once by the port's
    codec and carried to the reference as the same planes."""
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q = rounded(rng.standard_normal((len(LENGTHS), h, HD), np.float32), td)
    kv = [rng.standard_normal((len(LENGTHS), n_rows, hkv, HD), np.float32)
          for _ in range(2)]
    tq = torch.from_numpy(q).to(td)
    if int8:
        tkv = [kv_quantize(torch.from_numpy(x)) for x in kv]
        jkv = [{p: jnp.asarray(leaf[p].numpy()) for p in ("q", "s")}
               for leaf in tkv]
    else:
        kv = [rounded(x, td) for x in kv]
        tkv = [torch.from_numpy(x).to(td) for x in kv]
        jkv = [jnp.asarray(x, jd) for x in kv]
    return (jnp.asarray(q, jd), *jkv), (tq, *tkv)


def within(got, want, dtype) -> bool:
    got = got.float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        return bool(np.abs(got - want).max() <= F32_ATOL)
    floor = BF16_FLOOR * np.abs(want).max()
    share = np.abs(got - want) / np.maximum(np.abs(want), floor)
    return bool(share.max() <= BF16_SHARE)


RUNGS = [  # (q dtype, int8 leaves)
    ("float32", False), ("bfloat16", False),
    ("float32", True), ("bfloat16", True),
]


@pytest.mark.parametrize("h,hkv", [(4, 1), (8, 2), (4, 4)])
@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_replay_matches_the_twin_and_the_reference(dtype, int8, h, hkv):
    (jq, jk, jv), (tq, tk, tv) = inputs(h, hkv, dtype, int8)
    lengths = torch.from_numpy(LENGTHS)
    got = replay(tq, tk, tv, lengths)
    assert got.dtype == tq.dtype and got.shape == (len(LENGTHS), h, HD)
    assert within(got, trag.ragged_decode_plain(tq, tk, tv, lengths), dtype)
    want = jrag.ragged_decode_attention(jq, jk, jv, jnp.asarray(LENGTHS))
    assert within(got, want, dtype)


@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_combine_without_the_rescale_fails_the_limits(dtype, int8):
    """The control: chunks added without exp(m_c - M) miss the twin on
    every slot of more than one chunk, far past the limit."""
    _, (tq, tk, tv) = inputs(8, 2, dtype, int8, seed=1)
    lengths = torch.from_numpy(LENGTHS)
    want = trag.ragged_decode_plain(tq, tk, tv, lengths)
    assert within(replay(tq, tk, tv, lengths), want, dtype)
    bad = replay(tq, tk, tv, lengths, rescale=False)
    assert not within(bad, want, dtype)
    # slots read in one chunk are unaffected; the rest all miss
    live = np.minimum(LENGTHS + 1, S)
    for b, n in enumerate(live):
        assert within(bad[b], want[b], dtype) == (n <= C), (b, n)


@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_replay_is_independent_of_cache_capacity_bitwise(dtype, int8):
    """The same live rows in a 2x-larger cache: chunk bounds are
    multiples of C and only live rows are read, so the bits agree."""
    _, (tq, tk, tv) = inputs(4, 2, dtype, int8, seed=2)
    lengths = torch.from_numpy(LENGTHS)

    def grown(leaf):
        if isinstance(leaf, dict):
            return {"q": torch.cat([leaf["q"], torch.ones_like(leaf["q"])],
                                   1),
                    "s": torch.cat([leaf["s"], torch.ones_like(leaf["s"])],
                                   1)}
        return torch.cat([leaf, torch.ones_like(leaf)], 1)
    assert torch.equal(replay(tq, tk, tv, lengths),
                       replay(tq, grown(tk), grown(tv), lengths))


def test_one_chunk_combine_is_acc_over_l_bitwise():
    """Pass 1 writes o itself when one chunk covers S: the combine of one
    chunk weighs it by exp(0) = 1, so acc / l is the same bits."""
    rng = np.random.default_rng(3)
    qg = torch.from_numpy(rng.standard_normal((2, 4, HD), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((C, 2, HD), np.float32))
            for _ in range(2))
    m, l, acc = chunk_state(qg, k, v, None, None, 0, C - 3)
    assert torch.equal(combine([(m, l, acc)], acc.shape), acc / l[..., None])


def test_the_kernel_reads_the_chunk_length_the_wrapper_sizes_by():
    """``CHUNK_ROWS`` (the workspace's and the grid's chunk count) is the
    source's ``CHUNK``; the entry point refuses any other chunk count."""
    text = (build.KERNEL_DIR / build.SOURCES["ragged_decode"]).read_text()
    found = re.findall(r"^constexpr int CHUNK = (\d+);", text, re.MULTILINE)
    assert found == [str(C)]
    assert trag.n_chunks(1) == 1 and trag.n_chunks(C) == 1
    assert trag.n_chunks(C + 1) == 2 and trag.n_chunks(16384) == -(-16384 // C)
