"""The paged decode read's split-row algebra, replayed in plain PyTorch
on the CPU.

``kernels/paged_decode.cu`` (K5 and its int8 rung K5-int8) reads each
lane's live rows in chunks of ``CHUNK_ROWS`` rows, one CTA a chunk,
every row addressed through its own block-table slot, and combines the
chunks in a second pass:

    pass 1, chunk c of lane b (rows [c C, min((c + 1) C, len)), only
    those, len = min(kv_lens[b], table width x page size); row r read
    at pool[tables[b, r // ps], r % ps]):
    s = (q . k) hd^-0.5 (x k_s on an int8 pool),
    m_c = max s, p = exp(s - m_c), l_c = sum p,
    acc_c = sum p v (int8: sum (p v_s) v_q)
    pass 2, chunks 0 .. ceil(len / C) - 1 in index order:
    M = max m_c, w_c = exp(m_c - M),
    o = (sum w_c acc_c) / (sum w_c l_c), rounded once to q's dtype

A CUDA kernel has no CPU mode, so this file replays that algebra in
fp32 and holds it to the port's twin (``xla_paged_read``), to the
reference's ``xla_paged_read`` and, where this JAX runs it, to the
upstream Pallas kernel in interpret mode. Limits: the dense pools at
``tests/test_torch_kernels.py``'s ``TOL``; the int8 pools at
``tests/test_torch_kv_codec.py``'s ``READ_ATOL`` (fp32 sums over the
same planes) with an fp32 q, at ``TOL`` with a bf16 q; the upstream
kernel at the reference's own limits for it (``tests/test_kv_codec.py``).
Lengths sit at 1, C - 1, C, C + 1 and the table's whole width, on a
page size that divides C and one that does not (a chunk then starts
mid-page), with lane 1's first pages aliased onto lane 0's. The
control, a combine that adds the chunks without the exp(m_c - M)
rescale, must fail those limits.
"""

import re
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.ops import paged_attention as jpaged  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare_torch.workloads.decode import kv_quantize  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.ops import paged_attention as tpaged  # noqa: E402

C = tpaged.CHUNK_ROWS
# tests/test_torch_kernels.py's TOL (absolute + relative) and
# tests/test_torch_kv_codec.py's READ_ATOL; the reference's limits for
# the upstream kernel against its gather read
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
READ_ATOL = 1e-5
PALLAS_TOL, PALLAS_INT8_TOL = 2e-2, 1e-3
# one trace per shape (op by op, the reference read compiles each op)
ref_read = jax.jit(jpaged.xla_paged_read, static_argnums=(5, 6))


def table_width(ps: int) -> int:
    """Pages a table holds: room for two whole chunks and a part."""
    return (2 * C) // ps + 2


def lengths(ps: int) -> np.ndarray:
    return np.array([1, C - 1, C, C + 1, table_width(ps) * ps], np.int32)


def chunk_state(qg, kq, vq, ks, vs, pages, offs):
    """Pass 1 over the rows at (pages[i], offs[i]) of one lane: (m, l,
    acc) per (kv head, query head of its group), fp32."""
    hd = qg.shape[-1]
    s = torch.einsum("hgd,nhd->hgn", qg, kq[pages, offs]) * (hd ** -0.5)
    if ks is not None:
        s = s * ks[pages, offs].T[:, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if vs is not None:
        p = p * vs[pages, offs].T[:, None, :]
    return m, l, torch.einsum("hgn,nhd->hgd", p, vq[pages, offs])


def combine(states, shape, rescale=True):
    """Pass 2: the chunks in index order, each rescaled by exp(m_c - M);
    ``rescale=False`` is the control that adds them as they are. A lane
    with no live row reads zeros."""
    if not states:
        return torch.zeros(shape)
    big_m = torch.stack([m for m, _, _ in states]).amax(0)
    lsum, osum = torch.zeros(shape[:-1]), torch.zeros(shape)
    for m, l, acc in states:
        w = torch.exp(m - big_m) if rescale else torch.ones_like(m)
        lsum = lsum + l * w
        osum = osum + acc * w[..., None]
    return torch.where(lsum[..., None] > 0, osum / lsum[..., None], 0.0)


def replay(q1, kp, vp, tables, kv_lens, rescale=True):
    """The kernel's split and combine over (n_pages, ps, Hkv, hd) pools
    (dense, or int8 ``{q, s}`` leaves) through (B, P) tables: only live
    rows are read, each through its own table slot; chunk bounds are
    multiples of C."""
    quantized = isinstance(kp, dict)
    kq = (kp["q"] if quantized else kp).float()
    vq = (vp["q"] if quantized else vp).float()
    ks, vs = (kp["s"], vp["s"]) if quantized else (None, None)
    B, H, hd = q1.shape
    ps, hkv = kq.shape[1], kq.shape[2]
    qg = q1.float().reshape(B, hkv, H // hkv, hd)
    out = []
    for b in range(B):
        live = max(0, min(int(kv_lens[b]), tables.shape[1] * ps))
        states = []
        for r0 in range(0, live, C):
            r = torch.arange(r0, min(r0 + C, live))
            states.append(chunk_state(qg[b], kq, vq, ks, vs,
                                      tables[b, r // ps].long(), r % ps))
        out.append(combine(states, qg[b].shape, rescale))
    return torch.stack(out).reshape(B, H, hd).to(q1.dtype)


def rounded(x, dtype):
    """fp32 draws rounded through ``dtype`` once, as numpy fp32."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def inputs(h, hkv, hd, ps, dtype, int8, seed=0):
    """(reference args, port args) on the same values: q1 (B, h, hd) in
    ``dtype``; K/V pools of distinct pages in ``dtype``, or int8 leaves
    quantized once by the port's codec and carried to the reference as
    the same planes; tables with lane 1's first half aliased onto lane
    0's (a shared prefix); kv_lens at the chunk edges."""
    rng = np.random.default_rng(seed)
    lens = lengths(ps)
    B, P = len(lens), table_width(ps)
    n_pages = B * P + 1
    td = getattr(torch, dtype)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q = rounded(rng.standard_normal((B, h, hd), np.float32), td)
    kv = [rng.standard_normal((n_pages, ps, hkv, hd), np.float32)
          for _ in range(2)]
    tables = (rng.permutation(n_pages - 1)[:B * P].reshape(B, P) + 1
              ).astype(np.int32)
    tables[1, :P // 2] = tables[0, :P // 2]
    if int8:
        tkv = [kv_quantize(torch.from_numpy(x)) for x in kv]
        jkv = [{p: jnp.asarray(leaf[p].numpy()) for p in ("q", "s")}
               for leaf in tkv]
    else:
        kv = [rounded(x, td) for x in kv]
        tkv = [torch.from_numpy(x).to(td) for x in kv]
        jkv = [jnp.asarray(x, jd) for x in kv]
    port = (torch.from_numpy(q).to(td), *tkv, torch.from_numpy(tables),
            torch.from_numpy(lens))
    ref = (jnp.asarray(q, jd), *jkv, jnp.asarray(tables), jnp.asarray(lens))
    return ref, port


def within(got, want, dtype, int8) -> bool:
    got = got.float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(want, np.float32)
    if int8 and dtype == "float32":
        return bool(np.abs(got - want).max() <= READ_ATOL)
    tol = TOL[dtype]
    return bool((np.abs(got - want) <= tol + tol * np.abs(want)).all())


RUNGS = [  # (q dtype, int8 leaves)
    ("float32", False), ("bfloat16", False),
    ("float32", True), ("bfloat16", True),
]


# every group size on a page size that divides C; a page size that does
# not (chunks start mid-page) on one group
SHAPES = [(8, 1, 16), (8, 2, 16), (4, 4, 16), (8, 2, 24)]


@pytest.mark.parametrize("h,hkv,ps", SHAPES,
                         ids=[f"{h}-{k}-ps{p}" for h, k, p in SHAPES])
@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_replay_matches_the_twin_and_the_reference(dtype, int8, h, hkv, ps):
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = inputs(h, hkv, 64, ps,
                                                        dtype, int8)
    got = replay(tq, tk, tv, tt, tl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = tpaged.xla_paged_read(tq[:, None], tk, tv, tt, tl, h, hkv)[:, 0]
    assert within(got, want, dtype, int8)
    ref = ref_read(jq[:, None], jk, jv, jt, jl, h, hkv)[:, 0]
    assert within(got, ref, dtype, int8)


@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_combine_without_the_rescale_fails_the_limits(dtype, int8):
    """The control: chunks added without exp(m_c - M) miss the twin on
    every lane of more than one chunk, far past the limit."""
    _, (tq, tk, tv, tt, tl) = inputs(8, 2, 64, 24, dtype, int8, seed=1)
    want = tpaged.xla_paged_read(tq[:, None], tk, tv, tt, tl, 8, 2)[:, 0]
    assert within(replay(tq, tk, tv, tt, tl), want, dtype, int8)
    bad = replay(tq, tk, tv, tt, tl, rescale=False)
    assert not within(bad, want, dtype, int8)
    # lanes read in one chunk are unaffected; the rest all miss
    for b, n in enumerate(tl.tolist()):
        assert within(bad[b], want[b], dtype, int8) == (n <= C), (b, n)


@pytest.mark.parametrize("dtype,int8", RUNGS)
def test_replay_through_a_narrow_and_a_wide_table_bitwise(dtype, int8):
    """The engine narrows the table to a power-of-two rung over the
    longest live lane: the same lanes read through the narrow rung and
    through the whole table give the same bits (chunk bounds count from
    the lane's first row, only live rows are read), and the narrow read
    matches the twin."""
    _, (tq, tk, tv, tt, tl) = inputs(4, 2, 64, 16, dtype, int8, seed=2)
    lens = tl.clamp(max=C + 1)
    narrow = tt[:, :-(-(C + 1) // 16)]
    got = replay(tq, tk, tv, narrow, lens)
    assert torch.equal(got, replay(tq, tk, tv, tt, lens))
    want = tpaged.xla_paged_read(tq[:, None], tk, tv, narrow, lens, 4,
                                 2)[:, 0]
    assert within(got, want, dtype, int8)


def test_one_chunk_combine_is_acc_over_l_bitwise():
    """Pass 1 writes o itself when one chunk covers the table: the
    combine of one chunk weighs it by exp(0) = 1, so acc / l is the same
    bits."""
    rng = np.random.default_rng(3)
    qg = torch.from_numpy(rng.standard_normal((2, 4, 64), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 16, 2, 64), np.float32))
            for _ in range(2))
    r = torch.arange(40)
    pages = torch.tensor([2, 0, 1])[r // 16]
    m, l, acc = chunk_state(qg, k, v, None, None, pages, r % 16)
    assert torch.equal(combine([(m, l, acc)], acc.shape), acc / l[..., None])


def test_a_lane_with_no_live_row_reads_zeros():
    """kv_lens 0 (the engine never issues one): no chunk is read and the
    lane writes zeros, with no division by zero. The twin softmaxes the
    all-masked row instead (ROADMAP §C, a documented difference)."""
    _, (tq, tk, tv, tt, tl) = inputs(4, 2, 64, 16, "float32", False, seed=4)
    lens = tl.clone()
    lens[2] = 0
    got = replay(tq, tk, tv, tt, lens)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    keep = [0, 1, 3, 4]
    want = tpaged.xla_paged_read(tq[:, None], tk, tv, tt, lens, 4, 2)[:, 0]
    assert within(got[keep], want[keep], "float32", False)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_replay_matches_the_upstream_kernel_in_interpret_mode(int8):
    """The upstream Pallas paged kernel the reference runs on a TPU,
    built by the reference's registry and run in interpret mode (patched
    and skipped as ``tests/test_kv_codec.py`` does), on the same pools,
    tables and lengths."""
    if not jreg.paged_kernel_importable():
        pytest.skip("upstream paged-attention kernel unimportable")
    from jax.experimental import pallas as pl
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = inputs(4, 2, 128, 16,
                                                        "float32", int8,
                                                        seed=5)
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    read = jreg._build_paged_pallas(None, "tp", "int8" if int8 else None)
    try:
        with mock.patch.object(pl, "pallas_call", patched):
            want = np.asarray(read(jq, jk, jv, jt, jl))
    except Exception as e:  # noqa: BLE001 — interpret gaps vary by jax
        pytest.skip(f"pallas interpret mode unavailable here: {e}")
    tol = PALLAS_INT8_TOL if int8 else PALLAS_TOL
    np.testing.assert_allclose(replay(tq, tk, tv, tt, tl).numpy(), want,
                               atol=tol, rtol=tol)


def test_the_kernel_reads_the_chunk_length_the_wrapper_sizes_by():
    """``CHUNK_ROWS`` (the workspace's and the grid's chunk count) is the
    source's ``CHUNK``; the entry point refuses any other chunk count."""
    text = (build.KERNEL_DIR / build.SOURCES["paged_decode"]).read_text()
    found = re.findall(r"^constexpr int CHUNK = (\d+);", text, re.MULTILINE)
    assert found == [str(C)]
    assert tpaged.n_chunks(1) == 1 and tpaged.n_chunks(C) == 1
    assert tpaged.n_chunks(C + 1) == 2
    assert tpaged.n_chunks(512 * 32) == -(-512 * 32 // C)
