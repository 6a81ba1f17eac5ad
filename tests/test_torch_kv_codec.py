"""The port's int8 KV codec held against the JAX reference on the CPU.

- the rowwise codec (``quant.rowwise_absmax_encode``): ``q`` within one
  LSB of the reference's (eager and jitted), ``s`` at rtol 1e-6, zero
  rows, the half-step error bound;
- the page arithmetic and the registry's codec rows, equal to the
  reference's;
- the cache and pool layouts, the quantize-on-install rule and the
  cached core's quantized branch, against the reference's on the same
  planes;
- the two int8 read twins — the paged gather read (K5's int8 rung) and
  the ragged read (K4's) — against the reference's reads on the SAME
  ``{q, s}`` planes carried across, so a codec LSB can neither hide nor
  fake a read error: against ``xla_paged_read`` and the reference's
  Pallas kernels in interpret mode.

The CUDA rungs themselves are held against these twins by
``tests/test_torch_kernels.py`` (marked ``cuda``) and ``chip_smoke.py``.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import paging as jpaging  # noqa: E402
from tpushare.workloads import quant as jquant  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.ops import paged_attention as jpaged  # noqa: E402
from tpushare.workloads.ops import ragged_decode as jrag  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare.workloads.serving import _install_pages  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, paging, quant  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import paged_attention as tpaged  # noqa: E402
from tpushare_torch.workloads.ops import ragged_decode as trag  # noqa: E402
from tpushare_torch.workloads.ops import registry as treg  # noqa: E402

# the reads compare fp32 einsums / softmax over the same int8 planes:
# summation order only
READ_ATOL = 1e-5
# the reference's own tolerance for its Pallas int8 rung against the
# gather read (the upstream kernel's /127.5 scale adapter and blocking)
PALLAS_INT8_TOL = 1e-3


def as_torch_cfg(jcfg):
    return tt.TransformerConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)},
                                   "dtype": torch.float32})


def codec_to_torch(leaf) -> dict:
    return {"q": torch.from_numpy(np.array(leaf["q"])),
            "s": torch.from_numpy(np.array(leaf["s"]))}


def quantized_pair(shape, seed):
    """A reference codec leaf of random rows and the same planes carried
    into the port."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jleaf = jdec.kv_quantize(jnp.asarray(x))
    return jleaf, codec_to_torch(jleaf)


# ---------------------------------------------------------------------------
# the rowwise codec
# ---------------------------------------------------------------------------

def codec_rows(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4, 128)).astype(np.float32) * \
        np.exp(rng.standard_normal((64, 4, 1)) * 2).astype(np.float32)
    x[3] = 0.0                                       # zero rows
    x[5, 1, :] = 1e-30                               # a denormal-ish row
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


@pytest.mark.parametrize("jitted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_matches_the_reference_within_one_lsb(jitted, dtype,
                                                    record_property):
    """``q`` within one LSB of the reference's encode (XLA's jitted
    division rounds a tie now and then where the eager one does not),
    ``s`` at rtol 1e-6; the share of elements one LSB apart is recorded
    (``lsb_share``) and must stay rare."""
    x = codec_rows(dtype)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    enc = jax.jit(jquant.rowwise_absmax_encode) if jitted \
        else jquant.rowwise_absmax_encode
    want = enc(jnp.asarray(x, jdt))
    got = quant.rowwise_absmax_encode(torch.from_numpy(x).to(tdt))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    dq = np.abs(got["q"].numpy().astype(np.int32)
                - np.asarray(want["q"]).astype(np.int32))
    share = float((dq > 0).mean())
    record_property("lsb_share", share)
    assert dq.max() <= 1 and share <= 1e-3, (dq.max(), share)
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                               rtol=1e-6, atol=0)


def test_codec_zero_rows_and_half_step_bound():
    x = codec_rows("float32")
    enc = quant.rowwise_absmax_encode(torch.from_numpy(x))
    q, s = enc["q"], enc["s"]
    assert (s[3] == 1).all() and (q[3] == 0).all()
    assert torch.isfinite(s).all()
    dec = quant.rowwise_absmax_decode(q, s)
    assert (torch.from_numpy(x) - dec).abs().le(s[..., None] / 2 + 1e-7).all()
    # every nonzero row's absmax maps to exactly +-127
    nz = torch.from_numpy(np.abs(x).max(-1) > 0)
    assert (q.abs().amax(-1)[nz] == 127).all()
    # the decode side and the cache helpers are the same codec
    assert torch.equal(tdec.kv_dequantize(enc), dec)
    assert torch.equal(tdec.kv_quantize(torch.from_numpy(x))["q"], q)
    dense = torch.from_numpy(x).to(torch.bfloat16)
    assert tdec.kv_dequantize(dense).dtype == torch.float32


# ---------------------------------------------------------------------------
# page arithmetic and the registry's codec rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("L,Hkv,hd", [(16, 16, 128), (4, 8, 64), (2, 2, 16)])
def test_page_arithmetic_matches_the_reference(codec, L, Hkv, hd):
    assert paging.kv_bytes_per_el(codec, hd) == \
        jpaging.kv_bytes_per_el(codec, hd)
    assert paging.kv_bytes_per_token(L, Hkv, hd, codec) == \
        jpaging.kv_bytes_per_token(L, Hkv, hd, codec)
    budget = jpaging.pool_hbm_mib(32, 32, L, Hkv, hd)
    assert paging.pool_hbm_mib(32, 32, L, Hkv, hd) == budget
    assert paging.pages_for_hbm(budget, 32, L, Hkv, hd, codec=codec) == \
        jpaging.pages_for_hbm(budget, 32, L, Hkv, hd, codec=codec)


def test_flagship_pool_doubles_at_equal_hbm():
    """``infer --mode serve --paged`` at the flagship (16 layers, 16 kv
    heads of 128, 4 slots x 256 rows): 32 bf16 pages buy 62 int8 pages."""
    budget = paging.pool_hbm_mib(paging.pages_for_rows(4 * 256, 32), 32, 16,
                                 16, 128)
    assert paging.pages_for_hbm(budget, 32, 16, 16, 128) == 32
    assert paging.pages_for_hbm(budget, 32, 16, 16, 128, codec="int8") == 62
    assert paging.kv_bytes_per_el("int8", 128) == 1 + 4 / 128


@pytest.mark.parametrize("impl", ["auto", "paged", "xla"])
@pytest.mark.parametrize("codec", [None, "bf16", "int8"])
def test_paged_codec_rows_match_the_reference(impl, codec):
    """On the card the port decides as the reference does on its chip
    (the int8 rows carry the ``-int8`` suffix); on the CPU ``auto``
    degrades to the gather read and an explicit kernel raises."""
    assert treg.decide(treg.KIND_PAGED, impl=impl, platform="cuda",
                       codec=codec) == \
        jreg.decide(jreg.KIND_PAGED, impl=impl, platform="tpu",
                    paged_importable=True, codec=codec)
    if impl == "paged":
        with pytest.raises(treg.KernelUnavailable):
            treg.decide(treg.KIND_PAGED, impl=impl, platform="cpu",
                        codec=codec)
    else:
        assert treg.decide(treg.KIND_PAGED, impl=impl, platform="cpu",
                           codec=codec) == \
            jreg.decide(jreg.KIND_PAGED, impl=impl, platform="cpu",
                        paged_importable=True, codec=codec)


def test_codec_is_validated_like_the_reference():
    with pytest.raises(ValueError, match="codec"):
        treg.decide(treg.KIND_PAGED, platform="cuda", codec="fp4")
    with pytest.raises(ValueError, match="kind='paged'"):
        treg.decide(treg.KIND_PREFILL, platform="cuda", codec="int8")
    assert consts.KV_CODECS == jconsts.KV_CODECS
    assert consts.ERR_KV_CODEC_MISMATCH_FMT == \
        jconsts.ERR_KV_CODEC_MISMATCH_FMT
    cfg = tt.TransformerConfig(dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_codec"):
        tdec.check_paged_config(cfg, kv_codec="fp4")
    with pytest.raises(ValueError, match="kv codec mismatch"):
        tdec.check_paged_config(dataclasses.replace(cfg, kv_int8=True),
                                kv_codec="int8")
    assert tpaged.resolve_paged_impl("xla", "cpu", "int8") == "xla"
    with pytest.raises(treg.KernelUnavailable):
        tpaged.resolve_paged_impl("paged", "cpu", "int8")


# ---------------------------------------------------------------------------
# layouts, the install rule and the cached core
# ---------------------------------------------------------------------------

JCFG = jt.TransformerConfig(vocab=64, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=64, max_seq=64,
                            dtype=jnp.float32, kv_int8=True)
CFG = as_torch_cfg(JCFG)


def test_cache_and_pool_layouts_match_the_reference():
    jc, tc = jdec.init_cache(JCFG, 3, 32), tdec.init_cache(CFG, 3, 32,
                                                           device="cpu")
    pcfg, jpcfg = (dataclasses.replace(c, kv_int8=False) for c in (CFG, JCFG))
    jp = jdec.init_page_pool(jpcfg, 7, 8, kv_codec="int8")
    tp = tdec.init_page_pool(pcfg, 7, 8, kv_codec="int8", device="cpu")
    for j, t in ((jc["k"], tc["k"]), (jc["v"], tc["v"]), (jp["k"], tp["k"]),
                 (jp["v"], tp["v"])):
        for plane, dtype in (("q", torch.int8), ("s", torch.float32)):
            assert tuple(t[plane].shape) == j[plane].shape
            assert t[plane].dtype == dtype
            np.testing.assert_array_equal(t[plane].numpy(),
                                          np.asarray(j[plane]))
    assert tdec.cache_max_seq(tc) == jdec.cache_max_seq(jc) == 32
    assert tdec.pool_page_size(tp["k"]) == jdec.pool_page_size(jp["k"]) == 8
    assert tdec.pool_page_size(tdec.kv_view(tp["k"], 0)) == 8


def test_pool_install_quantizes_once_like_the_reference():
    """The install stores exactly ``kv_quantize`` of the scratch rows (the
    one codec, whichever path wrote the page), within one LSB of the
    reference's jitted install."""
    pcfg = dataclasses.replace(CFG, kv_int8=False)
    rng = np.random.default_rng(5)
    scratch = rng.standard_normal((2, 1, 24, 2, 64)).astype(np.float32)
    ids = np.array([1, 4], np.int64)
    pool = tdec.init_page_pool(pcfg, 6, 8, kv_codec="int8", device="cpu")
    tdec.scatter_scratch_pages(pool["k"], torch.from_numpy(scratch),
                               torch.from_numpy(ids), skip_pages=1)
    chunk = scratch[:, 0, 8:24].reshape(2, 2, 8, 2, 64)
    want = tdec.kv_quantize(torch.from_numpy(chunk))
    assert torch.equal(pool["k"]["q"][:, ids], want["q"])
    assert torch.equal(pool["k"]["s"][:, ids], want["s"])
    assert (pool["k"]["s"][:, [0, 2, 3, 5]] == 1).all()     # untouched
    jpool = jdec.init_page_pool(dataclasses.replace(JCFG, kv_int8=False), 6,
                                8, kv_codec="int8")
    jk, _ = _install_pages(jpool["k"], jpool["v"],
                           jnp.asarray(scratch[:, :, 8:]),
                           jnp.zeros_like(jnp.asarray(scratch[:, :, 8:])),
                           jnp.asarray(ids, jnp.int32))
    dq = np.abs(pool["k"]["q"].numpy().astype(np.int32)
                - np.asarray(jk["q"]).astype(np.int32))
    assert dq.max() <= 1
    np.testing.assert_allclose(pool["k"]["s"].numpy(), np.asarray(jk["s"]),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["chunk", "per-row", "ring-straddle"])
def test_cached_core_int8_matches_the_reference(case):
    """The quantized branch of ``make_cached_attn_core`` against the
    reference's on the same carried cache and the same new rows: the
    written planes within one LSB, the outputs within READ_ATOL of the
    reference's output (both read the planes they wrote)."""
    B, S, G = 2, 32, 2
    cfg, jcfg = CFG, JCFG
    if case == "ring-straddle":
        cfg, jcfg = (dataclasses.replace(c, attn_window=16)
                     for c in (CFG, JCFG))
    jk, tk = quantized_pair((B, S, 2, 64), 1)
    jv, tv = quantized_pair((B, S, 2, 64), 2)
    rng = np.random.default_rng(3)
    Q = 1 if case == "per-row" else 5
    q = rng.standard_normal((B, Q, 2 * G, 64)).astype(np.float32)
    k, v = (rng.standard_normal((B, Q, 2, 64)).astype(np.float32)
            for _ in range(2))
    if case == "per-row":
        pos = np.array([3, 30], np.int32)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jpos = tpos = 29 if case == "ring-straddle" else 11
    jcore = jdec.make_cached_attn_core(jk, jv, jpos, jcfg, jnp.arange(S))
    tcore = tdec.make_cached_attn_core(tk, tv, tpos, cfg, torch.arange(S))
    jo, (jk2, _) = jcore(*(jnp.asarray(x) for x in (q, k, v)))
    to, (tk2, _) = tcore(*(torch.from_numpy(x) for x in (q, k, v)))
    assert tk2 is tk                      # written in place
    dq = np.abs(tk["q"].numpy().astype(np.int32)
                - np.asarray(jk2["q"]).astype(np.int32))
    assert dq.max() <= 1
    np.testing.assert_allclose(tk["s"].numpy(), np.asarray(jk2["s"]),
                               rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=READ_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the K5 int8 twin: the paged gather read
# ---------------------------------------------------------------------------

def paged_inputs(H=4, Hkv=2, hd=128, seed=0):
    n_pages, ps, B = 9, 16, 2
    jkp, tkp = quantized_pair((n_pages, ps, Hkv, hd), seed)
    jvp, tvp = quantized_pair((n_pages, ps, Hkv, hd), seed + 1)
    q1 = np.random.default_rng(seed + 2).standard_normal(
        (B, H, hd)).astype(np.float32)
    tables = np.array([[1, 2, 3, 4], [1, 2, 7, 8]], np.int32)   # aliased
    lens = np.array([20, 64], np.int32)
    return (jkp, jvp, tkp, tvp, q1, tables, lens)


@pytest.mark.parametrize("H,Hkv,hd", [(4, 2, 128), (8, 8, 64), (8, 1, 128)])
def test_paged_int8_twin_matches_the_reference_gather_read(H, Hkv, hd):
    jkp, jvp, tkp, tvp, q1, tables, lens = paged_inputs(H, Hkv, hd)
    want = jpaged.xla_paged_read(jnp.asarray(q1)[:, None], jkp, jvp,
                                 jnp.asarray(tables), jnp.asarray(lens),
                                 H, Hkv)[:, 0]
    tq, ttab, tlen = (torch.from_numpy(x) for x in (q1, tables, lens))
    got = tpaged.xla_paged_read(tq[:, None], tkp, tvp, ttab, tlen, H,
                                Hkv)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=READ_ATOL, rtol=0)
    # a CPU tensor through the kernel's wrapper and the registry's read
    # takes this twin
    assert torch.equal(tpaged.paged_decode(tq, tkp, tvp, ttab, tlen), got)
    cfg = tt.TransformerConfig(vocab=8, d_model=H * hd, n_heads=H,
                               n_kv_heads=Hkv, n_layers=1, d_ff=8,
                               dtype=torch.float32)
    read = tpaged.paged_attention_read(tq[:, None], tkp, tvp, ttab, tlen,
                                       cfg, impl="xla")
    assert torch.equal(read[:, 0], got)


def test_paged_int8_twin_matches_the_reference_pallas_rung():
    """The twin against the reference's Pallas int8 rung (upstream
    QuantizedTensor pages with its /127.5 scale adapter) run in interpret
    mode on the same carried planes, patched and skipped as the
    reference's own parity test (``tests/test_kv_codec.py``) is."""
    if not jreg.paged_kernel_importable():
        pytest.skip("upstream paged-attention kernel unimportable")
    from jax.experimental import pallas as pl
    jkp, jvp, tkp, tvp, q1, tables, lens = paged_inputs()
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    read = jreg._build_paged_pallas(None, "tp", "int8")
    try:
        with mock.patch.object(pl, "pallas_call", patched):
            want = np.asarray(read(jnp.asarray(q1), jkp, jvp,
                                   jnp.asarray(tables), jnp.asarray(lens)))
    except Exception as e:  # noqa: BLE001 — interpret gaps vary by jax
        pytest.skip(f"pallas interpret mode unavailable here: {e}")
    got = tpaged.xla_paged_read(torch.from_numpy(q1)[:, None], tkp, tvp,
                                torch.from_numpy(tables),
                                torch.from_numpy(lens), 4, 2)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=PALLAS_INT8_TOL,
                               rtol=PALLAS_INT8_TOL)


# ---------------------------------------------------------------------------
# the K4 int8 twin: the ragged read
# ---------------------------------------------------------------------------

RB, RS, RHD = 3, 512, 128
RLENGTHS = np.array([0, 200, 511], np.int32)


def ragged_inputs(h, hkv, layers=None, seed=0):
    lead = () if layers is None else (layers,)
    jk, tk = quantized_pair(lead + (RB, RS, hkv, RHD), seed)
    jv, tv = quantized_pair(lead + (RB, RS, hkv, RHD), seed + 1)
    q = np.random.default_rng(seed + 2).standard_normal(
        (RB, h, RHD)).astype(np.float32)
    return (jnp.asarray(q), jk, jv), (torch.from_numpy(q), tk, tv)


@pytest.mark.parametrize("h,hkv", [(4, 1), (4, 4), (8, 2)])
def test_ragged_int8_twin_matches_the_reference_kernel(h, hkv):
    """The twin against the reference's Pallas ragged kernel on codec
    dicts in interpret mode (``tests/test_ragged_decode.py``'s
    ``test_kernel_int8_codec``), on the same planes."""
    (jq, jk, jv), (tq, tk, tv) = ragged_inputs(h, hkv)
    want = jrag.ragged_decode_attention(jq, jk, jv, jnp.asarray(RLENGTHS),
                                        block_k=128)
    got = trag.ragged_decode_attention(tq, tk, tv,
                                       torch.from_numpy(RLENGTHS))
    assert got.shape == (RB, h, RHD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=READ_ATOL, rtol=0)


@pytest.mark.parametrize("layer", [0, 2])
def test_ragged_int8_stacked_entry_reads_the_layer(layer):
    (jq, jk, jv), (tq, tk, tv) = ragged_inputs(8, 2, layers=3, seed=4)
    lengths = np.array([7, 300, 0], np.int32)
    want = jrag.ragged_decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                        layer=layer, block_k=256)
    got = trag.ragged_decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                                       layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=READ_ATOL, rtol=0)
    dense = trag.ragged_decode_plain(tq, tdec.kv_view(tk, layer),
                                     tdec.kv_view(tv, layer),
                                     torch.from_numpy(lengths))
    assert torch.equal(got, dense)


def test_ragged_int8_result_is_independent_of_capacity():
    """The same live rows in a 2x-larger codec cache: bitwise equal on the
    reference's kernel; the port's twin agrees with it either way."""
    (jq, jk, jv), (tq, tk, tv) = ragged_inputs(8, 2, seed=6)
    lengths = np.array([0, 17, 255], np.int32)

    def grow_j(leaf):
        return {"q": jnp.zeros((RB, 2 * RS, 2, RHD), jnp.int8)
                .at[:, :RS].set(leaf["q"]),
                "s": jnp.ones((RB, 2 * RS, 2)).at[:, :RS].set(leaf["s"])}

    def grow_t(leaf):
        big = {"q": torch.zeros((RB, 2 * RS, 2, RHD), dtype=torch.int8),
               "s": torch.ones((RB, 2 * RS, 2))}
        big["q"][:, :RS], big["s"][:, :RS] = leaf["q"], leaf["s"]
        return big

    lj, lt = jnp.asarray(lengths), torch.from_numpy(lengths)
    ja = jrag.ragged_decode_attention(jq, jk, jv, lj, block_k=128)
    jb = jrag.ragged_decode_attention(jq, grow_j(jk), grow_j(jv), lj,
                                      block_k=128)
    assert jnp.array_equal(ja, jb)
    ta = trag.ragged_decode_attention(tq, tk, tv, lt)
    tb = trag.ragged_decode_attention(tq, grow_t(tk), grow_t(tv), lt)
    np.testing.assert_allclose(ta.numpy(), tb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=READ_ATOL,
                               rtol=0)


def test_ragged_int8_twin_is_the_cached_cores_per_row_read():
    """Bitwise the dense per-row core's quantized read over the same
    written cache: what keeps the int8 ragged and einsum slot engines
    token-identical on the CPU."""
    _, (_, kc, vc) = ragged_inputs(4, 2, seed=8)
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((RB, 1, h, RHD))
                                .astype(np.float32)) for h in (4, 2, 2))
    cfg = tt.TransformerConfig(vocab=64, d_model=512, n_heads=4,
                               n_kv_heads=2, n_layers=1, d_ff=64,
                               max_seq=RS, dtype=torch.float32, kv_int8=True)
    pos = torch.from_numpy(RLENGTHS)
    core = tdec.make_cached_attn_core(kc, vc, pos, cfg, torch.arange(RS))
    dense, (kc2, vc2) = core(q, k, v)
    assert torch.equal(dense[:, 0],
                       trag.ragged_decode_plain(q[:, 0], kc2, vc2, pos))


# ---------------------------------------------------------------------------
# the CPU never reaches the CUDA rungs; reference state carries across
# ---------------------------------------------------------------------------

def test_cpu_codec_leaves_never_reach_the_kernels(monkeypatch):
    from tpushare_torch.workloads.kernels import build

    def refuse(name):
        raise AssertionError(f"kernel {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(build, "library", refuse)
    before = dict(build.LAUNCHES)
    _, _, tkp, tvp, q1, tables, lens = paged_inputs()
    tpaged.paged_decode(torch.from_numpy(q1), tkp, tvp,
                        torch.from_numpy(tables), torch.from_numpy(lens))
    _, (tq, tk, tv) = ragged_inputs(4, 2)
    trag.ragged_decode_attention(tq, tk, tv, torch.from_numpy(RLENGTHS))
    assert build.LAUNCHES == before
    assert {"paged_decode_int8", "ragged_decode_int8"} <= set(build.KERNELS)


def test_kv_from_numpy_carries_int8_planes_and_length():
    cache = jdec.init_cache(JCFG, 2, 16)
    jk, _ = quantized_pair((2, 2, 16, 2, 64), 11)
    cache = {**cache, "k": jk, "length": jnp.asarray(5, jnp.int32)}
    got = bridge.kv_from_numpy(jax.tree.map(np.asarray, cache),
                               device="cpu")
    assert got["length"] == 5 and isinstance(got["length"], int)
    assert got["k"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["k"]["q"].numpy(),
                                  np.asarray(jk["q"]))
    np.testing.assert_array_equal(got["k"]["s"].numpy(),
                                  np.asarray(jk["s"]))
    pool = jdec.init_page_pool(dataclasses.replace(JCFG, kv_int8=False), 3,
                               8, kv_codec="int8")
    tpool = bridge.kv_from_numpy(jax.tree.map(np.asarray, pool),
                                 device="cpu")
    assert set(tpool) == {"k", "v"} and tpool["v"]["s"].shape == (2, 3, 8, 2)


def test_generate_over_an_int8_cache_matches_the_reference():
    """``decode.generate`` with ``cfg.kv_int8``: the prompt prefills in
    full precision and fills the cache quantized, then each step writes
    and reads int8. Teacher-forced logits within the int8 engine
    tolerance of the reference's, and the greedy streams equal up to a
    reference near-tie (``torch_int8_replay``)."""
    import torch_int8_replay as replay
    tol = 5e-3          # as the int8 engine tests: one-LSB codec flips
    jcfg = jt.TransformerConfig(vocab=256, d_model=256, n_heads=2,
                                n_kv_heads=1, n_layers=2, d_ff=512,
                                max_seq=128, dtype=jnp.float32, kv_int8=True)
    tcfg = as_torch_cfg(jcfg)
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    p = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 19))
    want = np.asarray(jdec.generate(jparams, jnp.asarray(p, jnp.int32), jcfg,
                                    24))
    got = tdec.generate(tparams, torch.from_numpy(p), tcfg, 24).numpy()

    def forced(dec, step, params, cfg, arr, **kw):
        cache = dec.init_cache(cfg, 2, 128, **kw)
        lg, cache = dec.prefill(params, arr(p), cfg, cache)
        rows = [np.asarray(lg, np.float32)]
        for t in want.T[:-1]:
            lg, cache = step(params, arr(t), cache, cfg)
            rows.append(np.asarray(lg, np.float32))
        return np.stack(rows, axis=1)                  # (B, steps, vocab)

    jw = forced(jdec, jax.jit(jdec.decode_step, static_argnames=("cfg",)),
                jparams, jcfg, lambda x: jnp.asarray(x, jnp.int32))
    tg = forced(tdec, tdec.decode_step, tparams, tcfg,
                lambda x: torch.from_numpy(np.array(x)), device="cpu")
    for b in range(2):
        replay.assert_logits_agree(tg[b], jw[b], tol)
        replay.assert_transcripts_agree(got[b].tolist(), want[b].tolist(),
                                        jw[b], tol)
