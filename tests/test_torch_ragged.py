"""The port's ragged decode read held against the JAX reference on the
CPU: ``ragged_decode_plain`` (what a CPU tensor gets from the kernel's
wrapper) against the reference's Pallas ``ragged_decode_attention`` run
in interpret mode, as ``tests/test_ragged_decode.py`` runs it — dense
and stacked caches, GQA, capacity independence — and the decode rows of
the registry against the reference's, reason for reason."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.ops import ragged_decode as jrag  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import ragged_decode as trag  # noqa: E402
from tpushare_torch.workloads.ops import registry as treg  # noqa: E402

B, S, HD = 3, 512, 128
LENGTHS = np.array([0, 200, 511], np.int32)
# f32: the same fp32 einsum/softmax on both sides, summation order only.
# bf16: both compute in fp32 and round the output once, so a sound twin
# differs by at most one bf16 ulp (2^-7 of the value), held element by
# element as a share of max(|value|, 2^-8 x the largest |value|).
F32_ATOL = 1e-5
BF16_SHARE, BF16_FLOOR = 1e-2, 2 ** -8


def inputs(h, hkv, dtype, layers=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    q = rng.standard_normal((B, h, HD)).astype(np.float32)
    k = rng.standard_normal(lead + (B, S, hkv, HD)).astype(np.float32)
    v = rng.standard_normal(lead + (B, S, hkv, HD)).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    # round through the working dtype once so both sides see equal values
    q, k, v = (np.array(jnp.asarray(x, jd).astype(jnp.float32))
               for x in (q, k, v))
    jx = [jnp.asarray(x, jd) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    return jx, tx


def assert_matches(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        floor = BF16_FLOOR * np.abs(want).max()
        share = np.abs(got - want) / np.maximum(np.abs(want), floor)
        assert share.max() <= BF16_SHARE, share.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv", [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2),
                                   (8, 4)])
def test_plain_matches_reference_kernel(h, hkv, dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(h, hkv, dtype)
    want = jrag.ragged_decode_attention(jq, jk, jv, jnp.asarray(LENGTHS))
    got = trag.ragged_decode_attention(tq, tk, tv, torch.from_numpy(LENGTHS))
    assert got.dtype == tq.dtype and got.shape == (B, h, HD)
    assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_stacked_cache_entry_reads_the_layer(layer, dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(8, 2, dtype, layers=3, seed=1)
    lengths = np.array([7, 300, 0], np.int32)
    want = jrag.ragged_decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                        layer=layer, block_k=256)
    got = trag.ragged_decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                                       layer=layer)
    assert_matches(got, want, dtype)
    # the stacked entry is the dense read of that layer
    dense = trag.ragged_decode_plain(tq, tk[layer], tv[layer],
                                     torch.from_numpy(lengths))
    assert torch.equal(got, dense)


def test_result_is_independent_of_cache_capacity():
    """The same live rows in a 2x-larger cache give bitwise-equal
    outputs — on the reference's kernel and on the port's twin — and the
    two agree."""
    (jq, jk, jv), (tq, tk, tv) = inputs(8, 2, "float32", seed=2)
    lengths = np.array([0, 17, 255], np.int32)
    jk2 = jnp.zeros((B, 2 * S, 2, HD)).at[:, :S].set(jk)
    jv2 = jnp.zeros((B, 2 * S, 2, HD)).at[:, :S].set(jv)
    tk2 = torch.zeros((B, 2 * S, 2, HD))
    tv2 = torch.zeros((B, 2 * S, 2, HD))
    tk2[:, :S], tv2[:, :S] = tk, tv
    lens_j, lens_t = jnp.asarray(lengths), torch.from_numpy(lengths)
    ja = jrag.ragged_decode_attention(jq, jk, jv, lens_j)
    jb = jrag.ragged_decode_attention(jq, jk2, jv2, lens_j)
    assert jnp.array_equal(ja, jb)
    ta = trag.ragged_decode_attention(tq, tk, tv, lens_t)
    tb = trag.ragged_decode_attention(tq, tk2, tv2, lens_t)
    np.testing.assert_allclose(ta.numpy(), tb.numpy(), atol=1e-6, rtol=0)
    assert_matches(ta, ja, "float32")


def test_plain_is_the_cached_cores_per_row_read():
    """The twin is the dense per-row core op for op: the same read over
    the same written cache gives bitwise-equal outputs, which keeps the
    ragged and dense slot engines token-identical on the CPU."""
    cfg = tt.TransformerConfig(vocab=64, d_model=512, n_heads=4,
                               n_kv_heads=2, n_layers=1, d_ff=64,
                               max_seq=S, dtype=torch.float32)
    rng = np.random.default_rng(3)
    kc = torch.from_numpy(rng.standard_normal((B, S, 2, HD))
                          .astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, S, 2, HD))
                          .astype(np.float32))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 1, h, HD))
                                .astype(np.float32)) for h in (4, 2, 2))
    pos = torch.from_numpy(LENGTHS)
    core = tdec.make_cached_attn_core(kc.clone(), vc.clone(), pos, cfg,
                                      torch.arange(S))
    dense, (kc2, vc2) = core(q, k, v)
    ragged = trag.ragged_decode_plain(q[:, 0], kc2, vc2, pos)
    assert torch.equal(dense[:, 0], ragged)


DECODE_ROWS = [  # decide() keywords
    dict(seq=512, n_heads=16, head_dim=128),
    dict(seq=512, n_heads=16, n_kv_heads=4, head_dim=128),
    dict(seq=512, window=64, n_heads=16, head_dim=128),
    dict(seq=512, n_heads=8, head_dim=64),
    dict(seq=300, n_heads=16, head_dim=128),
    dict(seq=512, n_heads=16, head_dim=128, impl="xla"),
]


@pytest.mark.parametrize("kw", DECODE_ROWS)
def test_decode_rows_match_the_reference(kw):
    """``auto`` on the card decides as the reference does on its chip;
    an explicit ragged read raises for the same configs with the same
    detail, and is taken for the rest."""
    assert treg.decide(treg.KIND_DECODE, platform="cuda", **kw) == \
        jreg.decide(jreg.KIND_DECODE, platform="tpu", **kw)
    assert treg.decide(treg.KIND_DECODE, platform="cpu", **kw) == \
        jreg.decide(jreg.KIND_DECODE, platform="cpu", **kw)
    if kw.get("impl") == "xla":
        return
    ekw = {**kw, "impl": "ragged"}
    try:
        want = jreg.decide(jreg.KIND_DECODE, **ekw)
    except jreg.KernelUnavailable as e:
        with pytest.raises(treg.KernelUnavailable) as got:
            treg.decide(treg.KIND_DECODE, **ekw)
        assert got.value.detail == e.detail
    else:
        assert treg.decide(treg.KIND_DECODE, **ekw) == want


@pytest.mark.parametrize("field,value,rows", [
    ("attn_window", 32, 512),
    ("n_heads", 4, 512),          # head_dim 64
    (None, None, 300),            # rows not a multiple of 256
    (None, None, 512),            # servable
])
def test_check_ragged_config_rejects_what_the_reference_rejects(field, value,
                                                                rows):
    jcfg = jt.TransformerConfig(vocab=64, d_model=256, n_heads=2,
                                n_layers=1, d_ff=64)
    if field is not None:
        jcfg = dataclasses.replace(jcfg, **{field: value})
    tcfg = tt.TransformerConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)},
                                   "dtype": torch.bfloat16})
    try:
        jdec.check_ragged_config(jcfg, rows)
    except jreg.KernelUnavailable as e:
        with pytest.raises(treg.KernelUnavailable) as got:
            tdec.check_ragged_config(tcfg, rows)
        assert got.value.detail == e.detail
    else:
        tdec.check_ragged_config(tcfg, rows)
    assert tdec.ragged_block_k(512) == jdec.ragged_block_k(512)
    assert tdec.ragged_block_k(768) == jdec.ragged_block_k(768) == 256


def test_auto_degradation_is_counted_under_ragged():
    treg.reset_fallbacks()
    choice = treg.select_attention(treg.KIND_DECODE, seq=512, n_heads=16,
                                   head_dim=128, platform="cpu")
    assert choice.impl == "xla" and choice.fn is tdec.make_cached_attn_core
    treg.select_attention(treg.KIND_DECODE, seq=512, window=64, n_heads=16,
                          head_dim=128, platform="cuda")
    assert treg.fallback_counts() == {("ragged", "platform:cpu"): 1,
                                      ("ragged", "window:ring-cache"): 1}
    explicit = treg.select_attention(treg.KIND_DECODE, impl="ragged",
                                     seq=512, n_heads=16, head_dim=128,
                                     platform="cpu")
    assert (explicit.impl, explicit.reason) == ("ragged", "explicit:ragged")
    assert explicit.fn is trag.ragged_decode_attention
    assert treg.fallback_counts() == {("ragged", "platform:cpu"): 1,
                                      ("ragged", "window:ring-cache"): 1}
    treg.reset_fallbacks()


def test_cpu_tensors_never_reach_the_ragged_kernel(monkeypatch):
    """A CPU tensor takes the twin without loading the kernel library,
    and counts no launch — through the wrapper and through a ragged
    slot engine's decode steps."""
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.serving import Request, ServingEngine

    def refuse(name):
        raise AssertionError(f"kernel {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(build, "library", refuse)
    before = dict(build.LAUNCHES)
    (_, _, _), (tq, tk, tv) = inputs(4, 2, "float32")
    lengths = torch.from_numpy(LENGTHS)
    assert torch.equal(trag.ragged_decode_attention(tq, tk, tv, lengths),
                       trag.ragged_decode_plain(tq, tk, tv, lengths))
    cfg = tt.TransformerConfig(vocab=64, d_model=256, n_heads=2, n_layers=1,
                               d_ff=64, max_seq=256, dtype=torch.float32,
                               ragged_decode=True)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = ServingEngine(params, cfg, n_slots=2, max_seq=256,
                        prompt_buckets=(16,), chunk=2)
    req = Request(prompt=[1, 2, 3], max_new=5)
    eng.submit(req)
    eng.run()
    assert eng.attn_impl == "ragged" and len(req.output) == 5
    assert build.LAUNCHES == before
