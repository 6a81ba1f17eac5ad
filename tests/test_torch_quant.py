"""The port's int8 weights (``tpushare_torch/workloads/quant.py`` and the
``mm`` hooks) held against the JAX reference on the CPU:

- ``quantize``, ``quantize_rows``, ``quantize_params`` within one LSB of
  the reference's ``q`` with equal scales, ``dequantize_params`` and
  ``quantized_param_bytes`` equal, ``{q, s}`` leaves crossing ``bridge``
  as int8 and fp32;
- ``qmm``: the fp32 product rescaled before the one cast (a product
  rounded to bf16 first fails the same limit), its backward against
  ``jax.vjp``, and what autograd saves: the int8 leaf, no bf16 copy;
- f32 ``forward``, ``qprefill`` and ``qdecode_step`` logits within 1e-4
  of the reference's over the same bridged ``{q, s}`` weights, greedy
  ``qgenerate`` tokens equal;
- both engines over ``mm=qmm`` against the reference engines' f32
  transcripts (slot, ragged read, ring cache, paged on the bf16 and the
  int8 pool, prefix subscribers on both engines), and ``infer --int8`` in
  every mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import quant as jquant  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, infer, quant  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request, ServingEngine)

# f32 logits over the same int8 weights: the packages differ only in
# summation order
LOGIT_TOL = 1e-4
# an int8 KV pool on top: a K/V element one LSB apart (a rounding tie the
# packages break differently) moves logprobs by ~1e-4-1e-3 at this size
# (the int8 pool tests' INT8_LOGIT_TOL)
INT8_KV_LOGP_TOL = 5e-3
# head_dim 128 so the slot engine's ragged read serves this config
JCFG = jt.TransformerConfig(vocab=256, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=512, max_seq=256,
                            dtype=jnp.float32)


def torch_cfg(jcfg):
    return tt.TransformerConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)},
                                   "dtype": bridge.torch_dtype(
                                       jnp.dtype(jcfg.dtype).name)})


CFG = torch_cfg(JCFG)
JQPARAMS = jquant.quantize_params(jt.init_params(jax.random.key(0), JCFG))
QPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JQPARAMS),
                                   device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_telemetry_provider():
    yield
    from tpushare.workloads.telemetry import set_snapshot_provider
    set_snapshot_provider(None)


def rand_prompt(seed, n):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, JCFG.vocab, n)]


def to_np(t):
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_the_reference(dtype):
    """Per-channel (stacked (L, D, N): one scale set per layer) and
    per-row quantizers: q within one LSB (round(x / s) may land on the
    other side of a .5 tie), s equal, a zero channel at scale 1."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 48, 40)).astype(np.float32)
    w[1, :, 5] = 0.0
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = bridge.tensor_from_numpy(np.asarray(jw), "cpu")
    for jfn, tfn in ((jquant.quantize, quant.quantize),
                     (jquant.quantize_rows, quant.quantize_rows)):
        want, got = jfn(jw), tfn(tw)
        assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
        assert got["s"].shape == want["s"].shape
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        dq = np.abs(got["q"].numpy().astype(int)
                    - np.asarray(want["q"]).astype(int))
        assert dq.max() <= 1
    assert float(quant.quantize(tw)["s"][1, 0, 5]) == 1.0


def test_quantize_params_and_bytes_match_the_reference():
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    want, got = jquant.quantize_params(jparams), quant.quantize_params(tparams)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, ref in flat:
        node = got
        for key in path:
            node = node[key.key]
        ref = np.asarray(ref)
        if path[-1].key == "q":
            assert node.dtype == torch.int8
            assert np.abs(node.numpy().astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(to_np(node), ref.astype(np.float32))
    # the same {q, s} through dequantize_params: equal to the reference's
    deq = quant.dequantize_params(QPARAMS, torch.float32)
    jdeq = jquant.dequantize_params(JQPARAMS, jnp.float32)
    for name in ("wq", "w2"):
        np.testing.assert_array_equal(deq["layers"][name].numpy(),
                                      np.asarray(jdeq["layers"][name]))
    np.testing.assert_array_equal(deq["embed"].numpy(),
                                  np.asarray(jdeq["embed"]))
    # the byte count: the reference's, and the tensors' own at bf16
    tcfg = torch_cfg(jcfg)
    n_bytes = sum(infer._tensor_bytes(got))
    assert quant.quantized_param_bytes(tcfg) == \
        jquant.quantized_param_bytes(jcfg) == n_bytes
    gqa = dataclasses.replace(jcfg, n_kv_heads=None, n_heads=4)
    assert quant.quantized_param_bytes(torch_cfg(gqa)) == \
        jquant.quantized_param_bytes(gqa)


def test_bridge_carries_int8_leaves_as_int8():
    leaf = QPARAMS["layers"]["wq"]
    assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
    assert leaf["q"].shape == (2, 256, 256) and leaf["s"].shape == (2, 1, 256)
    assert QPARAMS["embed"]["s"].shape == (JCFG.vocab, 1)
    np.testing.assert_array_equal(leaf["q"].numpy(),
                                  np.asarray(JQPARAMS["layers"]["wq"]["q"]))


# ---------------------------------------------------------------------------
# qmm
# ---------------------------------------------------------------------------

def qmm_case(seed=1):
    """bf16 activations against one int8 layer leaf whose product has
    near-cancelling dots (the reference's flake case)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jleaf = jquant.quantize(jnp.asarray(w, jnp.bfloat16))
    jx = jnp.asarray(x, jnp.bfloat16)
    leaf = bridge.params_from_numpy(jax.tree.map(np.asarray, jleaf), "cpu")
    return jx, jleaf, bridge.tensor_from_numpy(np.asarray(jx), "cpu"), leaf


# qmm vs the reference's, bf16: the same fp32 sums in another order may
# round to the other bf16 neighbour now and then (none at these seeds on
# jax 0.9.0); a product rounded to bf16 before the rescale parts at
# ~25% of the elements
QMM_MISMATCH_SHARE = 0.01


@pytest.mark.parametrize("seed", [1, 2])
def test_qmm_keeps_the_fp32_accumulator_before_the_rescale(seed):
    """The port's bf16 qmm is the fp32 product rescaled in fp32, then one
    cast — the reference's order: the reference's result but for at most
    QMM_MISMATCH_SHARE of the elements, each within one bf16 ulp. The
    order the reference forbids (the product rounded to bf16 before the
    rescale) fails that rule."""
    jx, jleaf, x, leaf = qmm_case(seed)
    got = quant.qmm(x, leaf)
    assert got.dtype == torch.bfloat16
    y32 = x.float() @ leaf["q"].float()
    assert torch.equal(got, (y32 * leaf["s"].reshape(1, -1)).to(
        torch.bfloat16))
    want = np.asarray(jquant.qmm(jx, jleaf).astype(jnp.float32))

    def parts(y):
        y = y.float().numpy()
        assert (np.abs(y - want) <= 2.0 ** -7 * np.abs(want)).all()
        return (y != want).mean()

    early = ((x @ leaf["q"].to(torch.bfloat16)).float()
             * leaf["s"].reshape(1, -1)).to(torch.bfloat16)
    assert parts(got) <= QMM_MISMATCH_SHARE < parts(early)
    # a plain tensor passes through to @
    w = torch.randn(64, 8, dtype=torch.bfloat16)
    assert torch.equal(quant.qmm(x, w), x @ w)


def test_qmm_backward_matches_jax_vjp_and_saves_int8():
    """dx = (dy * s) @ q^T in fp32, then cast — jax.vjp of the reference's
    qmm on the same inputs, within one bf16 ulp; autograd keeps the int8
    leaf and its scales, never a bf16 copy of the weight."""
    jx, jleaf, x, leaf = qmm_case(2)
    dy = np.random.default_rng(3).standard_normal((3, 5, 48))
    jdy = jnp.asarray(dy, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: jquant.qmm(a, jleaf), jx)
    want = np.asarray(vjp(jdy)[0].astype(jnp.float32))
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    xg = x.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = quant.qmm(xg, leaf)
    y.backward(bridge.tensor_from_numpy(np.asarray(jdy), "cpu"))
    got = xg.grad.float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30).all()
    assert (torch.int8, (64, 48)) in saved
    assert not any(dt == torch.bfloat16 and shp == (64, 48)
                   for dt, shp in saved)


# ---------------------------------------------------------------------------
# the model over int8 weights
# ---------------------------------------------------------------------------

def test_forward_logits_match_the_reference():
    tokens = np.random.default_rng(4).integers(0, JCFG.vocab, (2, 24))
    want = np.asarray(jt.forward(JQPARAMS, jnp.asarray(tokens, jnp.int32),
                                 JCFG, mm=jquant.qmm))
    got = tt.forward(QPARAMS, torch.from_numpy(tokens), CFG, mm=quant.qmm)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # and not the dense model's logits: the int8 leaves were read
    dense = tt.forward(quant.dequantize_params(QPARAMS, torch.float32),
                       torch.from_numpy(tokens), CFG)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-3)


def test_qprefill_and_qdecode_step_match_the_reference():
    tokens = np.random.default_rng(5).integers(0, JCFG.vocab, (2, 9))
    jc = jdec.init_cache(JCFG, 2, 32)
    tc = tdec.init_cache(CFG, 2, 32, device="cpu")
    jl, jc = jquant.qprefill(JQPARAMS, jnp.asarray(tokens, jnp.int32), JCFG,
                             jc)
    tl, tc = quant.qprefill(QPARAMS, torch.from_numpy(tokens), CFG, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jl), -1)
    for _ in range(3):
        jl, jc = jquant.qdecode_step(JQPARAMS, jnp.asarray(nxt, jnp.int32),
                                     jc, JCFG)
        tl, tc = quant.qdecode_step(QPARAMS, torch.from_numpy(nxt), tc, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        nxt = np.argmax(np.asarray(jl), -1)


def test_qgenerate_greedy_tokens_equal():
    p = np.random.default_rng(6).integers(0, JCFG.vocab, (2, 11))
    want = np.asarray(jquant.qgenerate(JQPARAMS, jnp.asarray(p, jnp.int32),
                                       JCFG, 12))
    got = quant.qgenerate(QPARAMS, torch.from_numpy(p), CFG, 12)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# both engines over int8 weights
# ---------------------------------------------------------------------------

SLOT_KW = dict(n_slots=3, max_seq=256, prompt_buckets=(16, 32), chunk=4)
PAGED_KW = dict(n_lanes=3, max_seq=96, n_pages=40, page_size=8,
                prompt_buckets=(8, 32), chunk=4)
SPECS = [dict(prompt=rand_prompt(10 + i, 5 + 9 * i), max_new=6 + 3 * i)
         for i in range(4)]


def run_both(make, jmake, specs, prefixes=(), logp_tol=LOGIT_TOL):
    eng, jeng = make(), jmake()
    for name, toks in prefixes:
        eng.register_prefix(name, toks)
        jeng.register_prefix(name, toks)
    reqs = [Request(**s) for s in specs]
    jreqs = [jserving.Request(**s) for s in specs]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert r.status == consts.STATUS_COMPLETED
        assert r.output == jr.output
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=logp_tol)
    return eng, reqs


@pytest.mark.parametrize("read", ["einsum", "ragged", "ring"])
def test_slot_engine_over_int8_weights_matches_reference(read):
    jcfg, kw, specs = JCFG, dict(SLOT_KW), SPECS
    if read == "ragged":
        jcfg = dataclasses.replace(JCFG, ragged_decode=True)
    if read == "ring":
        jcfg = dataclasses.replace(JCFG, attn_window=32)
        kw.update(max_seq=160, prompt_buckets=(16,), ring_rows=48)
        specs = [dict(prompt=rand_prompt(88, 20), max_new=70),
                 dict(prompt=rand_prompt(89, 7), max_new=60)]
    eng, _ = run_both(
        lambda: ServingEngine(QPARAMS, torch_cfg(jcfg), mm=quant.qmm, **kw),
        lambda: jserving.ServingEngine(JQPARAMS, jcfg, mm=jquant.qmm, **kw),
        specs)
    assert eng.mm is quant.qmm
    assert eng.attn_impl == ("ragged" if read == "ragged" else "xla")


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_paged_engine_over_int8_weights_matches_reference(codec):
    """Both pool codecs under int8 weights, more requests than lanes,
    pages recycled: the reference's transcripts."""
    eng, _ = run_both(
        lambda: PagedServingEngine(QPARAMS, CFG, mm=quant.qmm,
                                   kv_codec=codec, **PAGED_KW),
        lambda: jserving.PagedServingEngine(JQPARAMS, JCFG, mm=jquant.qmm,
                                            kv_codec=codec,
                                            attn_impl="xla", **PAGED_KW),
        SPECS, logp_tol=INT8_KV_LOGP_TOL if codec == "int8" else LOGIT_TOL)
    assert eng.alloc.pages_in_use() == 0 and eng.alloc.leaked() == 0


@pytest.mark.parametrize("engine", ["slot", "paged-bf16", "paged-int8"])
def test_prefix_subscribers_over_int8_weights_match_reference(engine):
    """A registered prefix (prefilled through qmm) and its subscribers,
    beside a plain request: the reference engine's transcripts."""
    specs = [dict(prompt=rand_prompt(51, 5), max_new=8, prefix="sys"),
             dict(prompt=rand_prompt(52, 12), max_new=6, prefix="sys"),
             dict(prompt=rand_prompt(53, 9), max_new=7)]
    prefixes = [("sys", rand_prompt(50, 21))]
    if engine == "slot":
        make = lambda: ServingEngine(QPARAMS, CFG, mm=quant.qmm,  # noqa: E731
                                     **SLOT_KW)
        jmake = lambda: jserving.ServingEngine(  # noqa: E731
            JQPARAMS, JCFG, mm=jquant.qmm, **SLOT_KW)
    else:
        codec = engine.split("-")[1]
        make = lambda: PagedServingEngine(  # noqa: E731
            QPARAMS, CFG, mm=quant.qmm, kv_codec=codec, **PAGED_KW)
        jmake = lambda: jserving.PagedServingEngine(  # noqa: E731
            JQPARAMS, JCFG, mm=jquant.qmm, kv_codec=codec, attn_impl="xla",
            **PAGED_KW)
    eng, _ = run_both(make, jmake, specs, prefixes,
                      logp_tol=INT8_KV_LOGP_TOL if engine.endswith("int8")
                      else LOGIT_TOL)
    if engine != "slot":
        assert eng.stats["prefix_hits"] == 2


@pytest.mark.parametrize("flags", [
    ["--mode", "forward", "--batch", "2", "--seq", "24", "--steps", "1"],
    ["--mode", "decode", "--batch", "2", "--seq", "32", "--steps", "5"],
    ["--mode", "serve", "--steps", "6", "--requests", "2", "--seq", "40",
     "--slots", "2"],
    ["--mode", "serve", "--ragged", "--steps", "6", "--requests", "2",
     "--seq", "40", "--slots", "2"],
    ["--mode", "serve", "--paged", "--steps", "6", "--requests", "2",
     "--seq", "64", "--slots", "2"],
    ["--mode", "serve", "--kv-codec", "int8", "--steps", "6", "--requests",
     "2", "--seq", "64", "--slots", "2"],
])
def test_infer_int8_runs_in_every_mode(flags):
    """``infer --int8``: int8 weights in forward, decode and every serve
    engine (``--ragged`` quantizes the re-headed preset)."""
    res = infer.run(infer.parse_args(flags + ["--int8", "--device", "cpu"]))
    if res["mode"] == "forward":
        assert res["mm"] is quant.qmm
        assert res["params"]["layers"]["wq"]["q"].dtype == torch.int8
        assert torch.isfinite(res["logits"]).all()
    elif res["mode"] == "serve":
        eng = res["engine"]
        assert eng.mm is quant.qmm
        assert eng.params["out"]["q"].dtype == torch.int8
        assert all(r.status == consts.STATUS_COMPLETED
                   for r in res["requests"])
        if "--ragged" in flags:
            assert eng.attn_impl == "ragged" and eng.cfg.head_dim == 128
    assert res["tokens_per_s"] > 0
