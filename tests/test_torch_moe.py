"""The port's MoE model family (``models/moe.py``, ``moe_decode.py``,
``decode.model_layer``, MoE serving on both engines and
``train.make_moe_train_step``) held against the JAX reference on the
CPU, f32, bridged weights:

- ``build_dispatch_combine`` equal under capacity pressure (dispatch and
  combine exactly, aux within 1e-6) and on an exact tie between experts
  (the lower index wins on both sides); dropped tokens pass through the
  residual;
- ``moe_forward`` logits and aux, ``moe_loss_fn`` and its gradients,
  with and without ``remat`` (1e-4 / 1e-5), MHA and GQA;
- ``moe_generate`` greedy tokens equal, and ``moe_prefill`` /
  ``moe_decode_step`` logits;
- both engines' MoE transcripts against the reference engines', with a
  capacity factor under which admission chunks drop tokens (counted);
- the MoE refusals word for word: ``ERR_PREFIX_MOE``, ``ERR_SPEC_MOE``,
  ``mm`` on a MoE layer; ``sample_n`` serving full prompts;
- three ``make_moe_train_step`` steps against the reference's on a
  one-device CPU mesh (1e-5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import moe_decode as jmd  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import moe as jmoe  # noqa: E402
from tpushare.workloads.parallel.mesh import make_mesh  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, moe_decode, quant  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads import train  # noqa: E402
from tpushare_torch.workloads.models import moe  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request, ServingEngine)

# f32 over the same weights: summation order only
LOGIT_TOL = 1e-4
TOL = 1e-5
PARAM_SHARE = 1e-4
JCFG = jmoe.MoEConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                      d_ff=128, max_seq=64, n_experts=4, expert_top_k=2,
                      dtype=jnp.float32)


def torch_cfg(jcfg):
    return moe.MoEConfig(**{**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)},
                            "dtype": torch.float32})


def params_of(jcfg, seed=0):
    jparams = jmoe.init_moe_params(jax.random.key(seed), jcfg)
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


CFG = torch_cfg(JCFG)
JPARAMS, PARAMS = params_of(JCFG)


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


def tokens(seed, b=2, s=32, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def rand_prompt(seed, n):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, JCFG.vocab, n)]


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def assert_tree_close(got, want, tol, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, ref in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.float().numpy(), ref, atol=tol,
                                   rtol=tol, err_msg=f"{what} {path}")


def test_config_counts_and_bridged_stacks():
    assert CFG.expert_capacity == JCFG.expert_capacity
    for seq in (1, 3, 16, 64):
        assert CFG.capacity_for(seq) == JCFG.capacity_for(seq)
    assert moe.moe_param_count(CFG) == jmoe.moe_param_count(JCFG) == sum(
        t.numel() for t in train.tree_leaves(PARAMS))
    lp = PARAMS["layers"]
    assert lp["router"].shape == (2, 64, 4) and lp["router"].dtype == \
        torch.float32
    assert lp["w1"].shape == (2, 4, 64, 128) and lp["w2"].shape == \
        (2, 4, 128, 64)
    own = moe.init_moe_params(torch.Generator().manual_seed(0),
                              dataclasses.replace(CFG, dtype=torch.bfloat16),
                              "cpu")
    assert train.tree_map(lambda t: tuple(t.shape), own) == \
        train.tree_map(lambda t: tuple(t.shape), PARAMS)
    assert own["layers"].pop("router").dtype == torch.float32
    assert {t.dtype for t in train.tree_leaves(own)} == {torch.bfloat16}


@pytest.mark.parametrize("C", [4, 12, 64])
def test_dispatch_combine_match_the_reference(C):
    """Capacity 4 and 12 over 32 tokens x top-2 into 4 experts drop
    tokens; 64 drops none. Dispatch and combine equal element for
    element, the aux within 1e-6."""
    rng = np.random.default_rng(C)
    h = rng.standard_normal((2, 32, 64)).astype(np.float32)
    router = np.array(JPARAMS["layers"]["router"][0])
    jd, jc, jaux = jmoe.build_dispatch_combine(jnp.asarray(h),
                                               jnp.asarray(router), JCFG, C)
    d, c, aux = moe.build_dispatch_combine(torch.from_numpy(h),
                                           torch.from_numpy(router), CFG, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    kept = d.sum().item()
    assert (kept < 2 * 2 * 32) == (C < 64)


def test_ties_route_to_the_lower_expert():
    """A zero router gives every expert the same probability: both sides
    pick experts 0 and 1, in that order, for every token."""
    h = np.random.default_rng(1).standard_normal((1, 8, 64)).astype(
        np.float32)
    router = np.zeros((64, 4), np.float32)
    jd, jc, _ = jmoe.build_dispatch_combine(jnp.asarray(h),
                                            jnp.asarray(router), JCFG, 8)
    d, c, _ = moe.build_dispatch_combine(torch.from_numpy(h),
                                         torch.from_numpy(router), CFG, 8)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert d[0, :, :2].sum().item() == 16 and d[0, :, 2:].sum().item() == 0


def test_dropped_tokens_pass_through_the_residual():
    cfg = dataclasses.replace(CFG, capacity_factor=1e-9)
    assert cfg.expert_capacity == 4
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64, 64)).astype(np.float32))
    lp = tt.layer_params(PARAMS, 0)
    out, _ = moe.moe_ffn(h, lp, cfg)
    norms = out[0].norm(dim=-1)
    assert int((norms == 0).sum()) >= 64 - 4 * cfg.n_experts
    assert norms.max() > 0
    jout, _ = jmoe.moe_ffn(jnp.asarray(h.numpy()), jax.tree.map(
        lambda x: x[0], JPARAMS["layers"]), dataclasses.replace(
            JCFG, capacity_factor=1e-9))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


@pytest.mark.parametrize("remat,kv_heads", [(False, None), (True, None),
                                            (False, 2)])
def test_forward_loss_and_grads_match_the_reference(remat, kv_heads):
    jcfg = dataclasses.replace(JCFG, remat=remat, n_kv_heads=kv_heads)
    cfg = torch_cfg(jcfg)
    jparams, params = (JPARAMS, PARAMS) if kv_heads is None else \
        params_of(jcfg, 5)
    inp = tokens(4)
    tgt = np.roll(inp, -1, axis=1)
    jl, jaux = jmoe.moe_forward(jparams, jnp.asarray(inp), jcfg)
    logits, aux = moe.moe_forward(params, torch.from_numpy(inp), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    want, jgrads = jax.value_and_grad(jmoe.moe_loss_fn)(
        jparams, jnp.asarray(inp), jnp.asarray(tgt), jcfg)
    loss, grads = train.loss_and_grads(params, torch.from_numpy(inp),
                                       torch.from_numpy(tgt), cfg,
                                       moe.moe_loss_fn)
    assert abs(loss.item() - float(want)) <= TOL * float(want)
    assert_tree_close(grads, np_tree(jgrads), 1e-4, "grads")
    assert grads["layers"]["router"].abs().max() > 0
    if remat:
        plain = train.loss_and_grads(params, torch.from_numpy(inp),
                                     torch.from_numpy(tgt),
                                     dataclasses.replace(cfg, remat=False),
                                     moe.moe_loss_fn)
        assert torch.equal(plain[0], loss)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_moe_generate_greedy_tokens_equal(kv_heads):
    jcfg = dataclasses.replace(JCFG, n_kv_heads=kv_heads)
    jparams, params = (JPARAMS, PARAMS) if kv_heads is None else \
        params_of(jcfg, 6)
    p = tokens(7, 2, 9)
    want = np.asarray(jmd.moe_generate(jparams, jnp.asarray(p), jcfg, 10))
    got = moe_decode.moe_generate(params, torch.from_numpy(p),
                                  torch_cfg(jcfg), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    # prefill and one step: the reference's logits
    jc = jdec.init_cache(jcfg, 2, 32)
    tc = tdec.init_cache(torch_cfg(jcfg), 2, 32, device="cpu")
    jl, jc = jmd.moe_prefill(jparams, jnp.asarray(p), jcfg, jc)
    tl, tc = moe_decode.moe_prefill(params, torch.from_numpy(p),
                                    torch_cfg(jcfg), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl, _ = jmd.moe_decode_step(jparams, jnp.asarray(nxt), jc, jcfg)
    tl, _ = moe_decode.moe_decode_step(params, torch.from_numpy(nxt), tc,
                                       torch_cfg(jcfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# capacity 0.5: a 16-wide admission chunk routes 32 choices into 4
# experts of capacity_for(16) = 4 slots, so chunks drop tokens; a decode
# step (capacity_for(1) = 2, one token a row) drops none
SCFG = dataclasses.replace(JCFG, max_seq=256, capacity_factor=0.5)
SJPARAMS, SPARAMS = params_of(SCFG, 1)
SPECS = [dict(prompt=rand_prompt(20 + i, 5 + 7 * i), max_new=6 + 2 * i)
         for i in range(4)]


@pytest.mark.parametrize("engine", ["slot", "paged-bf16", "paged-int8"])
def test_moe_engines_match_the_reference_engines(engine, monkeypatch):
    """More requests than lanes, prompts over several chunks, tokens
    dropped in admission chunks (the port's router counts them): the
    reference engine's transcripts and logprobs."""
    dropped = []
    real = moe.build_dispatch_combine

    def counting(h, router, cfg, C):
        d, c, aux = real(h, router, cfg, C)
        dropped.append(h.shape[0] * h.shape[1] * cfg.expert_top_k
                       - int(d.sum()))
        return d, c, aux

    monkeypatch.setattr(moe, "build_dispatch_combine", counting)
    cfg = torch_cfg(SCFG)
    if engine == "slot":
        kw = dict(n_slots=3, max_seq=64, prompt_buckets=(8, 16), chunk=3)
        eng = ServingEngine(SPARAMS, cfg, **kw)
        jeng = jserving.ServingEngine(SJPARAMS, SCFG, **kw)
    else:
        codec = engine.split("-")[1]
        kw = dict(n_lanes=3, max_seq=64, n_pages=30, page_size=8,
                  prompt_buckets=(8, 16), chunk=3, kv_codec=codec)
        eng = PagedServingEngine(SPARAMS, cfg, **kw)
        jeng = jserving.PagedServingEngine(SJPARAMS, SCFG, attn_impl="xla",
                                           **kw)
    reqs = [Request(**s) for s in SPECS]
    jreqs = [jserving.Request(**s) for s in SPECS]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    tol = 5e-3 if engine == "paged-int8" else LOGIT_TOL
    for r, jr in zip(reqs, jreqs):
        assert r.status == consts.STATUS_COMPLETED
        assert r.output == jr.output
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=tol)
    assert sum(dropped) > 0
    assert eng.stats["prefill_chunks"] > len(SPECS)


def test_moe_refusals_match_the_reference_word_for_word():
    kw = dict(n_slots=2, max_seq=64, prompt_buckets=(16,))
    pkw = dict(n_lanes=2, max_seq=64, n_pages=20, page_size=8,
               prompt_buckets=(16,))
    for eng in (ServingEngine(PARAMS, CFG, **kw),
                PagedServingEngine(PARAMS, CFG, **pkw)):
        with pytest.raises(NotImplementedError) as err:
            eng.register_prefix("sys", [1, 2, 3])
        assert str(err.value) == consts.ERR_PREFIX_MOE == \
            jconsts.ERR_PREFIX_MOE
    dcfg = tt.TransformerConfig(vocab=128, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq=64,
                                dtype=torch.float32)
    dparams = tt.init_params(torch.Generator().manual_seed(0), dcfg, "cpu")
    for make, k in ((ServingEngine, kw), (PagedServingEngine, pkw)):
        for target, draft in (((PARAMS, CFG), (dparams, dcfg, 2)),
                              ((dparams, dcfg), (PARAMS, CFG, 2))):
            with pytest.raises(ValueError) as err:
                make(*target, draft=draft, **k)
            assert str(err.value) == consts.ERR_SPEC_MOE == \
                jconsts.ERR_SPEC_MOE
    # the mm hook is the dense body's: a MoE layer refuses it
    eng = ServingEngine(PARAMS, CFG, mm=quant.qmm, **kw)
    eng.submit(Request(prompt=[1, 2, 3], max_new=2))
    with pytest.raises(NotImplementedError) as err:
        eng.run()
    try:
        jdec.model_layer(None, None, JCFG, None, None, None, mm=object())
    except NotImplementedError as e:
        assert str(err.value) == str(e)
    else:
        raise AssertionError("the reference accepted mm on a MoE layer")


def test_moe_sample_n_serves_full_prompts():
    """``sample_n`` on a MoE engine takes the reference's no-sharing
    branch: no prefix is registered, n full prompts are served."""
    eng = ServingEngine(PARAMS, CFG, n_slots=2, max_seq=64,
                        prompt_buckets=(16,), seed=2)
    seen = []
    real = eng.register_prefix
    eng.register_prefix = lambda *a: seen.append(a) or real(*a)
    reqs = eng.sample_n(rand_prompt(40, 9), n=3, max_new=5, temperature=1.0)
    assert not seen and not eng.prefixes
    assert [len(r.output) for r in reqs] == [5, 5, 5]
    assert all(r.prompt == rand_prompt(40, 9) for r in reqs)


def test_three_moe_train_steps_match_the_reference():
    mesh = make_mesh(1, dp=1, tp=1, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=3e-4)
    jstate = jtrain.place_moe_state(jtrain.init_state(JPARAMS, jopt), mesh)
    jstep = jtrain.make_moe_train_step(JCFG, jopt, mesh)
    topt = train.make_optimizer(lr=3e-4)
    tstate = train.init_state(train.tree_map(torch.clone, PARAMS), topt)
    tstep = train.make_moe_train_step(CFG, topt, "cpu")
    inp = tokens(9, 4, 32)
    tgt = np.roll(inp, -1, axis=1)
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(inp), jnp.asarray(tgt))
        tstate, tl = tstep(tstate, torch.from_numpy(inp),
                           torch.from_numpy(tgt))
        assert abs(tl.item() - float(jl)) <= TOL * float(jl), f"step {i}"
        losses.append(tl.item())
    assert tstate["step"] == 3 and losses[-1] < losses[0]
    # Adam's first update is g / (|g| + eps): an element whose gradient
    # lies within summation-order noise of 0 may step the other way (one
    # of 65,536 in w2 sat 1.8e-5 off here) — so every element within
    # 2 lr, all but PARAM_SHARE of them within TOL (the smoke's
    # train-f32-parity rule)
    assert_tree_close(tstate["params"], np_tree(jstate["params"]), 2 * 3e-4,
                      "params")
    n_off = n_all = 0
    for path, want in jax.tree_util.tree_flatten_with_path(
            np_tree(jstate["params"]))[0]:
        got = tstate["params"]
        for key in path:
            got = got[key.key]
        n_off += int((np.abs(got.numpy() - want)
                      > TOL * (1 + np.abs(want))).sum())
        n_all += want.size
    assert n_off <= PARAM_SHARE * n_all
    from tpushare_torch.workloads.parallel.mesh import make_mesh as tmake
    ep3 = tmake(dp=1, tp=1, ep=3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by ep 3"):
        train.make_moe_train_step(CFG, topt, ep3)
