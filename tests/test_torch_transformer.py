"""The port's transformer held against the JAX reference on the CPU:
the same numpy-seeded inputs and the same (bridged) weights through
both, f32 within 1e-4 and bf16 within 3e-2, plus the config and the
accounting helpers field for field."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch.workloads import bridge  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402

# tolerances: f32 differs only in reduction order. bf16 also rounds at
# different places in the two frameworks — XLA's CPU backend computes a
# bf16 logistic (jax.nn.silu) as 1/(1+exp(-x)) rounding every op to
# bf16, torch's silu rounds once — so the bf16 forward is held to 3e-2
# of the logit scale rather than 3e-2 absolute.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=128)


def configs(dtype_name: str, **kw):
    jcfg = jt.TransformerConfig(**{**SMALL, **kw},
                                dtype=getattr(jnp, dtype_name))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = bridge.torch_dtype(dtype_name)
    return jcfg, tt.TransformerConfig(**fields)


def bridged(jcfg):
    jparams = jt.init_params(jax.random.key(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, bridge.params_from_numpy(np_tree, device="cpu")


def to_np(t):
    return t.detach().float().numpy()


def test_every_config_field_mirrors_the_reference():
    jnames = [f.name for f in dataclasses.fields(jt.TransformerConfig)]
    tnames = [f.name for f in dataclasses.fields(tt.TransformerConfig)]
    assert tnames == jnames
    for f in dataclasses.fields(jt.TransformerConfig):
        jd = f.default
        td = tt.TransformerConfig.__dataclass_fields__[f.name].default
        if f.name == "dtype":
            assert td == bridge.torch_dtype(jnp.dtype(jd).name)
        else:
            assert td == jd, f.name
    jcfg, tcfg = configs("float32", n_kv_heads=2)
    assert (tcfg.head_dim, tcfg.kv_heads, tcfg.kv_dim) == \
        (jcfg.head_dim, jcfg.kv_heads, jcfg.kv_dim)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2},
                                {"kv_int8": True}, {"dtype": "float32"}])
def test_accounting_helpers_equal(kw):
    kw = dict(kw)
    jcfg, tcfg = configs(kw.pop("dtype", "bfloat16"), **kw)
    assert tt.param_count(tcfg) == jt.param_count(jcfg)
    assert tt.forward_flops(tcfg, 3, 96) == jt.forward_flops(jcfg, 3, 96)
    assert tt.kv_cache_bytes_per_token(tcfg) == \
        jt.kv_cache_bytes_per_token(jcfg)


def test_init_params_shapes_and_scaling():
    jcfg, tcfg = configs("float32", n_kv_heads=2)
    gen = torch.Generator(device="cpu").manual_seed(0)
    tp = tt.init_params(gen, tcfg, device="cpu")
    jp = jt.init_params(jax.random.key(0), jcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
    n = sum(x.numel() for x in [tp["embed"], tp["out"], tp["norm_f"],
                                *tp["layers"].values()])
    assert n == tt.param_count(tcfg)
    # fan_in**-0.5 scaling: the std of a (D, .) draw is D**-0.5
    assert abs(tp["embed"].std().item() * SMALL["d_model"] ** 0.5 - 1) < 0.05
    assert abs(tp["layers"]["w2"].std().item()
               * SMALL["d_ff"] ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = jt.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(s, jdt))
    got = tt.rmsnorm(torch.from_numpy(x).to(bridge.torch_dtype(dtype)),
                     torch.from_numpy(s).to(bridge.torch_dtype(dtype)))
    np.testing.assert_allclose(to_np(got), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    jcfg, tcfg = configs("float32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    jcos, jsin = jt.rope_tables(jcfg, 40)
    tcos, tsin = tt.rope_tables(tcfg, 40)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    if per_row:
        pos = np.array([[3, 4, 5, 6, 7, 8, 9], [30, 31, 32, 33, 34, 35, 36]])
        jc, js = jcos[pos], jsin[pos]
        tc, ts = tcos[torch.from_numpy(pos)], tsin[torch.from_numpy(pos)]
    else:
        jc, js, tc, ts = jcos[:7], jsin[:7], tcos[:7], tsin[:7]
    ref = jt.apply_rope(jnp.asarray(x), jc, js)
    got = tt.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}, {"attn_window": 5}])
def test_attention_matches(kw):
    jcfg, tcfg = configs("float32", **kw)
    rng = np.random.default_rng(3)
    hkv = jcfg.kv_heads
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, hkv, 16)).astype(np.float32)
    ref = jt.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg)
    got = tt.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("dtype,kw", [("float32", {}),
                                      ("float32", {"n_kv_heads": 2}),
                                      ("bfloat16", {})])
def test_forward_logits_match(dtype, kw):
    jcfg, tcfg = configs(dtype, **kw)
    jparams, tparams = bridged(jcfg)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 32))
    ref = np.asarray(jt.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                jcfg))
    got = tt.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = 1.0 if dtype == "float32" else float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL[dtype] * scale,
                               rtol=TOL[dtype])
