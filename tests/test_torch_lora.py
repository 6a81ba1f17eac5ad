"""The port's LoRA / QLoRA adapters (``tpushare_torch/workloads/lora.py``
and ``checkpoint.LoraCheckpointer``) held against the JAX reference on
the CPU, mirroring ``tests/test_lora.py``:

- zero-initialized ``b``: the adapted model is the base model, bit for
  bit, and its loss the reference's;
- the loss and its adapter gradients against ``jax.value_and_grad`` of
  the reference's, over a dense and an int8 (QLoRA) base;
- three ``make_lora_train_step`` steps against the reference's with
  optax AdamW (fp32 within 1e-5, bf16 QLoRA within 1e-2), adapters and
  moments compared, the base left bitwise unchanged, and two more from
  a mid-training optax state carried across by ``bridge``;
- ``merge_lora`` against the reference's and against the adapter
  forward, refusing an int8 base; counts and target validation;
- a ``LoraCheckpointer`` round trip.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import lora as jlora  # noqa: E402
from tpushare.workloads import quant as jquant  # noqa: E402
from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch.workloads import bridge, lora, quant, train  # noqa: E402
from tpushare_torch.workloads.checkpoint import LoraCheckpointer  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402

# fp32: summation order; bf16: adapters, gradients and moments in bf16,
# rounded at other places by the two frameworks (test_torch_train.py)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LR = 3e-4
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)
B, S, RANK = 4, 32, 4


def configs(dtype_name: str, **kw):
    jcfg = jt.TransformerConfig(**{**SMALL, **kw},
                                dtype=getattr(jnp, dtype_name))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = bridge.torch_dtype(dtype_name)
    return jcfg, tt.TransformerConfig(**fields)


def batch(seed=5):
    tokens = np.random.default_rng(seed).integers(0, SMALL["vocab"], (B, S))
    return tokens.astype(np.int32), np.roll(tokens, -1, axis=1).astype(
        np.int32)


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def to_torch(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def adam_state(opt_state):
    """The ScaleByAdamState inside an optax (chained) state."""
    import optax

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)
    return next(n for n in jax.tree.leaves(opt_state, is_leaf=is_adam)
                if is_adam(n))


def assert_tree_close(got, want, tol, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, ref in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.float().numpy(), ref, atol=tol,
                                   rtol=tol, err_msg=f"{what} {path}")


def setup(dtype="float32", base="dense", targets=lora.DEFAULT_TARGETS,
          seed=0, b_scale=0.0):
    """Reference params (dense or int8) and adapters, both sides; with
    ``b_scale`` the up-projections get random values so the adapters
    are live."""
    jcfg, tcfg = configs(dtype)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    if base == "int8":
        jparams = jquant.quantize_params(jparams)
    jad = jlora.init_lora(jax.random.key(seed + 1), jcfg, RANK, targets)
    if b_scale:
        jad = {t: {"a": ab["a"], "b": (jax.random.normal(
            jax.random.key(seed + 2 + i), ab["b"].shape) * b_scale
        ).astype(ab["b"].dtype)} for i, (t, ab) in enumerate(jad.items())}
    return jcfg, tcfg, jparams, to_torch(jparams), jad, to_torch(jad)


def jloss(jcfg, jparams, jad, inputs, targets, scale=1.0):
    merged = jlora.apply_lora(jparams, jad, scale)
    return jt.loss_fn(merged, jnp.asarray(inputs), jnp.asarray(targets),
                      jcfg, mm=jlora.lora_mm)


def tloss(tcfg, tparams, tad, inputs, targets, scale=1.0):
    merged = lora.apply_lora(tparams, tad, scale)
    return tt.loss_fn(merged, torch.from_numpy(inputs),
                      torch.from_numpy(targets), tcfg, mm=lora.lora_mm)


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_zero_init_is_the_base_model(base):
    """``b`` starts at zero: the adapted loss is the base model's, bit for
    bit (the low-rank path adds exact zeros), and the reference's."""
    jcfg, tcfg, jparams, tparams, jad, tad = setup(base=base)
    inputs, targets = batch()
    mm = quant.qmm if base == "int8" else None
    plain = tt.loss_fn(tparams, torch.from_numpy(inputs),
                       torch.from_numpy(targets), tcfg, mm=mm)
    got = tloss(tcfg, tparams, tad, inputs, targets, scale=2.0)
    assert torch.equal(got, plain)
    want = float(jloss(jcfg, jparams, jad, inputs, targets, 2.0))
    assert abs(got.item() - want) <= TOL["float32"] * max(1.0, abs(want))
    # the port's own draws: the reference's shapes, a zero b
    own = lora.init_lora(torch.Generator().manual_seed(0), tcfg, RANK,
                         ("wq", "wv", "w2"), device="cpu")
    for t, ab in own.items():
        din, dout = {"wq": (64, 64), "wv": (64, 64), "w2": (128, 64)}[t]
        assert ab["a"].shape == (2, din, RANK) and not ab["b"].any()
        assert ab["b"].shape == (2, RANK, dout)
        assert 0.5 < float(ab["a"].std() * din ** 0.5) < 1.5


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_loss_and_adapter_grads_match_the_reference(base):
    """Live adapters (random ``b``, scale 2) over a dense or an int8
    base: the loss and its gradients with respect to ``a`` and ``b``."""
    jcfg, tcfg, jparams, tparams, jad, tad = setup(
        base=base, targets=("wq", "wv", "w1"), b_scale=0.05)
    inputs, targets = batch(7)
    want, jgrads = jax.value_and_grad(
        lambda ad: jloss(jcfg, jparams, ad, inputs, targets, 2.0))(jad)
    leaves = train.tree_map(lambda t: t.requires_grad_(), tad)
    got = tloss(tcfg, tparams, leaves, inputs, targets, 2.0)
    assert abs(got.item() - float(want)) <= TOL["float32"] * float(want)
    got.backward()
    assert_tree_close(train.tree_map(lambda t: t.grad, leaves),
                      np_tree(jgrads), 1e-4, "grads")
    # the adapters moved the loss: they were read
    plain = tt.loss_fn(tparams, torch.from_numpy(inputs),
                       torch.from_numpy(targets), tcfg,
                       mm=quant.qmm if base == "int8" else None)
    assert abs(plain.item() - got.item()) > 1e-3


@pytest.mark.parametrize("dtype,base", [("float32", "dense"),
                                        ("float32", "int8"),
                                        ("bfloat16", "int8")])
def test_three_lora_steps_match_the_reference(dtype, base):
    """Three adapter steps against the reference's ``make_lora_train_step``
    with optax AdamW: losses, adapters and moments within TOL; only the
    adapters change — the base (dense or int8) is bitwise what it was."""
    jcfg, tcfg, jparams, tparams, jad, tad = setup(dtype, base, seed=3)
    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jlora.init_lora_state(jad, jopt)
    jstep = jlora.make_lora_train_step(jcfg, jopt, scale=2.0)
    topt = train.make_optimizer(lr=LR)
    tstate = lora.init_lora_state(tad, topt)
    tstep = lora.make_lora_train_step(tcfg, topt, scale=2.0)
    before = train.tree_map(torch.clone, tparams)
    inputs, targets = batch(11)
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jparams, jnp.asarray(inputs),
                           jnp.asarray(targets))
        tstate, tl = tstep(tstate, tparams, torch.from_numpy(inputs),
                           torch.from_numpy(targets))
        assert abs(tl.item() - float(jl)) <= TOL[dtype] * max(1.0, float(jl))
        assert tstate["step"] == int(jstate["step"]) == i + 1
        losses.append(tl.item())
    assert losses[-1] < losses[0]
    assert_tree_close(tstate["adapters"], np_tree(jstate["adapters"]),
                      TOL[dtype], "adapters")
    adam = adam_state(jstate["opt"])
    assert tstate["opt"]["count"] == int(adam.count) == 3
    assert_tree_close(tstate["opt"]["mu"], np_tree(adam.mu), TOL[dtype],
                      "mu")
    for a, b in zip(train.tree_leaves(before), train.tree_leaves(tparams)):
        assert torch.equal(a, b) and not b.requires_grad
    assert any(t.any() for t in train.tree_leaves(
        {k: v["b"] for k, v in tstate["adapters"].items()}))


def test_steps_from_a_bridged_adapter_state_match():
    """The reference's adapter state after one step (adapters and AdamW
    moments carried across by ``bridge``), then two more on both sides."""
    jcfg, tcfg, jparams, tparams, jad, _ = setup(base="int8", seed=4)
    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jlora.init_lora_state(jad, jopt)
    jstep = jlora.make_lora_train_step(jcfg, jopt)
    inputs, targets = batch(12)
    jstate, _ = jstep(jstate, jparams, jnp.asarray(inputs),
                      jnp.asarray(targets))
    adam = adam_state(jstate["opt"])
    tstate = {"adapters": to_torch(jstate["adapters"]),
              "opt": bridge.adamw_state_from_numpy(
                  jax.tree.map(np.asarray, adam.mu),
                  jax.tree.map(np.asarray, adam.nu), np.asarray(adam.count),
                  "cpu"),
              "step": int(jstate["step"])}
    tstep = lora.make_lora_train_step(tcfg, train.make_optimizer(lr=LR))
    for _ in range(2):
        jstate, jl = jstep(jstate, jparams, jnp.asarray(inputs),
                           jnp.asarray(targets))
        tstate, tl = tstep(tstate, tparams, torch.from_numpy(inputs),
                           torch.from_numpy(targets))
        assert abs(tl.item() - float(jl)) <= TOL["float32"]
    assert_tree_close(tstate["adapters"], np_tree(jstate["adapters"]),
                      TOL["float32"], "adapters")


def test_merge_equals_the_adapter_forward():
    jcfg, tcfg, jparams, tparams, jad, tad = setup(
        targets=("wq", "wk", "w2"), b_scale=0.05)
    merged = lora.merge_lora(tparams, tad, 2.0)
    jmerged = jlora.merge_lora(jparams, jad, 2.0)
    assert_tree_close(merged, np_tree(jmerged), 1e-6, "merged")
    tokens = torch.from_numpy(batch(13)[0])
    want = tt.forward(lora.apply_lora(tparams, tad, 2.0), tokens, tcfg,
                      mm=lora.lora_mm)
    got = tt.forward(merged, tokens, tcfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    _, _, _, qparams, _, qad = setup(base="int8")
    with pytest.raises(ValueError) as err:
        lora.merge_lora(qparams, qad)
    with pytest.raises(ValueError) as jerr:
        jlora.merge_lora(jquant.quantize_params(jparams), jad)
    assert str(err.value) == str(jerr.value)


def test_counts_and_target_validation():
    jcfg, tcfg = configs("float32", n_kv_heads=2)
    for targets in (("wq", "wv"), tuple(lora._SHAPES)):
        n = lora.lora_param_count(tcfg, 8, targets)
        assert n == jlora.lora_param_count(jcfg, 8, targets)
        ad = lora.init_lora(torch.Generator().manual_seed(1), tcfg, 8,
                            targets, device="cpu")
        assert n == sum(t.numel() for t in train.tree_leaves(ad))
    with pytest.raises(ValueError) as err:
        lora.init_lora(torch.Generator(), tcfg, 4, ("wq", "nope"),
                       device="cpu")
    with pytest.raises(ValueError) as jerr:
        jlora.init_lora(jax.random.key(0), jcfg, 4, ("wq", "nope"))
    assert str(err.value) == str(jerr.value)


def test_lora_checkpointer_round_trip(tmp_path):
    """Adapters, moments and the step — no base — saved, the newest kept,
    restored by (cfg, optimizer, rank, targets), an older step by number,
    a mismatched rank refused."""
    _, tcfg = configs("bfloat16")
    opt = train.make_optimizer(lr=1e-3)
    targets = ("wq", "wo")
    state = lora.init_lora_state(
        lora.init_lora(torch.Generator().manual_seed(2), tcfg, RANK, targets,
                       device="cpu"), opt)
    params = tt.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    step = lora.make_lora_train_step(tcfg, opt)
    inputs, targets_ = (torch.from_numpy(x) for x in batch(14))
    ckpt = LoraCheckpointer(tmp_path / "lora", max_to_keep=2)
    saved = {}
    for _ in range(3):
        state, _ = step(state, params, inputs, targets_)
        ckpt.save(state)
        saved[state["step"]] = train.tree_map(torch.clone,
                                              state["adapters"])
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    got = ckpt.restore(tcfg, opt, RANK, targets, device="cpu")
    assert set(got) == {"adapters", "opt", "step"} and got["step"] == 3
    for a, b in zip(train.tree_leaves(got["adapters"]),
                    train.tree_leaves(state["adapters"])):
        assert torch.equal(a, b)
    for a, b in zip(train.tree_leaves(got["opt"]["nu"]),
                    train.tree_leaves(state["opt"]["nu"])):
        assert torch.equal(a, b)
    assert got["opt"]["count"] == 3
    old = ckpt.restore(tcfg, opt, RANK, targets, step=2, device="cpu")
    for a, b in zip(train.tree_leaves(old["adapters"]),
                    train.tree_leaves(saved[2])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rank 8"):
        ckpt.restore(tcfg, opt, 8, targets, device="cpu")
    with pytest.raises(ValueError, match="adapters"):
        ckpt.restore(tcfg, opt, RANK, device="cpu")   # default wq, wv
    with pytest.raises(FileNotFoundError):
        LoraCheckpointer(tmp_path / "empty").restore(tcfg, opt, RANK)
