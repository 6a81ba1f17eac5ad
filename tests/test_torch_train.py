"""The port's training path held against the JAX reference on the CPU.

- ``loss_fn`` against the reference's, from bridged weights;
- ``train.AdamW`` against optax's ``adamw`` (with and without
  ``clip_by_global_norm``) on the same gradients;
- three steps of ``make_train_step`` against the reference's
  ``make_train_step`` on a one-device CPU mesh, from the same params:
  fp32 within 1e-5, bf16 within the tolerance below; with clipping and
  the warmup + cosine schedule, with ``accum_steps=2``, and from a
  mid-training optax state carried across by ``bridge``;
- remat equals no remat; ``TrainCheckpointer`` round trip; the payload
  resumes from its checkpoint on ``--device cpu``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.parallel.mesh import make_mesh  # noqa: E402
from tpushare_torch.workloads import bridge, train  # noqa: E402
from tpushare_torch.workloads import train_payload  # noqa: E402
from tpushare_torch.workloads.checkpoint import TrainCheckpointer  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops.attention import (  # noqa: E402
    flash_attention_plain)

# fp32: summation order only. bf16: parameters, gradients and AdamW
# moments are all bf16 (optax keeps mu/nu in the params' dtype), and the
# two frameworks round at different places (XLA fuses elementwise chains;
# jax.nn.silu rounds each op, see ROADMAP C) — after three steps a
# parameter may sit a few bf16 ulps from the reference (2.4e-3 seen).
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Adam's first update is g / (|g| + eps): where a gradient is near 0 it
# turns summation-order noise into an update of up to lr x noise / eps,
# so the step parity runs at the reference's default lr (3e-4; at 1e-3
# one fp32 element moved 1.5e-5)
LR = 3e-4
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)
B, S = 4, 32


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


def assert_tree_close(got, want, tol, what):
    """``got`` a nested dict of tensors, ``want`` a numpy tree."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, ref in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.float().numpy(), ref, atol=tol,
                                   rtol=tol, err_msg=f"{what} {path}")


def adam_state(opt_state):
    """The ScaleByAdamState inside an optax (chained) state."""
    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)
    for node in jax.tree.leaves(opt_state, is_leaf=is_adam):
        if is_adam(node):
            return node
    raise AssertionError("no ScaleByAdamState")


@pytest.mark.parametrize("dtype,kw", [("float32", {}),
                                      ("float32", {"n_kv_heads": 2}),
                                      ("bfloat16", {})])
def test_loss_fn_matches(dtype, kw):
    jcfg, tcfg = configs(dtype, **kw)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    inputs, targets = batch()
    ref = float(jt.loss_fn(jparams, jnp.asarray(inputs),
                           jnp.asarray(targets), jcfg))
    got = tt.loss_fn(tparams, torch.from_numpy(inputs),
                     torch.from_numpy(targets), tcfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - ref) <= TOL[dtype] * max(1.0, abs(ref))


def j_full_attention(q, k, v):
    """Non-causal attention in JAX: the attn_fn hook of the tests."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * q.shape[-1] ** -0.5
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p,
                      v.astype(jnp.float32)).astype(q.dtype)


def t_full_attention(q, k, v):
    return flash_attention_plain(q, k, v, causal=False)


@pytest.mark.parametrize("hooks", ["attn_fn", "positions", "both"])
def test_loss_fn_hooks_match_the_reference(hooks):
    """``attn_fn`` replaces the attention core and ``positions`` each
    slot's RoPE position, as in the reference; with full attention,
    permuting the tokens together with their positions keeps the loss."""
    jcfg, tcfg = configs("float32")
    jparams = jt.init_params(jax.random.key(8), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    inputs, targets = batch(9)
    perm = np.random.default_rng(9).permutation(S).astype(np.int32)
    jkw, tkw = {}, {}
    if hooks in ("attn_fn", "both"):
        jkw["attn_fn"], tkw["attn_fn"] = j_full_attention, t_full_attention
    if hooks in ("positions", "both"):
        inputs, targets = inputs[:, perm], targets[:, perm]
        jkw["positions"] = jnp.asarray(perm)
        tkw["positions"] = torch.from_numpy(perm).long()
    ref = float(jt.loss_fn(jparams, jnp.asarray(inputs),
                           jnp.asarray(targets), jcfg, **jkw))
    leaves = train.tree_map(lambda p: p.requires_grad_(), tparams)
    got = tt.loss_fn(leaves, torch.from_numpy(inputs),
                     torch.from_numpy(targets), tcfg, **tkw)
    assert abs(got.item() - ref) <= TOL["float32"] * max(1.0, abs(ref))
    with torch.no_grad():
        unhooked = tt.loss_fn(tparams, *map(torch.from_numpy, batch(9)),
                              tcfg)
        full = tt.loss_fn(tparams, *map(torch.from_numpy, batch(9)), tcfg,
                          attn_fn=t_full_attention)
    assert abs(got.item() - unhooked.item()) > 10 * TOL["float32"]
    if hooks == "both":
        assert abs(got.item() - full.item()) <= TOL["float32"]
    # the hooks carry a gradient: the reference's, through the same hooks
    jgrads = jax.grad(jt.loss_fn)(jparams, jnp.asarray(inputs),
                                  jnp.asarray(targets), jcfg, **jkw)
    got.backward()
    assert_tree_close(train.tree_map(lambda p: p.grad, leaves),
                      np_tree(jgrads), 1e-4, "grads")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [None, 0.05])
def test_adamw_matches_optax(dtype, clip_norm):
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rng.standard_normal(32).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                     * 0.1).astype(np.float32), params)
             for _ in range(3)]
    jdt = getattr(jnp, dtype)
    jopt = jtrain.make_optimizer(lr=1e-2, clip_norm=clip_norm,
                                 warmup_steps=1, decay_steps=4)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    jstate = jopt.init(jp)
    topt = train.make_optimizer(lr=1e-2, clip_norm=clip_norm,
                                warmup_steps=1, decay_steps=4)
    tp = bridge.params_from_numpy(np_tree(jp), device="cpu")
    tp = train.tree_map(lambda t: t.to(bridge.torch_dtype(dtype)), tp)
    tstate = topt.init(tp)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = train.tree_map(lambda x: x.to(bridge.torch_dtype(dtype)),
                            bridge.params_from_numpy(np_tree(jg), "cpu"))
        topt.update(tg, tstate, tp)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert_tree_close(tp, np_tree(jp), tol, "params")
    adam = adam_state(jstate)
    assert tstate["count"] == int(adam.count) == 3
    assert_tree_close(tstate["mu"], np_tree(adam.mu), tol, "mu")
    assert_tree_close(tstate["nu"], np_tree(adam.nu), tol, "nu")


@pytest.mark.parametrize("dtype,opt_kw,step_kw,cfg_kw", [
    ("float32", {}, {}, {}),
    ("float32", {"clip_norm": 0.5, "warmup_steps": 2, "decay_steps": 5},
     {}, {"n_kv_heads": 2}),
    ("float32", {}, {"accum_steps": 2}, {}),
    ("bfloat16", {}, {}, {}),
])
def test_three_train_steps_match_the_reference(dtype, opt_kw, step_kw,
                                               cfg_kw):
    jcfg, tcfg = configs(dtype, **cfg_kw)
    mesh = make_mesh(1, dp=1, tp=1, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=LR, **opt_kw)
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    jstate = jtrain.place_state(jtrain.init_state(jparams, jopt), mesh)
    jstep = jtrain.make_train_step(jcfg, jopt, mesh, **step_kw)
    topt = train.make_optimizer(lr=LR, **opt_kw)
    tstate = train.init_state(tparams, topt)
    tstep = train.make_train_step(tcfg, topt, "cpu", **step_kw)
    inputs, targets = batch()
    losses = []
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(inputs),
                              jnp.asarray(targets))
        tstate, tloss = tstep(tstate, torch.from_numpy(inputs),
                              torch.from_numpy(targets))
        assert abs(tloss.item() - float(jloss)) <= \
            TOL[dtype] * max(1.0, float(jloss)), f"loss at step {i}"
        assert tstate["step"] == int(jstate["step"]) == i + 1
        losses.append(tloss.item())
    assert_tree_close(tstate["params"], np_tree(jstate["params"]),
                      TOL[dtype], "params")
    assert losses[-1] < losses[0]


def test_steps_from_a_bridged_optax_state_match():
    """Start the port from the reference's state after one step (params
    and AdamW moments carried across by bridge) and take two more."""
    jcfg, tcfg = configs("float32")
    mesh = make_mesh(1, dp=1, tp=1, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=LR, warmup_steps=1, decay_steps=4)
    jstate = jtrain.place_state(jtrain.init_state(
        jt.init_params(jax.random.key(2), jcfg), jopt), mesh)
    jstep = jtrain.make_train_step(jcfg, jopt, mesh)
    np_inputs, np_targets = batch()
    inputs, targets = jnp.asarray(np_inputs), jnp.asarray(np_targets)
    jstate, _ = jstep(jstate, inputs, targets)
    adam = adam_state(jstate["opt"])
    topt = train.make_optimizer(lr=LR, warmup_steps=1, decay_steps=4)
    tstate = {"params": bridge.params_from_numpy(
                  jax.tree.map(np.asarray, jstate["params"]), "cpu"),
              "opt": bridge.adamw_state_from_numpy(
                  jax.tree.map(np.asarray, adam.mu),
                  jax.tree.map(np.asarray, adam.nu), np.asarray(adam.count),
                  "cpu"),
              "step": int(jstate["step"])}
    assert tstate["opt"]["count"] == 1
    tstep = train.make_train_step(tcfg, topt, "cpu")
    for _ in range(2):
        jstate, jloss = jstep(jstate, inputs, targets)
        tstate, tloss = tstep(tstate, torch.from_numpy(np_inputs),
                              torch.from_numpy(np_targets))
        assert abs(tloss.item() - float(jloss)) <= TOL["float32"]
    assert_tree_close(tstate["params"], np_tree(jstate["params"]),
                      TOL["float32"], "params")


def test_remat_equals_no_remat():
    _, tcfg = configs("float32", n_kv_heads=2)
    params = tt.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    inputs, targets = (torch.from_numpy(x) for x in batch(7))
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        results.append(train.loss_and_grads(params, inputs, targets, cfg))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(train.tree_leaves(g0), train.tree_leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_multi_device_and_ring_attention_raise():
    _, tcfg = configs("float32")
    opt = train.make_optimizer()
    with pytest.raises(NotImplementedError, match="A.10"):
        train.make_train_step(tcfg, opt, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="A.10"):
        train.make_train_step(tcfg, opt, "cpu", ring_attention=True)


def test_checkpointer_round_trip_keeps_the_newest(tmp_path):
    _, tcfg = configs("bfloat16")
    opt = train.make_optimizer(lr=1e-3)
    state = train.init_state(
        tt.init_params(torch.Generator().manual_seed(4), tcfg, "cpu"), opt)
    step = train.make_train_step(tcfg, opt, "cpu")
    inputs, targets = (torch.from_numpy(x) for x in batch())
    ckpt = TrainCheckpointer(tmp_path / "ck", max_to_keep=2)
    assert ckpt.latest_step() is None
    for _ in range(3):
        state, _ = step(state, inputs, targets)
        ckpt.save(state)
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    assert not list((tmp_path / "ck").glob("*.tmp"))
    back = ckpt.restore(tcfg, "cpu")
    assert back["step"] == 3 and back["opt"]["count"] == 3
    for a, b in zip(train.tree_leaves(back["params"]),
                    train.tree_leaves(state["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for m in ("mu", "nu"):
        for a, b in zip(train.tree_leaves(back["opt"][m]),
                        train.tree_leaves(state["opt"][m])):
            assert torch.equal(a, b)
    # one more step from the restored state is the same step
    s1, l1 = step(back, inputs, targets)
    s2, l2 = step(state, inputs, targets)
    assert torch.equal(l1, l2)
    with pytest.raises(ValueError, match="match the config"):
        ckpt.restore(dataclasses.replace(tcfg, d_ff=64), "cpu")
    ckpt.close()


def test_payload_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", str(tmp_path), "--save-every", "3"]
    assert train_payload.main(args + ["--steps", "6"]) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first and "trained 6 steps" in first
    assert TrainCheckpointer(tmp_path).steps() == [3, 6]
    assert train_payload.main(args + ["--steps", "9"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 6" in second and "trained 3 steps" in second
    loss = [float(line.rsplit("=", 1)[1]) for line in
            (first + second).splitlines() if "final loss=" in line]
    assert loss[1] < loss[0]


@pytest.mark.parametrize("argv,env", [
    (["--dp", "2"], {}), (["--sp", "2"], {}), (["--tp", "2"], {}),
    ([], {train_payload.ENV_GROUP_SIZE: "2"}),
])
def test_payload_refuses_a_mesh(argv, env, capsys, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit) as exc:
        train_payload.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "A.10" in capsys.readouterr().err


def test_train_loop_is_n_steps_on_one_batch():
    _, tcfg = configs("float32")
    params = tt.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    inputs, targets = (torch.from_numpy(x) for x in batch())
    opt = train.make_optimizer(lr=LR)
    looped, losses = train.make_train_loop(tcfg, opt, "cpu", 2)(
        train.init_state(train.tree_map(torch.clone, params), opt), inputs,
        targets)
    step = train.make_train_step(tcfg, opt, "cpu")
    state = train.init_state(params, opt)
    for i in range(2):
        state, loss = step(state, inputs, targets)
        assert torch.equal(losses[i], loss)
    assert looped["step"] == state["step"] == 2
    for a, b in zip(train.tree_leaves(looped["params"]),
                    train.tree_leaves(state["params"])):
        assert torch.equal(a, b)
