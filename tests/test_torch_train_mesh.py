"""The port's training over a device mesh held against the JAX reference
on the CPU (the reference on the 8 fake CPU devices of conftest, the
port on a grid naming the CPU device as often as the mesh needs).

- ``make_mesh``'s factorization and errors, ``assert_divisible``'s;
- ``place_params`` / ``place_state``: every leaf's block at every grid
  coordinate against the reference's array on that coordinate's device
  (dense, int8 codec leaves, MoE, the AdamW moments);
- three f32 train steps at dp2, tp2, dp2 x tp2, sp2 with the zigzag
  ring and with the banded ring at two windows, and ep2 MoE, each
  against the reference's step on the same mesh shape: losses within
  TOL x max(1, |loss|), params within TOL;
- the sharded step against the port's own unsharded step, two runs
  bitwise equal, dp replicas bitwise equal after every step;
- both registries' ``decide`` over a mesh grid with sp and the ring
  kind; a checkpoint saved on dp2 x tp2 resumed on tp1 and on dp2; the
  payload over a mesh, resumed.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import quant as jquant  # noqa: E402
from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import moe as jmoe  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare.workloads.parallel import mesh as jmesh  # noqa: E402
from tpushare_torch.workloads import bridge, train  # noqa: E402
from tpushare_torch.workloads import train_payload  # noqa: E402
from tpushare_torch.workloads.checkpoint import TrainCheckpointer  # noqa: E402
from tpushare_torch.workloads.models import moe as tm  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402
from tpushare_torch.workloads.parallel import mesh as tmesh  # noqa: E402

# fp32: summation order only (the tp / dp / sp sums in rank order)
TOL = 1e-5
LR = 3e-4
PARAM_SHARE = 1e-4       # tests/test_torch_moe.py's
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op threads add only their
    synchronisation, and in the suite's xdist run six workers share the
    cores (the module's tests ran ~10x slower there on 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    jcfg = jt.TransformerConfig(**{**SMALL, **kw}, dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return jcfg, tt.TransformerConfig(**fields)


def moe_configs():
    jcfg = jmoe.MoEConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                          d_ff=64, max_seq=32, n_experts=4, expert_top_k=2,
                          dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return jcfg, tm.MoEConfig(**fields)


def batch(seed=5, b=B, s=S, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return tokens.astype(np.int32), np.roll(tokens, -1, axis=1).astype(
        np.int32)


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def meshes(**kw):
    n = int(np.prod(list(kw.values())))
    return (jmesh.make_mesh(n, devices=jax.devices()[:n], **kw),
            tmesh.make_mesh(devices=["cpu"] * n, **kw))


def assert_close_tree(got: dict, want, what, share: float = 0.0):
    """Every element within TOL; with ``share``, tests/test_torch_moe.py's
    rule for the MoE step: every element within 2 lr and all but that
    share of them within TOL (Adam's first update g / (|g| + eps) turns
    summation-order noise in a gradient near 0 into a step of either
    sign)."""
    n_off = n_all = 0
    for path, ref in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        val = node.float().numpy()
        if not share:
            np.testing.assert_allclose(val, ref, atol=TOL, rtol=TOL,
                                       err_msg=f"{what} {path}")
            continue
        np.testing.assert_allclose(val, ref, atol=2 * LR, rtol=0,
                                   err_msg=f"{what} {path}")
        n_off += int((np.abs(val - ref) > TOL * (1 + np.abs(ref))).sum())
        n_all += ref.size
    assert n_off <= share * n_all, (what, n_off)


# ---------------------------------------------------------------------------
# mesh, specs, placement
# ---------------------------------------------------------------------------

def _outcome(fn, **kw):
    try:
        return dict(fn(**kw).shape)
    except ValueError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("kw", [
    dict(n_devices=8), dict(n_devices=4), dict(n_devices=6),
    dict(n_devices=8, sp=2), dict(n_devices=8, pp=2, ep=2),
    dict(n_devices=4, dp=2, tp=2), dict(n_devices=8, dp=2),
    dict(n_devices=8, tp=2), dict(n_devices=6, sp=4),
    dict(n_devices=8, dp=3, tp=2), dict(n_devices=9),
])
def test_make_mesh_factorizes_as_the_reference(kw):
    ref = _outcome(jmesh.make_mesh, devices=jax.devices(), **kw)
    got = _outcome(tmesh.make_mesh, devices=["cpu"] * 8, **kw)
    assert got == ref
    if isinstance(got, dict):
        m = tmesh.make_mesh(devices=["cpu"] * 8, **kw)
        assert m.axis_names == ("dp", "sp", "tp", "ep", "pp")
        assert all(d == torch.device("cpu") for d in m.devices.flat)


@pytest.mark.parametrize("cfg_kw,mesh_kw", [
    (dict(n_heads=6, d_model=96), dict(tp=4)),
    (dict(n_kv_heads=1), dict(tp=2)),
    (dict(d_ff=130), dict(tp=2)),
    (dict(), dict(tp=2)),
])
def test_assert_divisible_refuses_as_the_reference(cfg_kw, mesh_kw):
    jcfg, tcfg = configs(**cfg_kw)
    jm, tmm = meshes(dp=1, **mesh_kw)

    def run(fn, cfg, mesh):
        try:
            fn(cfg, mesh)
            return None
        except ValueError as e:
            return str(e)
    assert run(tmesh.assert_divisible, tcfg, tmm) == \
        run(jmesh.assert_divisible, jcfg, jm)
    jm, tmm = meshes(dp=1, tp=1, ep=3)
    jmc, tmc = moe_configs()
    assert run(tmesh.assert_divisible, tmc, tmm) == \
        run(jmesh.assert_divisible, jmc, jm) == \
        "n_experts 4 not divisible by ep 3"


def _coord_of(jm):
    """jax device id -> grid coordinate of the reference's mesh."""
    return {d.id: idx for idx, d in np.ndenumerate(jm.devices)}


def assert_placed_like(tleaf, jleaf, jm, what):
    """Every coordinate's block equals the reference's array on the
    device at that coordinate: the same index and the same values."""
    coord = _coord_of(jm)
    seen = set()
    for shard in jleaf.addressable_shards:
        c = coord[shard.device.id]
        seen.add(c)
        block = tleaf.shards[c]
        assert block.device == tleaf.mesh.devices[c], what
        assert block.is_contiguous(), what
        want = np.asarray(shard.data)
        got = block.float().numpy() if block.is_floating_point() \
            else block.numpy()
        assert got.shape == want.shape, (what, c)
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f"{what} at {c}")
    assert seen == set(tleaf.shards), what


@pytest.mark.parametrize("kind", ["dense", "int8", "moe"])
def test_place_params_and_state_match_the_reference_shards(kind):
    jm, tmm = meshes(dp=2, tp=2, ep=2) if kind == "moe" else \
        meshes(dp=2, tp=2)
    if kind == "moe":
        jcfg, _ = moe_configs()
        jparams = jmoe.init_moe_params(jax.random.key(3), jcfg)
    else:
        jcfg, _ = configs()
        jparams = jt.init_params(jax.random.key(3), jcfg)
    if kind == "int8":
        jparams = jquant.quantize_params(jparams)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    if kind == "moe":
        jplaced = jax.device_put(jparams, jmesh.moe_param_shardings(jm))
        tplaced = tmesh.place_tree(tparams, tmesh.moe_param_specs(), tmm)
    else:
        jplaced = jmesh.place_params(jparams, jm)
        tplaced = tmesh.place_params(tparams, tmm)
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jplaced)[0]:
        node = tplaced
        for key in path:
            node = node[key.key]
        assert_placed_like(node, jleaf, jm, f"{kind} {path}")
    if kind == "int8":
        return
    # the AdamW moments mirror the params' blocks; the count stays whole
    jopt, topt = jtrain.make_optimizer(), train.make_optimizer()
    if kind == "moe":
        jstate = jtrain.place_moe_state(jtrain.init_state(jparams, jopt), jm)
        tstate = train.place_moe_state(train.init_state(tparams, topt), tmm)
    else:
        jstate = jtrain.place_state(jtrain.init_state(jparams, jopt), jm)
        tstate = train.place_state(train.init_state(tparams, topt), tmm)
    adam = next(x for x in jax.tree.leaves(
        jstate["opt"], is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
    for name in ("mu", "nu"):
        for path, jleaf in jax.tree_util.tree_flatten_with_path(
                getattr(adam, name))[0]:
            node = tstate["opt"][name]
            for key in path:
                node = node[key.key]
            assert_placed_like(node, jleaf, jm, f"{name} {path}")
    specs = train._opt_shardings(tstate["opt"], tparams,
                                 tmesh.moe_param_specs() if kind == "moe"
                                 else None)
    assert specs["count"] is None and tstate["opt"]["count"] == 0
    assert tstate["step"] == 0


def test_place_data_and_full_round_trip():
    _, tmm = meshes(dp=2, sp=2, tp=2)
    tokens = torch.from_numpy(batch()[0]).long()
    placed = tmesh.place_data(tokens, tmm)
    assert placed.at(dp=1, sp=1, tp=0).shape == (2, 16)
    assert torch.equal(placed.at(dp=1, sp=1), tokens[2:, 16:])
    assert torch.equal(placed.full(), tokens)


# ---------------------------------------------------------------------------
# train steps against the reference
# ---------------------------------------------------------------------------

def run_reference(jcfg, mesh_kw, steps, ring=False, moe=False, seed=1,
                  inputs=None):
    jm, _ = meshes(**mesh_kw)
    jopt = jtrain.make_optimizer(lr=LR)
    if moe:
        jparams = jmoe.init_moe_params(jax.random.key(seed), jcfg)
        jstate = jtrain.place_moe_state(jtrain.init_state(jparams, jopt), jm)
        jstep = jtrain.make_moe_train_step(jcfg, jopt, jm)
    else:
        jparams = jt.init_params(jax.random.key(seed), jcfg)
        jstate = jtrain.place_state(jtrain.init_state(jparams, jopt), jm)
        jstep = jtrain.make_train_step(jcfg, jopt, jm, ring_attention=ring)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    i, t = inputs if inputs is not None else batch()
    losses = []
    for _ in range(steps):
        jstate, loss = jstep(jstate, jnp.asarray(i), jnp.asarray(t))
        losses.append(float(loss))
    return tparams, losses, np_tree(jstate["params"])


def run_port(tcfg, tparams, mesh_kw, steps, ring=False, moe=False,
             inputs=None, check_replicas=False):
    topt = train.make_optimizer(lr=LR)
    state = train.init_state(train.tree_map(torch.clone, tparams), topt)
    if mesh_kw is None:
        where = "cpu"
    else:
        _, where = meshes(**mesh_kw)
        state = (train.place_moe_state if moe else train.place_state)(
            state, where)
    step = (train.make_moe_train_step(tcfg, topt, where) if moe else
            train.make_train_step(tcfg, topt, where, ring_attention=ring))
    i, t = inputs if inputs is not None else batch()
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.from_numpy(i), torch.from_numpy(t))
        losses.append(loss.item())
        if check_replicas:
            assert_replicas_equal(state)
    return state, losses


def assert_replicas_equal(state):
    for tree in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for leaf in _sharded_leaves(tree):
            for group in leaf.groups():
                first = leaf.shards[group[0]]
                for c in group[1:]:
                    assert torch.equal(leaf.shards[c], first), (leaf, c)


def _sharded_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _sharded_leaves(v)
    else:
        yield tree


STEP_CASES = {
    "dp2": (dict(dp=2, tp=1), {}, False),
    "tp2": (dict(dp=1, tp=2), {}, False),
    "dp2xtp2": (dict(dp=2, tp=2), {"n_kv_heads": 2}, False),
    "sp2-zigzag": (dict(dp=1, tp=1, sp=2), {}, True),
    "sp2-banded-w8": (dict(dp=1, tp=1, sp=2), {"attn_window": 8}, True),
    "sp2-banded-w20": (dict(dp=1, tp=1, sp=2), {"attn_window": 20}, True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_mesh_steps_match_the_reference(case):
    mesh_kw, cfg_kw, ring = STEP_CASES[case]
    jcfg, tcfg = configs(**cfg_kw)
    tparams, jlosses, jparams = run_reference(jcfg, mesh_kw, 3, ring=ring)
    state, losses = run_port(tcfg, tparams, mesh_kw, 3, ring=ring,
                             check_replicas=True)
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), f"step {i}"
    assert_close_tree(train.gather_state(state)["params"], jparams,
                      "params")
    assert losses[-1] < losses[0]


def test_three_ep2_moe_steps_match_the_reference():
    jcfg, tcfg = moe_configs()
    inputs = batch(9, 4, 32)
    tparams, jlosses, jparams = run_reference(
        jcfg, dict(dp=1, tp=1, ep=2), 3, moe=True, seed=4, inputs=inputs)
    state, losses = run_port(tcfg, tparams, dict(dp=1, tp=1, ep=2), 3,
                             moe=True, inputs=inputs, check_replicas=True)
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), f"step {i}"
    assert_close_tree(train.gather_state(state)["params"], jparams,
                      "params", share=PARAM_SHARE)
    # the ep form dispatches, combines and sums as the unsharded step:
    # on the CPU the same bits
    _, plain = run_port(tcfg, tparams, None, 3, moe=True, inputs=inputs)
    assert losses == plain


@pytest.mark.parametrize("mesh_kw,moe", [
    (dict(dp=2, tp=2), False), (dict(dp=2, tp=1, ep=2), True),
    (dict(dp=1, tp=2, ep=2), True),
])
def test_sharded_steps_equal_the_ports_unsharded_step(mesh_kw, moe):
    """Against the port's own one-device step from the same weights, and
    two runs of the sharded step give the same bits."""
    if moe:
        _, tcfg = moe_configs()
        params = tm.init_moe_params(torch.Generator().manual_seed(6), tcfg,
                                    "cpu")
    else:
        _, tcfg = configs(n_kv_heads=2)
        params = tt.init_params(torch.Generator().manual_seed(6), tcfg,
                                "cpu")
    inputs = batch(11, 4, 32)
    plain_state, plain = run_port(tcfg, params, None, 3, moe=moe,
                                  inputs=inputs)
    state, losses = run_port(tcfg, params, mesh_kw, 3, moe=moe,
                             inputs=inputs, check_replicas=True)
    again, losses2 = run_port(tcfg, params, mesh_kw, 3, moe=moe,
                              inputs=inputs)
    assert losses == losses2
    for a, b in zip(train.tree_leaves(state["params"]),
                    train.tree_leaves(again["params"])):
        assert torch.equal(a, b)
    for got, want in zip(losses, plain):
        assert abs(got - want) <= TOL * max(1.0, abs(want))
    full = train.gather_state(state)["params"]
    for a, b in zip(train.tree_leaves(full),
                    train.tree_leaves(plain_state["params"])):
        torch.testing.assert_close(a, b, atol=2 * LR, rtol=0)


def test_accum_and_clip_over_a_mesh_match_the_unsharded_step():
    _, tcfg = configs()
    params = tt.init_params(torch.Generator().manual_seed(7), tcfg, "cpu")
    topt = train.make_optimizer(lr=LR, clip_norm=0.5)
    inputs = [torch.from_numpy(x) for x in batch(12, 8, 32)]
    plain = train.init_state(train.tree_map(torch.clone, params), topt)
    step = train.make_train_step(tcfg, topt, "cpu", accum_steps=2)
    _, tmm = meshes(dp=2, tp=2)
    placed = train.place_state(train.init_state(params, topt), tmm)
    mstep = train.make_train_step(tcfg, topt, tmm, accum_steps=2)
    for _ in range(3):
        plain, want = step(plain, *inputs)
        placed, got = mstep(placed, *inputs)
        assert abs(got.item() - want.item()) <= TOL * max(1, want.item())
    assert_replicas_equal(placed)
    with pytest.raises(ValueError, match="accum_steps\\*dp"):
        train.make_train_step(tcfg, topt, tmm, accum_steps=3)(placed,
                                                              *inputs)


def test_sp_without_the_ring_gathers_kv():
    """sp > 1 without ring attention: the plain path over the gathered
    K/V (the reference's GSPMD path), equal to the unsharded step."""
    _, tcfg = configs(attn_window=12)
    params = tt.init_params(torch.Generator().manual_seed(8), tcfg, "cpu")
    _, plain = run_port(tcfg, params, None, 2)
    _, got = run_port(tcfg, params, dict(dp=1, tp=1, sp=4), 2)
    for a, b in zip(got, plain):
        assert abs(a - b) <= TOL * max(1.0, b)


def test_train_loop_over_a_mesh():
    _, tcfg = configs()
    params = tt.init_params(torch.Generator().manual_seed(9), tcfg, "cpu")
    topt = train.make_optimizer(lr=LR)
    _, tmm = meshes(dp=2, tp=1)
    state = train.place_state(train.init_state(params, topt), tmm)
    loop = train.make_train_loop(tcfg, topt, tmm, 3)
    state, losses = loop(state, *(torch.from_numpy(x) for x in batch()))
    assert losses.shape == (3,) and state["step"] == 3
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# registry, checkpoint, payload
# ---------------------------------------------------------------------------

MESH_SHAPES = [{"sp": 2}, {"dp": 2, "sp": 2, "tp": 2}, {"dp": 2, "tp": 2},
               {"dp": 4}, {"tp": 3}, None]


def test_decide_over_sp_meshes_and_the_ring_kind_equals_the_references():
    n = 0
    for shape, (h, hkv), kind, impl, batch_n, seq in itertools.product(
            MESH_SHAPES, ((4, 4), (4, 2)), ("prefill", "ring"),
            ("auto", "kernel", "xla", "flash", "splash"), (None, 6, 8),
            (256, 4096)):
        if kind == "ring" and impl in ("flash", "splash"):
            continue
        kw = dict(seq=seq, n_heads=h, n_kv_heads=hkv, head_dim=128,
                  mesh_shape=shape, impl=impl, batch=batch_n)

        def call(fn, platform, err):
            try:
                return fn(kind, platform=platform, **kw)
            except err as e:
                return ("raised", e.impl, e.detail)
        ref = call(jreg.decide, "tpu", jreg.KernelUnavailable)
        ours = call(registry.decide, "cuda", registry.KernelUnavailable)
        if ref[0] == "raised" or ours[0] == "raised":
            assert ours == ref, (shape, h, hkv, kind, impl, batch_n)
        elif ref[1].startswith(("mesh:", "ring:", "batch:")):
            assert ours == ref, (shape, kind, impl, batch_n)
        n += 1
    assert n > 200
    _, tmm = meshes(dp=1, tp=1, sp=2)
    choice = registry.select_attention("ring", mesh=tmm, zigzag=True)
    assert (choice.impl, choice.reason) == ("xla", "ring:spmd-merge")
    _, no_sp = meshes(dp=2, tp=1)
    assert registry.decide("ring", mesh_shape=dict(no_sp.shape)) == \
        ("xla", "ring:spmd-merge")


def test_checkpoint_saved_on_one_mesh_resumes_on_another(tmp_path):
    _, tcfg = configs()
    params = tt.init_params(torch.Generator().manual_seed(10), tcfg, "cpu")
    topt = train.make_optimizer(lr=LR)
    inputs = [torch.from_numpy(x) for x in batch(13)]
    _, m22 = meshes(dp=2, tp=2)
    state = train.place_state(train.init_state(params, topt), m22)
    step22 = train.make_train_step(tcfg, topt, m22)
    for _ in range(2):
        state, _ = step22(state, *inputs)
    ckpt = TrainCheckpointer(tmp_path)
    ckpt.save(state)
    whole = torch.load(tmp_path / "step_2.pt", weights_only=True)
    assert whole["params"]["layers"]["wq"].shape == (2, 64, 64)
    uninterrupted = []
    for _ in range(2):
        state, loss = step22(state, *inputs)
        uninterrupted.append(loss.item())
    for kw in (dict(dp=1, tp=1), dict(dp=2, tp=1)):
        _, m = meshes(**kw)
        back = ckpt.restore(tcfg, m)
        assert back["step"] == 2 and back["opt"]["count"] == 2
        step = train.make_train_step(tcfg, topt, m)
        resumed = []
        for _ in range(2):
            back, loss = step(back, *inputs)
            resumed.append(loss.item())
        for a, b in zip(resumed, uninterrupted):
            assert abs(a - b) <= TOL * max(1.0, b), kw
    dense = ckpt.restore(tcfg, "cpu", step=2)
    assert dense["params"]["embed"].shape == (256, 64)


@pytest.mark.parametrize("flags", [
    ["--dp", "2", "--tp", "1"], ["--sp", "2", "--tp", "1"], ["--tp", "2"],
    ["--dp", "2", "--tp", "2"]])
def test_payload_trains_and_resumes_over_a_mesh(flags, tmp_path, capsys):
    """Over ``mesh_devices`` the flags factorize as the reference's
    ``make_mesh`` does over its devices (``--dp 2`` alone over two
    devices would ask tp for them too)."""
    n = int(np.prod([int(v) for v in flags[1::2]]))
    args = ["--device", "cpu", "--batch", "4", "--seq", "16",
            "--checkpoint-dir", str(tmp_path), "--save-every", "2"] + flags
    assert train_payload.main(args + ["--steps", "2"],
                              mesh_devices=["cpu"] * n) == 0
    first = capsys.readouterr().out
    assert "mesh: {" in first and "trained 2 steps" in first
    assert train_payload.main(args + ["--steps", "4"],
                              mesh_devices=["cpu"] * n) == 0
    second = capsys.readouterr().out
    assert "resumed from step 2" in second and "trained 2 steps" in second


def test_sharded_attention_forms_and_the_mesh_policy_on_the_cpu():
    """B.10's / B.8's forms through the registry: on a CPU tensor the
    plain twin per (dp, tp) shard, rank order equal to one unsharded
    call; an explicit kernel on a CPU tensor raises; the step's policy
    refuses ``use_flash=True`` under sp and counts the CPU fallback."""
    from tpushare_torch.workloads.ops.attention import (
        flash_attention_plain, make_mesh_attention, make_sharded_flash)
    _, m22 = meshes(dp=2, tp=2)
    g = torch.Generator().manual_seed(14)
    q = torch.randn(4, 32, 4, 16, generator=g)
    k, v = (torch.randn(4, 32, 2, 16, generator=g) for _ in range(2))
    choice = registry.select_attention(
        "prefill", seq=32, mesh=m22, n_heads=4, n_kv_heads=2, head_dim=16,
        platform="cpu", batch=4)
    assert (choice.impl, choice.reason) == ("xla", "platform:cpu")
    torch.testing.assert_close(choice.fn(q, k, v),
                               flash_attention_plain(q, k, v), rtol=0,
                               atol=1e-6)
    with pytest.raises(registry.KernelUnavailable, match="CUDA device"):
        make_sharded_flash(m22)(q, k, v)
    _, tcfg = configs(n_kv_heads=2)
    registry.reset_fallbacks()
    attn = make_mesh_attention(tcfg, m22)
    keys = [(0, 0), (0, 1)]
    shards = [{key: x[:2, :, t * x.shape[2] // 2:(t + 1) * x.shape[2] // 2]
               .contiguous() for key, t in zip(keys, (0, 1))}
              for x in (q, k, v)]
    out = attn(*shards)
    assert sorted(out) == keys
    torch.testing.assert_close(torch.cat([out[key] for key in keys], 2),
                               flash_attention_plain(q[:2], k[:2], v[:2]),
                               rtol=0, atol=1e-6)
    assert registry.fallback_counts() == {("flash", "platform:cpu"): 1}
    _, sp2 = meshes(dp=1, tp=1, sp=2)
    with pytest.raises(registry.KernelUnavailable, match="sp=2"):
        make_mesh_attention(dataclasses.replace(tcfg, use_flash=True), sp2)
