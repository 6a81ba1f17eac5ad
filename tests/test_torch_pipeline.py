"""The port's pipeline parallelism (``parallel/pipeline``) on the CPU,
held against the reference's ``tests/test_pipeline.py`` cases: pp2 and
pp2 x tp2 losses and three train steps against the reference's
``pp_loss_fn`` / ``make_pp_train_step`` on the same mesh shape, GQA,
remat, pp x sp (contiguous and banded ring in the stages), dp batch
parity, the validation errors; the MoE pipeline (pp x ep) against the
port's own unsharded MoE step (the reference's
``test_moe_pp_train_step_matches_plain`` is red, ROADMAP §C)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.parallel import pipeline as jpipe  # noqa: E402
from tpushare.workloads.parallel.mesh import make_mesh as jmake  # noqa: E402
from tpushare_torch.workloads import bridge, train  # noqa: E402
from tpushare_torch.workloads.models import moe as tm  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.parallel import pipeline as pl  # noqa: E402
from tpushare_torch.workloads.parallel.mesh import make_mesh  # noqa: E402

TOL = 1e-5          # fp32: summation order only
LR = 3e-4
PARAM_SHARE = 1e-4
TINY = dict(vocab=128, d_model=64, n_heads=4, n_layers=4, d_ff=128,
            max_seq=64)


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
    jcfg = jt.TransformerConfig(**{**TINY, **kw}, dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return jcfg, tt.TransformerConfig(**fields)


def toks(b=4, s=32, seed=1):
    t = np.random.default_rng(seed).integers(0, TINY["vocab"], (b, s))
    return t.astype(np.int32), np.roll(t, -1, axis=1).astype(np.int32)


def tmesh(**kw):
    n = int(np.prod(list(kw.values())))
    return make_mesh(devices=["cpu"] * n, **kw)


def jmesh(**kw):
    n = int(np.prod(list(kw.values())))
    return jmake(n, devices=jax.devices()[:n], **kw)


def bridged(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def port_pp_loss(tcfg, tparams, mesh, inputs, targets, n_micro):
    state = pl.place_pp_state(train.init_state(tparams,
                                               train.make_optimizer()), mesh)
    return pl.pp_loss_fn(state["params"], torch.from_numpy(inputs),
                         torch.from_numpy(targets), tcfg, mesh,
                         n_micro).item()


@pytest.mark.parametrize("pp,n_micro,dp,tp,kv_heads", [
    (2, 2, 2, 1, None), (2, 4, 1, 1, None), (4, 2, 1, 1, None),
    (2, 2, 1, 2, None), (2, 2, 2, 2, 2),
])
def test_pp_loss_matches_the_reference_and_plain(pp, n_micro, dp, tp,
                                                 kv_heads):
    jcfg, tcfg = configs(n_kv_heads=kv_heads)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = bridged(jparams)
    inputs, targets = toks(8, 32)
    kw = dict(dp=dp, tp=tp, pp=pp)
    ref = float(jax.jit(lambda p, i, t: jpipe.pp_loss_fn(
        p, i, t, jcfg, jmesh(**kw), n_micro))(
        jparams, jnp.asarray(inputs), jnp.asarray(targets)))
    got = port_pp_loss(tcfg, tparams, tmesh(**kw), inputs, targets, n_micro)
    plain = tt.loss_fn(tparams, torch.from_numpy(inputs),
                       torch.from_numpy(targets), tcfg).item()
    assert abs(got - ref) <= TOL * max(1.0, abs(ref))
    assert abs(got - plain) <= TOL * max(1.0, abs(plain))


@pytest.mark.parametrize("kw", [dict(dp=2, tp=1, pp=2),
                                dict(dp=1, tp=2, pp=2)])
def test_three_pp_train_steps_match_the_reference(kw):
    jcfg, tcfg = configs()
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tparams = bridged(jparams)
    inputs, targets = toks(8, 32, seed=2)
    jm = jmesh(**kw)
    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jpipe.place_pp_state(jtrain.init_state(jparams, jopt), jm)
    jstep = jpipe.make_pp_train_step(jcfg, jopt, jm, n_micro=2)
    m = tmesh(**kw)
    topt = train.make_optimizer(lr=LR)
    state = pl.place_pp_state(train.init_state(tparams, topt), m)
    step = pl.make_pp_train_step(tcfg, topt, m, n_micro=2)
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(inputs), jnp.asarray(targets))
        state, tl = step(state, torch.from_numpy(inputs),
                         torch.from_numpy(targets))
        assert abs(tl.item() - float(jl)) <= TOL * max(1.0, float(jl)), i
        losses.append(tl.item())
    assert losses[-1] < losses[0] and state["step"] == 3
    want = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jstate["params"])
    # Adam's first update g / (|g| + eps) turns summation-order noise in
    # a gradient near 0 into a step of either sign: every element within
    # 2 lr, all but PARAM_SHARE within TOL (tests/test_torch_moe.py's
    # rule; the GPipe microbatches sum the gradients in another order)
    got = train.gather_state(state)["params"]
    n_off = n_all = 0
    for path, ref in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), ref, atol=2 * LR, rtol=0,
                                   err_msg=str(path))
        n_off += int((np.abs(node.numpy() - ref)
                      > TOL * (1 + np.abs(ref))).sum())
        n_all += ref.size
    assert n_off <= PARAM_SHARE * n_all
    # the replicas of every block stay bitwise equal
    for tree in (state["params"], state["opt"]["mu"]):
        for leaf in _sharded(tree):
            for group in leaf.groups():
                for c in group[1:]:
                    assert torch.equal(leaf.shards[c],
                                       leaf.shards[group[0]])


def _sharded(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _sharded(v)
    else:
        yield tree


def run_steps(tcfg, params, mesh, n=3, n_micro=2, pp=True, moe=False,
              inputs=None):
    topt = train.make_optimizer(lr=LR)
    state = train.init_state(train.tree_map(torch.clone, params), topt)
    if mesh is None:
        step = (train.make_moe_train_step if moe else
                train.make_train_step)(tcfg, topt, "cpu")
    elif moe:
        state = pl.place_moe_pp_state(state, mesh)
        step = pl.make_moe_pp_train_step(tcfg, topt, mesh, n_micro=n_micro)
    else:
        state = pl.place_pp_state(state, mesh)
        step = pl.make_pp_train_step(tcfg, topt, mesh, n_micro=n_micro)
    i, t = inputs if inputs is not None else toks(8, 32, seed=3)
    losses = []
    for _ in range(n):
        state, loss = step(state, torch.from_numpy(i), torch.from_numpy(t))
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("cfg_kw,mesh_kw", [
    (dict(n_kv_heads=2), dict(dp=1, tp=2, pp=2)),        # GQA under tp
    (dict(), dict(dp=1, tp=1, sp=2, pp=2)),              # ring in stages
    (dict(attn_window=12), dict(dp=1, tp=1, sp=2, pp=2)),  # banded ring
    (dict(), dict(dp=1, tp=2, sp=2, pp=2)),              # the full stack
])
def test_pp_steps_match_the_ports_unsharded_step(cfg_kw, mesh_kw):
    _, tcfg = configs(**cfg_kw)
    params = tt.init_params(torch.Generator().manual_seed(4), tcfg, "cpu")
    _, plain = run_steps(tcfg, params, None)
    _, piped = run_steps(tcfg, params, tmesh(**mesh_kw))
    for a, b in zip(piped, plain):
        assert abs(a - b) <= TOL * max(1.0, abs(b))


def test_pp_remat_matches():
    _, tcfg = configs()
    params = tt.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    m = tmesh(dp=1, tp=2, pp=2)
    s0, l0 = run_steps(tcfg, params, m, n=2)
    s1, l1 = run_steps(dataclasses.replace(tcfg, remat=True), params, m, n=2)
    assert l0 == l1
    for a, b in zip(train.tree_leaves(s0["params"]),
                    train.tree_leaves(s1["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dp", [1, 2])
def test_pp_dp_sharded_batch_parity(dp):
    """Each dp rank pipelines its own batch shard: the loss is the
    global mean whatever dp is."""
    _, tcfg = configs()
    params = tt.init_params(torch.Generator().manual_seed(6), tcfg, "cpu")
    inputs, targets = toks(8, 32, seed=7)
    got = port_pp_loss(tcfg, params, tmesh(dp=dp, tp=1, pp=2), inputs,
                       targets, 2)
    plain = tt.loss_fn(params, torch.from_numpy(inputs),
                       torch.from_numpy(targets), tcfg).item()
    assert abs(got - plain) <= TOL * max(1.0, plain)


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_pp_validation_errors_are_the_references():
    jcfg, tcfg = configs()
    jopt, topt = jtrain.make_optimizer(), train.make_optimizer()
    odd = dict(n_layers=3)
    cases = [
        (lambda j: jpipe.make_pp_train_step(
            dataclasses.replace(jcfg, **odd), jopt, jmesh(dp=4, tp=1, pp=2)),
         lambda: pl.make_pp_train_step(
            dataclasses.replace(tcfg, **odd), topt, tmesh(dp=4, tp=1, pp=2))),
        (lambda j: jpipe.make_pp_train_step(jcfg, jopt, jmesh(dp=8, tp=1)),
         lambda: pl.make_pp_train_step(tcfg, topt, tmesh(dp=8, tp=1))),
        (lambda j: jpipe.make_pp_train_step(
            jcfg, jopt, jmesh(dp=2, ep=2, tp=1, pp=2)),
         lambda: pl.make_pp_train_step(tcfg, topt,
                                       tmesh(dp=2, ep=2, tp=1, pp=2))),
        (lambda j: jpipe._check_pp(jcfg, jmesh(dp=4, tp=1, pp=2), 3, 4),
         lambda: pl._check_pp(tcfg, tmesh(dp=4, tp=1, pp=2), 3, 4)),
        (lambda j: jpipe._check_pp(jcfg, jmesh(dp=2, tp=2, pp=2), 2,
                                   moe=True),
         lambda: pl._check_pp(tcfg, tmesh(dp=2, tp=2, pp=2), 2, moe=True)),
    ]
    for jfn, tfn in cases:
        want = _refusal(lambda: jfn(None))
        assert want is not None and _refusal(tfn) == want


def test_moe_pp_steps_match_the_ports_unsharded_moe_step():
    """pp2 x ep2 (and x dp2) at n_micro=1, where the per-microbatch aux
    is the full batch's: the unsharded MoE step's losses and params."""
    tcfg = tm.MoEConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                        d_ff=64, max_seq=32, n_experts=4, expert_top_k=2,
                        dtype=torch.float32)
    params = tm.init_moe_params(torch.Generator().manual_seed(8), tcfg,
                                "cpu")
    inputs = toks(4, 32, seed=9)
    plain_state, plain = run_steps(tcfg, params, None, moe=True,
                                   inputs=inputs)
    state, piped = run_steps(tcfg, params, tmesh(dp=1, tp=1, ep=2, pp=2),
                             n_micro=1, moe=True, inputs=inputs)
    for a, b in zip(piped, plain):
        assert abs(a - b) <= TOL * max(1.0, abs(b))
    full = train.gather_state(state)["params"]
    for a, b in zip(train.tree_leaves(full),
                    train.tree_leaves(plain_state["params"])):
        torch.testing.assert_close(a, b, atol=2 * LR, rtol=0)
    # dp2: each dp rank routes its own shard, as the reference's manual
    # dp does; n_micro=2 averages per-microbatch auxes
    _, losses = run_steps(tcfg, params, tmesh(dp=2, tp=1, ep=2, pp=2),
                          n_micro=2, moe=True, inputs=inputs)
    assert abs(losses[0] - plain[0]) <= 1e-2 and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="MoE pipeline parallelism"):
        pl.make_moe_pp_train_step(tcfg, train.make_optimizer(),
                                  tmesh(dp=1, tp=2, pp=2))
