"""Sharded serving (tp×pp) of the port against the reference's
``tests/test_sharded_serving.py`` on the CPU: the port's
``PagedServingEngine(mesh=)`` over a serving mesh that names the CPU
four times, held against the reference's sharded engine on its fake CPU
devices and against the port's unsharded engine — f32, the reference's
``init_params`` carried across by ``bridge``, seeded prompts.

What is compared, per the reference's scenarios: greedy tokens (tp2 on
both pool codecs; tp2×pp2 with a mid-run join; a pipelined multi-chunk
prefill), the sampled stream (port sharded against port unsharded: the
generators are torch's), prefix subscribers and spec rounds with their
counters, the composed int8 + prefix + spec run, the reference's storm
with exact accounting and no leaked page, the handoff layout guard, the
contract errors word for word, and the telemetry keys. The port's
sharded logprobs are also held bitwise to its unsharded ones: on the CPU
a column shard of a projection is bitwise the full product's columns,
and the gathered activations feed the same down-projections. The ragged
slot read under a (dp, tp) mesh, the registry's sharded read forms and
``decide`` over a grid of mesh shapes are checked against the reference
too. The reference's sharded runs are the expensive part (JAX compiles
each program); they run once, in a module fixture.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare.workloads.parallel import mesh as jmesh  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.tpu.fake import (WorkloadFault,  # noqa: E402
                                     WorkloadFaultPlan)
from tpushare_torch.workloads import bridge, overload, paging  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads import sharded_pool  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import (  # noqa: E402
    ragged_decode as ragged_ops, registry)
from tpushare_torch.workloads.ops.paged_attention import (  # noqa: E402
    paged_decode)
from tpushare_torch.workloads.overload import (  # noqa: E402
    AdmissionController)
from tpushare_torch.workloads.parallel import mesh as tmesh  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request, ServingEngine)

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")
CODECS = ("bf16", "int8")
ENGINE_KW = dict(n_lanes=3, max_seq=64, n_pages=25, page_size=8,
                 prompt_buckets=(8, 32), chunk=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_telemetry_providers():
    yield
    from tpushare.workloads.telemetry import set_snapshot_provider
    from tpushare_torch.workloads import telemetry
    set_snapshot_provider(None)
    telemetry.set_snapshot_provider(None)


def prompt(key: int, n: int) -> list:
    return [int(t) for t in np.random.default_rng(
        20_000 + key).integers(0, CFG.vocab, n)]


def port_mesh(tp: int = 1, pp: int = 1):
    return tmesh.make_serving_mesh(tp, pp, devices=["cpu"] * (tp * pp))


def ref_mesh(tp: int = 1, pp: int = 1):
    return jmesh.make_serving_mesh(tp, pp, devices=jax.devices()[:tp * pp])


def paged(side: str, mesh=None, **kw):
    kw = {**ENGINE_KW, **kw}
    if side == "ref":
        if "draft" in kw:
            kw["draft"] = (JPARAMS, JCFG, kw["draft"])
        return jserving.PagedServingEngine(JPARAMS, JCFG, mesh=mesh, **kw)
    if "draft" in kw:
        kw["draft"] = (PARAMS, CFG, kw["draft"])
    return PagedServingEngine(PARAMS, CFG, mesh=mesh, **kw)


def req(side: str, p: list, max_new: int, **kw):
    cls = jserving.Request if side == "ref" else Request
    return cls(prompt=list(p), max_new=max_new, **kw)


def assert_no_leaks(eng):
    assert eng.alloc.pages_in_use() == 0
    assert eng.alloc.leaked() == 0
    assert eng.alloc.free_pages() == eng.alloc.usable_pages


# ---------------------------------------------------------------------------
# the scenarios, each written once for both packages
# ---------------------------------------------------------------------------

def s_wave(side, mesh, kv_codec):
    eng = paged(side, mesh, kv_codec=kv_codec)
    reqs = [req(side, prompt(40 + i, 4 + 5 * i), 5 + 2 * i)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng


def s_join(side, mesh, kv_codec):
    eng = paged(side, mesh, kv_codec=kv_codec)
    first = [req(side, prompt(60 + i, 6), 20) for i in range(2)]
    for r in first:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    late = req(side, prompt(70, 5), 8)
    eng.submit(late)
    eng.run()
    return first + [late], eng


def s_long_prompt(side, mesh, kv_codec="bf16"):
    eng = paged(side, mesh, max_seq=128, n_pages=40)
    r = req(side, prompt(81, 70), 10)              # 2 x 32 full + a rest
    eng.submit(r)
    eng.run()
    return [r], eng


def s_prefix(side, mesh, kv_codec):
    eng = paged(side, mesh, n_pages=40, kv_codec=kv_codec)
    eng.register_prefix("sys", prompt(7, 12))      # 12 % 8: a CoW tail
    reqs = [req(side, prompt(90 + i, 5), 8, prefix="sys") for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng


def s_spec(side, mesh, kv_codec):
    eng = paged(side, mesh, n_pages=60, draft=3, kv_codec=kv_codec)
    reqs = [req(side, prompt(75 + i, 6), 10) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng


def s_composed(side, mesh, kv_codec="int8"):
    eng = paged(side, mesh, n_pages=80, kv_codec="int8", draft=3)
    eng.register_prefix("sys", prompt(17, 12))
    reqs = [req(side, prompt(100 + i, 5), 8, prefix="sys")
            for i in range(2)]
    reqs.append(req(side, prompt(110, 6), 8))
    for r in reqs:
        eng.submit(r)
    eng.run()
    eng.drop_prefix("sys")
    return reqs, eng


def s_handoff(side, mesh, kv_codec):
    """A running request handed between two pools of the same layout."""
    src, dst = paged(side, mesh, kv_codec=kv_codec), \
        paged(side, mesh, kv_codec=kv_codec)
    r = req(side, prompt(150, 6), 20)
    src.submit(r)
    for _ in range(2):
        src.step()
    assert not r.done
    assert dst.install_request(src.extract_request(0)) is not None
    src.detach_request(0)
    dst.run()
    assert_no_leaks(src)
    return [r], dst


# scenario -> (mesh degrees, codecs); the reference's sharded engine runs
# each once per codec in the module fixture
SCENARIOS = {
    "wave": (s_wave, (2, 1), CODECS),
    "join": (s_join, (2, 2), CODECS),
    "long_prompt": (s_long_prompt, (2, 2), ("bf16",)),
    "prefix": (s_prefix, (2, 2), CODECS),
    "spec": (s_spec, (2, 1), CODECS),
    "composed": (s_composed, (2, 2), ("int8",)),
    "handoff": (s_handoff, (2, 1), CODECS),
}
CASES = [(name, codec) for name, (_, _, codecs) in SCENARIOS.items()
         for codec in codecs]

STAT_KEYS = ("completed", "prefix_hits", "cow_copies", "spec_rounds",
             "spec_accepted", "spec_drafted", "prefill_chunks")


def _view(reqs, eng):
    return {"tokens": [list(r.output) for r in reqs],
            "stats": {k: eng.stats[k] for k in STAT_KEYS},
            "in_use": eng.alloc.pages_in_use()}


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded engine over its fake CPU devices, once
    per (scenario, codec)."""
    out = {}
    for name, codec in CASES:
        fn, (tp, pp), _ = SCENARIOS[name]
        out[(name, codec)] = _view(*fn("ref", ref_mesh(tp, pp), codec))
    return out


@pytest.mark.parametrize("name,codec", CASES)
def test_scenario_matches_the_references_sharded_engine_and_unsharded(
        name, codec, ref_sharded):
    """Tokens, counters and pool occupancy of the port's sharded engine
    equal the reference's sharded engine's and the port's unsharded
    engine's; the logprobs equal the unsharded engine's bit for bit."""
    fn, (tp, pp), _ = SCENARIOS[name]
    reqs, eng = fn("port", port_mesh(tp, pp), codec)
    base_reqs, base = fn("port", None, codec)
    got, want = _view(reqs, eng), _view(base_reqs, base)
    assert got == want
    assert got == ref_sharded[(name, codec)]
    assert [r.logprobs for r in reqs] == [r.logprobs for r in base_reqs]
    assert all(r.status == consts.STATUS_COMPLETED for r in reqs)
    if name == "spec":
        assert eng.stats["spec_rounds"] > 0
        assert eng._dalloc.pages_in_use() == 0
    if name in ("prefix",):
        assert eng.alloc.pages_in_use() == len(eng.prefixes["sys"][1])
        eng.drop_prefix("sys")
    assert_no_leaks(eng)


def test_pipelined_prefill_matches_the_offline_decode():
    """The GPipe'd multi-chunk prefill (two full chunks through two
    stages in one dispatch, then the rest) is the offline decode."""
    reqs, eng = s_long_prompt("port", port_mesh(2, 2))
    want = tdec.generate(PARAMS, torch.tensor([prompt(81, 70)]), CFG, 10)
    assert reqs[0].output == want[0].tolist()
    assert eng.stats["prefill_chunks"] == 3


def test_sharded_sampling_stream_equals_the_unsharded_engines():
    """Seeded sampling (temperature, nucleus): the sharded engine's
    logits and its lanes' generators are the unsharded engine's, so the
    sampled tokens match one for one (JAX's PRNG is not torch's, so the
    reference's stream is not the comparison here)."""
    def run(mesh):
        eng = paged("port", mesh)
        reqs = [req("port", prompt(30 + i, 5), 8, temperature=0.8,
                    top_p=0.9) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [(r.output, r.logprobs) for r in reqs]
    assert run(port_mesh(2, 2)) == run(None)


# ---------------------------------------------------------------------------
# the storm, the handoff guard, the contract, the telemetry
# ---------------------------------------------------------------------------

def test_sharded_storm_exact_accounting_zero_leaks():
    """The reference's storm on the tp2 engine: OOM storm, hung sync,
    4x queue burst — every request accounted once, degraded then
    recovered, and the pool drains to zero."""
    plan = WorkloadFaultPlan()
    plan.add("dispatch", WorkloadFault(times=3, kind="oom"))
    plan.add("sync", WorkloadFault(times=1, kind="hang", delay_s=0.6))
    ctl = AdmissionController(3, md_cooldown_s=0.0, ai_step=0.5)
    eng = paged("port", port_mesh(2), queue_limit=4, faults=plan,
                admission=ctl, sync_timeout_s=0.1)
    reqs = [req("port", prompt(120 + i, 4 + (i % 5)), 6 + (i % 3))
            for i in range(16)]
    saw_degraded, done = threading.Event(), threading.Event()

    def poll():
        while not done.is_set():
            if not eng.healthz()["ok"]:
                saw_degraded.set()
            time.sleep(0.005)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        done.set()
        poller.join()
    by = {s: sum(1 for r in reqs if r.status == s)
          for s in overload.TERMINAL_STATUSES}
    assert all(r.done and r.status in overload.TERMINAL_STATUSES
               for r in reqs)
    assert eng.stats["completed"] == by[overload.STATUS_COMPLETED]
    assert eng.stats["shed"] == by[overload.STATUS_SHED] == 12
    assert eng.stats["oom_quarantined"] == \
        by[overload.STATUS_OOM_QUARANTINED]
    assert eng.stats["oom_recoveries"] == 3
    assert saw_degraded.is_set() and eng.healthz()["ok"]
    assert_no_leaks(eng)
    extra = req("port", prompt(140, 5), 6)
    eng.submit(extra)
    eng.run()
    assert extra.status == consts.STATUS_COMPLETED
    want = tdec.generate(PARAMS, torch.tensor([extra.prompt]), CFG, 6)
    assert extra.output == want[0].tolist()
    assert_no_leaks(eng)


@pytest.mark.parametrize("kv_codec", CODECS)
def test_sharded_handoff_token_exact_and_layout_guard(kv_codec):
    """A request handed between two same-mesh sharded pools (its pages
    split like the pool) finishes as the unmigrated request does (the
    handoff scenario above holds it to both packages' handoffs); a
    sharded record into an unsharded pool, and back, is a layout
    mismatch refused through the reference's contract string."""
    mesh = port_mesh(2)
    (r,), dst = s_handoff("port", mesh, kv_codec)
    solo = paged("port", None, kv_codec=kv_codec)
    alone = req("port", prompt(150, 6), 20)
    solo.submit(alone)
    solo.run()
    assert r.output == alone.output
    assert_no_leaks(dst)
    plain = paged("port", None, kv_codec=kv_codec)
    plain.submit(req("port", prompt(151, 6), 20))
    for _ in range(2):
        plain.step()
    record = plain.extract_request(0)
    assert (record["mesh_tp"], record["mesh_pp"]) == (1, 1)
    with pytest.raises(ValueError) as err:
        dst.install_request(record)
    assert str(err.value) == jconsts.ERR_HANDOFF_POOL_FMT.format(
        src=f"{kv_codec}/8r", dst=f"{kv_codec}/8r/tp2xpp1")
    other = paged("port", mesh, kv_codec=kv_codec)
    other.submit(req("port", prompt(152, 6), 20))
    for _ in range(2):
        other.step()
    sharded_record = other.extract_request(0)
    assert (sharded_record["mesh_tp"], sharded_record["mesh_pp"]) == (2, 1)
    with pytest.raises(ValueError, match="page handoff layout mismatch"):
        plain.install_request(sharded_record)
    assert dst.pool_layout == f"{kv_codec}/8r/tp2xpp1"


def test_serving_mesh_contract_errors_word_for_word():
    """Untileable models refuse through ERR_SERVING_MESH_* at the mesh
    helper, at engine construction and for pp over the layer stack —
    the same text as the reference's; degrees read as the reference's;
    int8 weights and MoE are refused under a mesh."""
    bad_heads = dataclasses.replace(CFG, d_model=60, n_heads=3)
    jbad = dataclasses.replace(JCFG, d_model=60, n_heads=3)
    for cfg, jcfg, tp, pp in ((bad_heads, jbad, 2, 1),
                              (dataclasses.replace(CFG, n_layers=3),
                               dataclasses.replace(JCFG, n_layers=3), 1, 2),
                              (dataclasses.replace(CFG, d_ff=127),
                               dataclasses.replace(JCFG, d_ff=127), 2, 1)):
        with pytest.raises(ValueError) as ours:
            tmesh.check_serving_mesh(cfg, port_mesh(tp, pp))
        with pytest.raises(ValueError) as ref:
            jmesh.check_serving_mesh(jcfg, ref_mesh(tp, pp))
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="must both divide by tp"):
        PagedServingEngine(PARAMS, bad_heads, n_lanes=2, max_seq=64,
                           n_pages=9, page_size=8, mesh=port_mesh(2))
    assert tmesh.serving_degrees(None) == jmesh.serving_degrees(None)
    assert tmesh.serving_degrees(port_mesh(2)) == \
        jmesh.serving_degrees(ref_mesh(2)) == (2, 1)
    with pytest.raises(ValueError, match="must both be >= 1"):
        tmesh.make_serving_mesh(tp=0)
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.make_serving_mesh(tp=4, pp=4, devices=["cpu"] * 8)
    from tpushare_torch.workloads.quant import qmm
    with pytest.raises(ValueError, match="plain weight path"):
        paged("port", port_mesh(2), mm=qmm)
    from tpushare_torch.workloads.models.moe import MoEConfig
    moe = MoEConfig(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                    max_seq=64, n_experts=2, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="dense-only"):
        PagedServingEngine({}, moe, n_lanes=2, max_seq=64, n_pages=9,
                           page_size=8, mesh=port_mesh(2))


def test_sharded_telemetry_keys_equal_the_references():
    """The mesh degrees and the per-shard pool claim ride sharded
    snapshots with the reference's values; unsharded engines omit the
    mesh keys and report the whole pool."""
    snaps = {}
    for side, mesh in (("port", port_mesh(2, 2)), ("ref", ref_mesh(2, 2)),
                       ("port-plain", None)):
        eng = paged(side.split("-")[0], mesh)
        snaps[side] = eng.telemetry.snapshot()
    keys = (consts.TELEMETRY_MESH_TP, consts.TELEMETRY_MESH_PP,
            consts.TELEMETRY_KV_POOL_SHARD_MIB,
            consts.TELEMETRY_KV_BYTES_PER_TOKEN)
    assert {k: snaps["port"][k] for k in keys} == \
        {k: snaps["ref"][k] for k in keys}
    assert snaps["port"][consts.TELEMETRY_MESH_TP] == 2
    plain = snaps["port-plain"]
    assert consts.TELEMETRY_MESH_TP not in plain
    assert plain[consts.TELEMETRY_KV_POOL_SHARD_MIB] == pytest.approx(
        paging.pool_hbm_mib(25, 8, CFG.n_layers, CFG.kv_heads,
                            CFG.head_dim, "bf16"), abs=0.1)


def test_sharded_pool_layout_splits_heads_and_layers():
    """Shard (s, r) of the pool holds stage s's layers and rank r's KV
    heads, ``q`` and ``s`` planes together; the weights split by column
    in rank order."""
    eng = paged("port", port_mesh(2, 2), kv_codec="int8")
    k = eng.state["k"]
    assert len(k) == 2 and len(k[0]) == 2
    assert tuple(k[1][1]["q"].shape) == (1, 25, 8, 2, 16)
    assert tuple(k[1][1]["s"].shape) == (1, 25, 8, 2)
    st = eng.params["stages"]
    wq = PARAMS["layers"]["wq"]
    assert torch.equal(st[1]["ranks"][1]["wq"], wq[1:2, :, 32:])
    assert torch.equal(st[0]["lead"]["wo"], PARAMS["layers"]["wo"][:1])
    spec = sharded_pool.pool_spec("int8")
    assert spec["q"][0] == "pp" and spec["s"][3] == "tp"


# ---------------------------------------------------------------------------
# the ragged read under a (dp, tp) mesh; the registry's sharded forms
# ---------------------------------------------------------------------------

RCFG = tt.TransformerConfig(vocab=128, d_model=256, n_heads=2, n_layers=2,
                            d_ff=256, max_seq=256, dtype=torch.float32)
JRCFG = jt.TransformerConfig(**{**{f.name: getattr(RCFG, f.name)
                                   for f in dataclasses.fields(RCFG)},
                                "dtype": jnp.float32})


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_ragged_under_dp_tp_mesh(kv_int8):
    """ragged × (dp=2, tp=2): each shard's slot and head reads through
    the ragged read on its device, the outputs in rank order — the
    transcripts equal the unsharded ragged engine's and the dense slot
    engine's; f32 bf16-free, so the reference's dense slot engine too."""
    jparams = jt.init_params(jax.random.key(3), JRCFG)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    mesh = tmesh.Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]],
                               dtype=object), ("dp", "tp"))
    base = dataclasses.replace(RCFG, kv_int8=kv_int8)

    def run(cfg, **kw):
        reqs = [Request(prompt=prompt(31, 9), max_new=7),
                Request(prompt=prompt(32, 25), max_new=6)]
        eng = ServingEngine(params, cfg, n_slots=2, max_seq=256,
                            prompt_buckets=(16,), chunk=3, **kw)
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    ragged = run(dataclasses.replace(base, ragged_decode=True), mesh=mesh)
    assert ragged == run(dataclasses.replace(base, ragged_decode=True))
    assert ragged == run(base)
    if not kv_int8:
        jreqs = [jserving.Request(prompt=prompt(31, 9), max_new=7),
                 jserving.Request(prompt=prompt(32, 25), max_new=6)]
        jeng = jserving.ServingEngine(jparams, JRCFG, n_slots=2,
                                      max_seq=256, prompt_buckets=(16,),
                                      chunk=3)
        for r in jreqs:
            jeng.submit(r)
        jeng.run()
        assert ragged == [r.output for r in jreqs]


def test_check_ragged_config_mesh_divisibility_as_the_references():
    cfg = dataclasses.replace(RCFG, n_layers=1)
    jcfg = dataclasses.replace(JRCFG, n_layers=1)
    mesh = tmesh.Mesh(np.array([["cpu"] * 4], dtype=object), ("dp", "tp"))
    jm = jmesh.make_mesh(4, dp=1, tp=4)
    with pytest.raises(registry.KernelUnavailable) as ours:
        tdec.check_ragged_config(cfg, 256, mesh=mesh)
    with pytest.raises(jreg.KernelUnavailable) as ref:
        jdec.check_ragged_config(jcfg, 256, mesh=jm)
    assert ours.value.detail == ref.value.detail
    assert "divide by tp" in ours.value.detail
    with pytest.raises(ValueError, match="divide by tp"):
        ServingEngine(PARAMS, dataclasses.replace(cfg, ragged_decode=True),
                      n_slots=2, max_seq=256, mesh=mesh)


@pytest.mark.parametrize("int8", [False, True])
def test_registry_sharded_reads_equal_one_unsharded_read(int8):
    """The paged read over the engine's KV-head pool shards
    (``sharded_pool.place_state``) and the (dp, tp) ragged read, shard
    by shard and concatenated in rank order, equal one unsharded read
    bitwise (per-head softmax); the per-shard read is the mesh-less one,
    and a ragged shard on the cache's device is a view of the cache
    (no copy), whose row pitch the kernel is handed."""
    g = torch.Generator().manual_seed(5)
    mesh = port_mesh(2)
    q = torch.randn(3, 8, 16, generator=g)
    pool = torch.randn(9, 8, 4, 16, generator=g)
    vpool = torch.randn(9, 8, 4, 16, generator=g)
    kp, vp = ((tdec.kv_quantize(pool), tdec.kv_quantize(vpool)) if int8
              else (pool, vpool))
    tables = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 7, 8]],
                          dtype=torch.int32)
    lens = torch.tensor([10, 17, 24], dtype=torch.int32)
    whole = paged_decode(q, kp, vp, tables, lens)

    def stacked(leaf):
        return ({n: t[None] for n, t in leaf.items()}
                if isinstance(leaf, dict) else leaf[None])
    state = sharded_pool.place_state({"k": stacked(kp), "v": stacked(vp)},
                                     mesh, "int8" if int8 else "bf16")
    sharded = torch.cat([paged_decode(
        q[:, r * 4:(r + 1) * 4], tdec.kv_view(state["k"][0][r], 0),
        tdec.kv_view(state["v"][0][r], 0), tables, lens) for r in range(2)],
        dim=1)
    assert torch.equal(whole, sharded)
    rmesh = tmesh.Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]],
                                dtype=object), ("dp", "tp"))
    cache = torch.randn(2, 4, 64, 4, 16, generator=g)
    vcache = torch.randn(2, 4, 64, 4, 16, generator=g)
    kc, vc = ((tdec.kv_quantize(cache), tdec.kv_quantize(vcache)) if int8
              else (cache, vcache))
    q4 = torch.randn(4, 8, 16, generator=g)
    rl = torch.tensor([0, 5, 33, 63], dtype=torch.int32)
    one = registry._build_decode_ragged(None)(q4, kc, vc, rl, layer=1)
    meshed = registry._build_decode_ragged(rmesh, batch=4)(q4, kc, vc, rl,
                                                          layer=1)
    assert torch.equal(one, meshed)
    layer = tdec.kv_view(kc, 1)
    part = registry._shard(layer, slice(2, 4), slice(2, 4),
                           torch.device("cpu"))
    for plane, whole_plane in zip(tdec.kv_planes(part),
                                  tdec.kv_planes(layer)):
        assert plane.untyped_storage().data_ptr() == \
            whole_plane.untyped_storage().data_ptr()
        assert ragged_ops._row_heads(plane, tuple(plane.shape)) == 4
        assert ragged_ops._row_heads(plane.contiguous(),
                                     tuple(plane.shape)) == 2
    assert ragged_ops._row_heads(cache[1].transpose(1, 2),
                                 (4, 4, 64, 16)) is None


MESH_SHAPES = [None, {"tp": 1}, {"tp": 2}, {"tp": 4}, {"tp": 3},
               {"dp": 2, "tp": 2}, {"tp": 2, "pp": 2}, {"dp": 4}]


def test_decide_over_a_mesh_shape_grid_equals_the_references():
    """Both packages' ``decide`` over mesh shapes × heads × kinds ×
    impls (platform mapped "tpu" <-> "cuda"): the same implementation
    and reason, or the same refusal."""
    n = 0
    for shape, (h, hkv), kind, impl, plat, seq in itertools.product(
            MESH_SHAPES, ((4, 4), (4, 2), (6, 3), (3, 3)),
            ("decode", "prefill"), ("auto", "kernel", "xla", "ragged",
                                    "flash"),
            (("tpu", "cuda"), ("cpu", "cpu")), (256, 512)):
        if (kind == "decode" and impl == "flash") or \
                (kind == "prefill" and impl == "ragged") or \
                (plat[1] == "cpu" and impl != "auto"):
            # the CPU's explicit kernels are a documented difference
            continue
        kw = dict(seq=seq, n_heads=h, n_kv_heads=hkv, head_dim=128)

        def call(fn, platform, err):
            try:
                return fn(kind, mesh_shape=shape, platform=platform,
                          impl=impl, **kw)
            except err as e:
                return ("raised", e.impl, e.detail)

        ref = call(jreg.decide, plat[0], jreg.KernelUnavailable)
        ours = call(registry.decide, plat[1], registry.KernelUnavailable)
        if ref[0] == "raised" or ours[0] == "raised":
            assert ours[:2] == ref[:2], (shape, h, hkv, kind, impl, plat)
            if "tp=" in str(ref[2]):
                assert ours[2] == ref[2]
        elif ref[1].startswith("mesh:"):
            assert ours == ref
        else:
            # away from the mesh rows the two tables differ only by the
            # documented platform reasons (ROADMAP §C)
            assert ours[0] == ref[0] or ref[1] in ("short-seq:flash",
                                                   "gqa:flash-grouped",
                                                   "seq:untiled")
        n += 1
    assert n > 300


def test_infer_mesh_flags_refuse_as_the_reference(monkeypatch):
    """``infer --tp/--pp`` with ``--fleet`` or ``--int8``, or a model the
    mesh cannot tile, exits 2 on both payloads."""
    from tpushare.workloads import infer as jinfer
    # the reference payload writes its allocator knobs into the env
    # unless isolation is off; keep this process's env as it is
    monkeypatch.setenv(consts.ENV_DISABLE_ISOLATION, "true")
    from tpushare_torch.workloads import infer
    for flags in (["--tp", "2", "--fleet", "2"], ["--tp", "2", "--int8"],
                  ["--tp", "3"]):
        with pytest.raises(SystemExit) as ours:
            infer.main(["--device", "cpu", "--mode", "serve", *flags])
        assert ours.value.code == 2
        assert jinfer.main(["--mode", "serve", *flags]) == 2, flags
