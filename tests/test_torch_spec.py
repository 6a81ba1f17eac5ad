"""Speculative decoding in the port, held against the reference on the
CPU (the reference's ``tests/test_spec.py`` and
``tests/test_paged_spec.py``):

- ``spec_generate`` at k = 2..5 with a perfect and an unrelated draft:
  f32 tokens identical to the port's ``generate`` and to the
  reference's ``spec_generate``, with equal round / accept counts;
- ``spec_slot_round`` and ``decode.spec_draft_scan`` against the
  reference's on the same caches and pools;
- both engines with ``draft=``: transcripts and ``spec_rounds`` /
  ``spec_drafted`` / ``spec_accepted`` / ``spec_emitted`` /
  ``spec_rounds_skipped`` (and, on the paged engine, the allocator
  snapshot after every step) equal to the reference engine's on one
  scripted request sequence; prefix subscribers over both pool codecs,
  spec against non-spec; a rejected tail restoring both allocators bit
  for bit; the chaos storm with speculation armed; the forecast's spec
  tail, counted skips, the telemetry, the draft contract's strings;
- ``infer --draft-k`` on a tiny preset with ``--device cpu``.
"""

import dataclasses
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
from tpushare.workloads import spec as jspec  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.tpu.fake import (WorkloadFault,  # noqa: E402
                                     WorkloadFaultPlan)
from tpushare_torch.workloads import bridge, infer, overload  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads import serving  # noqa: E402
from tpushare_torch.workloads.decode import generate  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request, ServingEngine)
from tpushare_torch.workloads.spec import (  # noqa: E402
    spec_generate, spec_slot_round)


def torch_cfg(jcfg):
    return tt.TransformerConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)},
                                   "dtype": torch.float32})


def bridged(jcfg, seed):
    jp = jt.init_params(jax.random.key(seed), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
# an unrelated tiny draft: near-zero acceptance, exactness must hold
JDCFG = jt.TransformerConfig(vocab=128, d_model=32, n_heads=2, n_layers=1,
                             d_ff=64, max_seq=256, dtype=jnp.float32)
CFG, DCFG = torch_cfg(JCFG), torch_cfg(JDCFG)
JPARAMS, PARAMS = bridged(JCFG, 0)
JDPARAMS, DPARAMS = bridged(JDCFG, 99)
DRAFTS = {"perfect": ((PARAMS, CFG), (JPARAMS, JCFG)),
          "random": ((DPARAMS, DCFG), (JDPARAMS, JDCFG))}
ENGINE_KW = dict(max_seq=64, prompt_buckets=(8, 32), chunk=4)
PAGED_KW = dict(n_lanes=3, n_pages=30, page_size=8, **ENGINE_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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
            np.random.default_rng(seed).integers(0, CFG.vocab, n)]


def offline(prompt, steps):
    return generate(PARAMS, torch.tensor([prompt]), CFG, steps)[0].tolist()


def draft_of(name, k):
    (p, c), (jp, jc) = DRAFTS[name]
    return (p, c, k), (jp, jc, k)


def spec_stats(eng):
    return {k: eng.stats[k] for k in (
        "spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
        "spec_rounds_skipped", "chunks", "lane_steps")}


def assert_both_pools_clean(eng):
    for alloc in (eng.alloc, eng._dalloc):
        if alloc is not None:
            assert alloc.pages_in_use() == 0 and alloc.leaked() == 0


# ---------------------------------------------------------------------------
# spec_generate and the device programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("draft", ["perfect", "random"])
def test_spec_generate_matches_generate_and_reference(draft, k):
    """f32 tokens equal to ``generate`` at every k; tokens and stats equal
    to the reference's ``spec_generate`` at k = 3 and 5 (each k and
    draft is one more XLA compile of the reference's loop)."""
    prompt = rand_prompt(2 + k, 9)
    steps = 13
    (dp, dc, _), (jdp, jdc, _) = draft_of(draft, k)
    got, stats = spec_generate(PARAMS, dp, torch.tensor([prompt]), CFG, dc,
                               steps, k)
    assert got[0].tolist() == offline(prompt, steps)
    assert stats["drafted"] == stats["rounds"] * k
    if k in (3, 5):
        want, jstats = jspec.spec_generate(JPARAMS, jdp,
                                           jnp.asarray([prompt], jnp.int32),
                                           JCFG, jdc, steps, k)
        assert got[0].tolist() == np.asarray(want)[0].tolist()
        assert stats == {key: int(v) for key, v in jstats.items()}
    if draft == "perfect":
        assert stats["accepted"] == stats["drafted"]
        assert stats["accepted_capped"] <= stats["drafted"] * (k - 1) / k


def test_spec_generate_rejects_batches_and_k0():
    with pytest.raises(ValueError, match="batch=1"):
        spec_generate(PARAMS, PARAMS, torch.zeros(2, 4, dtype=torch.int64),
                      CFG, CFG, 4)
    with pytest.raises(ValueError, match="k=0"):
        spec_generate(PARAMS, PARAMS, torch.zeros(1, 4, dtype=torch.int64),
                      CFG, CFG, 4, k=0)


def test_spec_slot_round_and_draft_scan_match_reference():
    """One slot round on slot 1 of two-slot caches (after the same
    admission on both packages) and one paged draft scan over the same
    pools: tokens, logprobs and accepted counts equal; caches within
    fp32 summation noise."""
    prompt = rand_prompt(40, 7)
    k = 3
    tslots = serving.init_slots(CFG, 2, 64, torch.device("cpu"))
    tds = serving.init_slots(DCFG, 2, 64, torch.device("cpu"))
    jslots = jserving.init_slots(JCFG, 2, 64)
    jds = jserving.init_slots(JDCFG, 2, 64)
    arr = torch.tensor([prompt + [0]])
    jarr = jnp.asarray([prompt + [0]], jnp.int32)
    serving.ingest_chunk(PARAMS, arr, tslots, 1, 0, 7, 6, CFG)
    serving.ingest_chunk(DPARAMS, arr, tds, 1, 0, 7, 6, DCFG)
    jslots = jserving.ingest_chunk(JPARAMS, jarr, jslots, jnp.int32(1),
                                   jnp.int32(0), jnp.int32(7), jnp.int32(6),
                                   JCFG)
    jds = jserving.ingest_chunk(JDPARAMS, jarr, jds, jnp.int32(1),
                                jnp.int32(0), jnp.int32(7), jnp.int32(6),
                                JDCFG)
    g, lp, a, tslots, tds = spec_slot_round(PARAMS, DPARAMS, tslots, tds, 1,
                                            CFG, DCFG, k)
    jg, jlp, ja, jslots, jds = jspec.spec_slot_round(
        JPARAMS, JDPARAMS, jslots, jds, jnp.int32(1), JCFG, JDCFG, k)
    assert g.tolist() == np.asarray(jg).tolist() and int(a) == int(ja)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)
    assert tslots["lengths"].tolist() == np.asarray(jslots["lengths"]).tolist()
    np.testing.assert_allclose(tslots["k"].numpy(), np.asarray(jslots["k"]),
                               atol=1e-5)
    np.testing.assert_allclose(tds["v"].numpy(), np.asarray(jds["v"]),
                               atol=1e-5)
    # the paged draft scan: two lanes, one inactive, over random pools
    rng = np.random.default_rng(41)
    pool = rng.standard_normal((1, 9, 8, 2, 16)).astype(np.float32) * 0.3
    tables = np.array([[4, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([11, 0], np.int32)
    tokens = np.array([5, 9])
    active = np.array([True, False])
    tstate = {"k": torch.from_numpy(pool.copy()),
              "v": torch.from_numpy(pool[:, ::-1].copy()),
              "tables": torch.from_numpy(tables),
              "lengths": torch.from_numpy(lengths)}
    jstate = {"k": jnp.asarray(pool), "v": jnp.asarray(pool[:, ::-1]),
              "tables": jnp.asarray(tables), "lengths": jnp.asarray(lengths)}
    drafts, tk, _ = tdec.spec_draft_scan(
        DPARAMS, tstate, torch.from_numpy(tokens), torch.from_numpy(active),
        DCFG, tt.rope_tables(DCFG, 64, "cpu"), k, gather_pages_w=4)
    jdrafts, jk, _ = jdec.spec_draft_scan(
        JDPARAMS, jstate, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(active), JDCFG, jt.rope_tables(JDCFG, 64), k,
        gather_pages_w=4)
    assert drafts.tolist() == np.asarray(jdrafts).tolist()
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


# ---------------------------------------------------------------------------
# both engines against the reference engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["perfect", "random"])
def test_slot_engine_spec_matches_reference_engine(draft):
    """Single occupancy runs spec rounds, two live requests the chunk
    path (the draft catches up when occupancy drops): transcripts and
    spec counters equal to the reference engine's."""
    tdraft, jdraft = draft_of(draft, 4)
    specs = [dict(prompt=rand_prompt(50, 6), max_new=20),
             dict(prompt=rand_prompt(51, 9), max_new=6)]
    eng = ServingEngine(PARAMS, CFG, n_slots=2, draft=tdraft, **ENGINE_KW)
    jeng = jserving.ServingEngine(JPARAMS, JCFG, n_slots=2, draft=jdraft,
                                  **ENGINE_KW)
    outs = []
    for e, cls in ((eng, Request), (jeng, jserving.Request)):
        reqs = [cls(**s) for s in specs]
        for r in reqs:
            e.submit(r)
        e.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert outs[0] == [offline(s["prompt"], s["max_new"]) for s in specs]
    assert spec_stats(eng) == spec_stats(jeng)
    assert eng.stats["spec_rounds"] > 0
    assert eng.telemetry.snapshot()[consts.TELEMETRY_SPEC_ROUNDS] == \
        eng.stats["spec_rounds"]


SCRIPT = [  # (step, prompt seed, prompt length, max_new, temperature)
    (0, 60, 5, 10, 0.0), (0, 61, 8, 12, 0.0), (0, 62, 7, 9, 0.0),
    (2, 63, 6, 8, 0.0), (5, 64, 4, 7, 0.8), (9, 65, 7, 11, 0.0)]


def scripted(eng, mk, script=SCRIPT, prefix=None):
    reqs, trail, i = [], [], 0
    while i < 60 and (i <= script[-1][0] or eng.queue or eng.running):
        for at, seed, n, new, temp in script:
            if at == i:
                r = mk(prompt=rand_prompt(seed, n), max_new=new,
                       temperature=temp, prefix=prefix)
                reqs.append(r)
                eng.submit(r)
        eng.step()
        trail.append((eng.alloc.snapshot(), eng._dalloc.snapshot(),
                      spec_stats(eng)))
        i += 1
    return reqs, trail


@pytest.mark.parametrize("draft", ["perfect", "random"])
def test_paged_engine_spec_matches_reference_step_by_step(draft):
    """Batched rounds under multi-lane occupancy, a joiner, a sampling
    request (its lanes block rounds, counted): after every step both
    allocators' snapshots and the spec counters equal the reference
    engine's; greedy transcripts equal the reference's and the offline
    decode."""
    tdraft, jdraft = draft_of(draft, 4)
    reqs, trail = scripted(PagedServingEngine(PARAMS, CFG, draft=tdraft,
                                              **PAGED_KW), Request)
    jreqs, jtrail = scripted(
        jserving.PagedServingEngine(JPARAMS, JCFG, draft=jdraft,
                                    attn_impl="xla", **PAGED_KW),
        jserving.Request)
    assert trail == jtrail
    stats = trail[-1][2]
    assert stats["spec_rounds"] > 0
    assert stats["spec_rounds_skipped"].get("sampling", 0) > 0
    for r, jr in zip(reqs, jreqs):
        assert r.status == jr.status == overload.STATUS_COMPLETED
        if r.temperature == 0:
            assert r.output == jr.output == offline(r.prompt, r.max_new)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_paged_spec_prefix_subscribers_exact(codec):
    """Spec against non-spec engines serving the same prefix subscribers
    (an unaligned prefix: the round's writes cross the page-boundary
    CoW fence) on both codecs: identical transcripts, the pinned pages
    of both pools bitwise unchanged, both pools empty after the drop;
    the prefix counters equal the reference spec engine's."""
    sys_toks = rand_prompt(7, 13)
    outs = {}
    for tag, draft in (("plain", None), ("spec", draft_of("perfect", 4)[0])):
        eng = PagedServingEngine(PARAMS, CFG, kv_codec=codec, draft=draft,
                                 **PAGED_KW)
        eng.register_prefix("sys", sys_toks)
        pools = [(eng.state, eng.prefixes["sys"][1])]
        if draft is not None:
            assert eng._dalloc.pages_in_use() == 2
            pools.append((eng.dstate, eng._dprefixes["sys"][1]))
        before = [p[:, ids].clone() for st, ids in pools
                  for leaf in (st["k"], st["v"]) for p in tdec.kv_planes(leaf)]
        reqs = [Request(prompt=rand_prompt(40 + i, 4 + i), max_new=10,
                        prefix="sys") for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[tag] = [r.output for r in reqs]
        after = [p[:, ids] for st, ids in pools
                 for leaf in (st["k"], st["v"]) for p in tdec.kv_planes(leaf)]
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        assert eng.stats["prefix_hits"] == 3 and eng.stats["cow_copies"] >= 3
        if draft is not None:
            assert eng.stats["spec_rounds"] > 0
            accept = eng.stats["spec_accepted"] / eng.stats["spec_drafted"]
            assert accept > 0.6     # the draft prefix mirror served
        if draft is not None and codec == "bf16":
            jeng = jserving.PagedServingEngine(
                JPARAMS, JCFG, kv_codec=codec, attn_impl="xla",
                draft=draft_of("perfect", 4)[1], **PAGED_KW)
            jeng.register_prefix("sys", sys_toks)
            for r in reqs:
                jeng.submit(jserving.Request(prompt=r.prompt, max_new=10,
                                             prefix="sys"))
            jeng.run()
            for key in ("prefix_hits", "cow_copies", "spec_rounds",
                        "spec_accepted", "spec_emitted"):
                assert eng.stats[key] == jeng.stats[key]
        eng.drop_prefix("sys")
        assert_both_pools_clean(eng)
    assert outs["spec"] == outs["plain"]
    if codec == "bf16":
        assert outs["plain"] == [offline(sys_toks + rand_prompt(40 + i, 4 + i),
                                         10) for i in range(3)]


def test_rejection_restores_both_allocators_bit_exactly():
    """A round positioned so its scratch tail takes a fresh page (L % 8
    == 4, k+1 = 5 rows cross the boundary) while the accepted prefix
    stays in the current page: after the round the block tables,
    refcounts and free lists of BOTH allocators are exactly the
    pre-round state, the tail page provably allocated and recycled."""
    eng = PagedServingEngine(PARAMS, CFG, draft=draft_of("random", 4)[0],
                             **PAGED_KW)
    req = Request(prompt=rand_prompt(70, 4), max_new=30)
    eng.submit(req)
    eng._admit_waiting()
    lane = next(iter(eng.running))
    assert eng._lengths[lane] == 4

    def state_of(alloc, tables):
        return (alloc.table(lane), dict(alloc._refs), sorted(alloc._free),
                tables[lane].clone())

    before = [state_of(eng.alloc, eng.state["tables"]),
              state_of(eng._dalloc, eng.dstate["tables"])]
    counts = (eng.alloc.allocs, eng.alloc.recycled)
    assert eng._spec_ready() and eng._spec_round_paged()
    assert eng.stats["spec_rounds"] == 1 and eng.stats["spec_accepted"] == 0
    assert (eng.alloc.allocs, eng.alloc.recycled) == (counts[0] + 1,
                                                      counts[1] + 1)
    after = [state_of(eng.alloc, eng.state["tables"]),
             state_of(eng._dalloc, eng.dstate["tables"])]
    for b, a in zip(before, after):
        assert b[:3] == a[:3] and torch.equal(b[3], a[3])
    eng.run()
    assert req.output == offline(req.prompt, req.max_new)
    assert_both_pools_clean(eng)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_spec_storm_exact_accounting_zero_leaks(codec):
    """The reference's acceptance storm with speculation armed: the
    dispatch OOMs land in rounds, the hung sync in a round's read;
    exact accounting (12 shed, 3 recoveries), degraded then ok, and both
    pools drain to zero."""
    plan = WorkloadFaultPlan()
    plan.add("dispatch", WorkloadFault(times=3, kind="oom"))
    plan.add("sync", WorkloadFault(times=1, kind="hang", delay_s=0.6))
    ctl = overload.AdmissionController(3, md_cooldown_s=0.0, ai_step=0.5)
    eng = PagedServingEngine(PARAMS, CFG, queue_limit=4, faults=plan,
                             admission=ctl, sync_timeout_s=0.1,
                             kv_codec=codec, draft=(PARAMS, CFG, 4),
                             **{**PAGED_KW, "n_pages": 25})
    reqs = [Request(prompt=rand_prompt(120 + i, 4 + (i % 5)),
                    max_new=6 + (i % 3)) for i in range(16)]
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
    assert eng.stats["shed"] == by[overload.STATUS_SHED] == 12
    assert eng.stats["oom_recoveries"] == 3
    assert eng.stats["completed"] == by[overload.STATUS_COMPLETED]
    assert eng.stats["spec_rounds"] > 0
    assert saw_degraded.is_set() and eng.healthz()["ok"]
    assert ctl.floor_reached == 1
    assert_both_pools_clean(eng)


def test_forecast_skips_telemetry_and_contract_match_reference():
    """The forecast grows by the k+1-row tail (for subscribers too); the
    spec keys ride drafted engines' snapshots only and reset with the
    stats; the draft contract's refusals are the reference's strings on
    both engines."""
    plain = PagedServingEngine(PARAMS, CFG, **PAGED_KW)
    drafted = PagedServingEngine(PARAMS, CFG, draft=(PARAMS, CFG, 4),
                                 **PAGED_KW)
    req = Request(prompt=rand_prompt(80, 8), max_new=8)
    assert drafted._forecast_pages(req) == plain._forecast_pages(req) + 1
    for e in (plain, drafted):
        e.register_prefix("sys", rand_prompt(81, 13))
    sub = Request(prompt=rand_prompt(82, 5), max_new=8, prefix="sys")
    assert drafted._forecast_pages(sub) == plain._forecast_pages(sub) + 1
    assert consts.TELEMETRY_SPEC_ROUNDS not in plain.telemetry.snapshot()
    assert drafted.telemetry.snapshot()[consts.TELEMETRY_SPEC_ROUNDS] == 0
    r = Request(prompt=rand_prompt(83, 6), max_new=10)
    drafted.submit(r)
    drafted.run()
    snap = drafted.telemetry.snapshot()
    assert snap[consts.TELEMETRY_SPEC_ROUNDS] == drafted.stats["spec_rounds"]
    assert snap[consts.TELEMETRY_SPEC_ACCEPT_RATE] == pytest.approx(
        drafted.stats["spec_accepted"] / drafted.stats["spec_drafted"],
        abs=1e-4)
    drafted.reset_stats()
    assert drafted.stats["spec_rounds_skipped"] == {}
    assert drafted.telemetry.snapshot()[consts.TELEMETRY_SPEC_ROUNDS] == 0
    for name in ("ERR_SPEC_MM", "ERR_SPEC_PIPELINE", "ERR_SPEC_MOE",
                 "ERR_SPEC_K_FMT", "ERR_SPEC_VOCAB"):
        assert getattr(consts, name) == getattr(jconsts, name)
    jd = jt.TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                              d_ff=64, max_seq=256, dtype=jnp.float32)
    wj = dataclasses.replace(JCFG, attn_window=16)
    cases = [((PARAMS, CFG, 1), (JPARAMS, JCFG, 1), {}),
             ((DPARAMS, torch_cfg(jd), 4), (JDPARAMS, jd, 4), {}),
             ((PARAMS, CFG, 4), (JPARAMS, JCFG, 4), {"pipeline": True})]
    for tdraft, jdraft, kw in cases:
        with pytest.raises(ValueError) as got:
            ServingEngine(PARAMS, CFG, n_slots=2, draft=tdraft, **kw,
                          **ENGINE_KW)
        with pytest.raises(ValueError) as want:
            jserving.ServingEngine(JPARAMS, JCFG, n_slots=2, draft=jdraft,
                                   **kw, **ENGINE_KW)
        assert str(got.value) == str(want.value)
        if not kw:
            with pytest.raises(ValueError) as got:
                PagedServingEngine(PARAMS, CFG, draft=tdraft, **PAGED_KW)
            assert str(got.value) == str(want.value)
    # a windowed draft fails the pool's config gate like any windowed
    # model; a windowed ring slot engine needs a windowed draft
    with pytest.raises(ValueError, match="ring cache"):
        PagedServingEngine(PARAMS, CFG, draft=(PARAMS, torch_cfg(wj), 4),
                           **PAGED_KW)
    wcfg = torch_cfg(wj)
    with pytest.raises(ValueError, match="windowed draft"):
        ServingEngine(PARAMS, wcfg, n_slots=2, ring_rows=48,
                      draft=(PARAMS, CFG, 4), **ENGINE_KW)


def test_payload_draft_flags_serve_and_report(capsys):
    """``infer --draft-k`` on both engines (self-draft and a random-init
    draft from an explicit generator): every request completes, spec
    rounds run, the reference's ``spec:`` line is printed."""
    base = ["--device", "cpu", "--mode", "serve", "--requests", "3",
            "--seq", "40", "--steps", "12", "--slots", "2",
            "--hbm-limit-mib", "2000", "--no-admission"]
    for flags in (["--paged", "--draft-k", "3", "--draft-dmodel", "0"],
                  ["--draft-k", "2", "--draft-dmodel", "64",
                   "--requests", "1"]):
        res = infer.run(infer.parse_args(base + flags))
        out = capsys.readouterr().out
        eng = res["engine"]
        assert eng.draft is not None and eng.draft[2] == int(flags[
            flags.index("--draft-k") + 1])
        assert all(r.status == "completed" for r in res["requests"])
        assert eng.stats["spec_rounds"] > 0
        assert "speculative serving: draft k=" in out
        assert "spec: rounds=" in out
    assert "(self-draft)" not in out and "d_model=64 x 1 layer(s)" in out
