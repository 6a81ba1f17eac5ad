"""The port's overload defense under injected faults, held against the
reference engines on the CPU: the reference's engine-level chaos
scenarios (``tests/test_serving_chaos.py``: bounded queue and reject
policies, deadlines in the queue and mid-decode, OOM at admission, at
dispatch and at the harvest, a hung sync, the typed drain timeout,
graceful drain, a never-fitting request, the stats reset, the
acceptance storm; ``tests/test_paged_serving.py``'s paged storm over
both pool codecs) run on the reference engine (JAX) and on the port's
(torch) with the same requests and fault plans. Statuses, the overload
counters, ``healthz``, the telemetry's key set and the greedy outputs of
completed requests must be equal; where a scenario depends on time only
what the reference's own test asserts is compared.

Then the port's own two readings: a real out-of-memory raised inside a
decode chunk (the port writes the pool and lane state in place) is
treated as the reference treats one at the harvest, and ``infer``'s
admission controller is sized by the paged engine's lanes where the
reference's non-fleet paged serve sizes it by ``--slots``.

One module-scoped f32 tiny config; the weights come across through
``bridge``."""

import dataclasses
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.tpu import fake as jfake  # noqa: E402
from tpushare.workloads import overload as joverload  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.tpu import fake  # noqa: E402
from tpushare_torch.workloads import bridge, overload  # noqa: E402
from tpushare_torch.workloads import serving  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
SLOT_KW = dict(n_slots=2, max_seq=64, prompt_buckets=(8,), chunk=4)
PAGED_KW = dict(n_lanes=3, max_seq=64, n_pages=25, page_size=8,
                prompt_buckets=(8, 32), chunk=4)
COMPILE_KEYS = {consts.TELEMETRY_COMPILES, consts.TELEMETRY_COMPILE_SECONDS}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes: one intra-op
    thread keeps these tiny models' many small ops from oversubscribing
    the cores (each op otherwise waits on every pool thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """The two packages behind one interface: engines, requests,
    admission controllers and fault plans."""
    jparams = jt.init_params(jax.random.key(0), JCFG)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    ref = SimpleNamespace(
        name="ref", params=jparams, cfg=JCFG, Slot=jserving.ServingEngine,
        Paged=jserving.PagedServingEngine, Request=jserving.Request,
        Admission=joverload.AdmissionController, overload=joverload,
        Plan=jfake.WorkloadFaultPlan, Fault=jfake.WorkloadFault,
        DrainTimeout=joverload.DrainTimeout)
    port = SimpleNamespace(
        name="port", params=params, cfg=CFG, Slot=serving.ServingEngine,
        Paged=serving.PagedServingEngine, Request=serving.Request,
        Admission=overload.AdmissionController, overload=overload,
        Plan=fake.WorkloadFaultPlan, Fault=fake.WorkloadFault,
        DrainTimeout=overload.DrainTimeout)
    return ref, port


@pytest.fixture(autouse=True)
def _clear_process_state():
    """Kernel-fallback counters are process-wide and ride every
    snapshot: start each comparison from none on both sides."""
    from tpushare.workloads.ops import registry as jregistry
    from tpushare_torch.workloads.ops import registry
    jregistry.reset_fallbacks()
    registry.reset_fallbacks()
    yield
    from tpushare.workloads.telemetry import set_snapshot_provider as jset
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    jset(None)
    set_snapshot_provider(None)


def prompt(n: int, salt: int) -> list:
    return [int(t) for t in np.random.default_rng(
        1000 * n + salt).integers(0, CFG.vocab, n)]


def req(side, n=5, max_new=6, **kw):
    return side.Request(prompt=prompt(n, max_new), max_new=max_new, **kw)


def slot(side, **kw):
    return side.Slot(side.params, side.cfg, **{**SLOT_KW, **kw})


def paged(side, **kw):
    return side.Paged(side.params, side.cfg, **{**PAGED_KW, **kw})


def outcome(side, eng, reqs) -> dict:
    """What must agree between the packages."""
    snap = eng.telemetry.snapshot()
    h = eng.healthz()
    return {
        "statuses": [r.status for r in reqs],
        "done": [r.done for r in reqs],
        "outputs": [r.output for r in reqs
                    if r.status == side.overload.STATUS_COMPLETED],
        "stats": {k: eng.stats[k] for k in (
            "completed", "shed", "deadline_exceeded", "oom_quarantined",
            "oom_recoveries", "requests_done", "tokens_emitted")},
        "healthz": {k: h[k] for k in ("ok", "degraded", "draining",
                                      "running", "queued", "watermark")},
        "snapshot_keys": sorted(set(snap) - COMPILE_KEYS),
        "telemetry": {k: snap[k] for k in (
            consts.TELEMETRY_SHED, consts.TELEMETRY_DEADLINE_EXCEEDED,
            consts.TELEMETRY_OOM_RECOVERIES, consts.TELEMETRY_DEGRADED,
            consts.TELEMETRY_QUEUE_DEPTH, consts.TELEMETRY_ADMITTED,
            consts.TELEMETRY_RETIRED, consts.TELEMETRY_ADMISSION_WATERMARK)},
    }


def assert_exact_accounting(side, eng, reqs):
    ov = side.overload
    for r in reqs:
        assert r.done and r.status in ov.TERMINAL_STATUSES, r.status
    by = {s: sum(1 for r in reqs if r.status == s)
          for s in ov.TERMINAL_STATUSES}
    assert eng.stats["completed"] == by[ov.STATUS_COMPLETED]
    assert eng.stats["shed"] == by[ov.STATUS_SHED]
    assert eng.stats["deadline_exceeded"] == by[ov.STATUS_DEADLINE_EXCEEDED]
    assert eng.stats["oom_quarantined"] == by[ov.STATUS_OOM_QUARANTINED]
    assert sum(by.values()) == len(reqs)


def run_polling_health(eng, body) -> bool:
    """Run ``body`` while a thread polls ``healthz``; True when it was
    seen not ok."""
    saw, done = threading.Event(), threading.Event()

    def poll():
        while not done.is_set():
            if not eng.healthz()["ok"]:
                saw.set()
            time.sleep(0.005)
    poller = threading.Thread(target=poll)
    poller.start()
    try:
        body()
    finally:
        done.set()
        poller.join()
    return saw.is_set()


# ---------------------------------------------------------------------------
# the reference's slot-engine scenarios, each returning its outcome
# ---------------------------------------------------------------------------

def bounded_queue_reject_new(side):
    eng = slot(side, n_slots=1, queue_limit=2)
    reqs = [req(side, 4 + i) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    assert [r.status for r in reqs[2:]] == ["shed"] * 4
    eng.run()
    assert_exact_accounting(side, eng, reqs)
    assert eng.stats["completed"] == 2
    return outcome(side, eng, reqs)


def bounded_queue_shed_oldest(side):
    eng = slot(side, n_slots=1, queue_limit=2,
               reject_policy=side.overload.SHED_OLDEST)
    reqs = [req(side, 4 + i) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    assert [r.status for r in reqs[:2]] == ["shed"] * 2
    eng.run()
    assert_exact_accounting(side, eng, reqs)
    return outcome(side, eng, reqs)


def deadline_expires_in_queue(side):
    eng = slot(side, n_slots=1)
    blocker = req(side, 5, max_new=8)
    eng.submit(blocker)
    doomed = [req(side, 4, max_new=4, deadline_s=0.0) for _ in range(3)]
    for r in doomed:
        eng.submit(r)
    eng.run()
    assert_exact_accounting(side, eng, [blocker] + doomed)
    assert all(r.output == [] for r in doomed)
    return outcome(side, eng, [blocker] + doomed)


def oom_at_admit(side):
    plan = side.Plan()
    plan.add("admit", side.Fault(times=1, kind="oom"))
    ctl = side.Admission(2, md_cooldown_s=0.0, ai_step=0.5)
    eng = slot(side, n_slots=2, faults=plan, admission=ctl)
    reqs = [req(side, 4 + i, max_new=6) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert_exact_accounting(side, eng, reqs)
    assert reqs[0].output == []
    return {**outcome(side, eng, reqs), "cuts": ctl.cuts,
            "watermark": ctl.watermark()}


def oom_storm_at_dispatch(side):
    plan = side.Plan()
    plan.add("dispatch", side.Fault(times=3, kind="oom"))
    ctl = side.Admission(2, md_cooldown_s=0.0, ai_step=0.25)
    eng = slot(side, n_slots=2, faults=plan, admission=ctl)
    reqs = [req(side, 4 + i, max_new=8) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert_exact_accounting(side, eng, reqs)
    quarantined = [r.output for r in reqs
                   if r.status == side.overload.STATUS_OOM_QUARANTINED]
    extra = req(side, 6, max_new=4)
    eng.submit(extra)
    eng.run()
    return {**outcome(side, eng, reqs + [extra]), "cuts": ctl.cuts,
            "quarantined_outputs": quarantined}


def oom_at_harvest(side):
    plan = side.Plan()
    plan.add("sync", side.Fault(times=1, kind="oom"))
    eng = slot(side, n_slots=2, faults=plan)
    reqs = [req(side, 4, max_new=8), req(side, 5, max_new=8)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert_exact_accounting(side, eng, reqs)
    partial = [r.output for r in reqs]
    extra = req(side, 6, max_new=4)
    eng.submit(extra)
    eng.run()
    return {**outcome(side, eng, reqs + [extra]), "partial": partial}


def hung_sync(side):
    plan = side.Plan()
    plan.add("sync", side.Fault(times=1, kind="hang", delay_s=0.6))
    eng = slot(side, n_slots=1, faults=plan, sync_timeout_s=0.1)
    r = req(side, 5, max_new=6)
    eng.submit(r)
    saw = run_polling_health(eng, eng.run)
    return {**outcome(side, eng, [r]), "saw_degraded": saw,
            "trips": eng.watchdog_trips}


def drain_timeout(side):
    eng = slot(side, n_slots=1)
    stuck, waiting = req(side, 5, max_new=50), req(side, 4, max_new=4)
    eng.submit(stuck)
    eng.submit(waiting)
    with pytest.raises(side.DrainTimeout) as ei:
        eng.run(max_iters=2)
    exc = ei.value
    assert "did not drain" in str(exc)
    caught = (stuck in exc.undrained, waiting in exc.undrained,
              exc.queue_depth, len(stuck.output))
    eng.run()
    return {**outcome(side, eng, [stuck, waiting]), "caught": caught}


def graceful_drain(side):
    eng = slot(side, n_slots=1)
    reqs = [req(side, 4 + i, max_new=6) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    summary = eng.drain()
    assert_exact_accounting(side, eng, reqs)
    late = req(side, 5)
    eng.submit(late)
    return {**outcome(side, eng, reqs + [late]),
            "summary_shed": summary["shed"]}


def never_fitting(side):
    ctl = side.Admission(2, cap_mib=0.0005)
    eng = slot(side, n_slots=2, admission=ctl)
    reqs = [req(side, 4), req(side, 5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return outcome(side, eng, reqs)


def reset_stats(side):
    eng = slot(side, n_slots=1, queue_limit=1)
    reqs = [req(side, 4 + i) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    before = eng.stats["shed"]
    eng.reset_stats()
    return {**outcome(side, eng, reqs), "shed_before": before}


def acceptance_storm(side):
    plan = side.Plan()
    plan.add("dispatch", side.Fault(times=3, kind="oom"))
    plan.add("sync", side.Fault(times=1, kind="hang", delay_s=0.6))
    ctl = side.Admission(2, md_cooldown_s=0.0, ai_step=0.5)
    eng = slot(side, n_slots=2, queue_limit=4, faults=plan, admission=ctl,
               sync_timeout_s=0.1)
    reqs = [req(side, 4 + (i % 5), max_new=6 + (i % 3)) for i in range(16)]

    def body():
        for r in reqs:
            eng.submit(r)
        eng.run()
    saw = run_polling_health(eng, body)
    assert_exact_accounting(side, eng, reqs)
    storm = outcome(side, eng, reqs)
    floor = ctl.floor_reached
    extras = [req(side, 5, max_new=6), req(side, 6, max_new=6)]
    for r in extras:
        eng.submit(r)
    eng.run()
    return {"storm": storm, "saw_degraded": saw, "floor": floor,
            "extras": outcome(side, eng, extras),
            "watermark": ctl.watermark()}


SLOT_SCENARIOS = {f.__name__: f for f in (
    bounded_queue_reject_new, bounded_queue_shed_oldest,
    deadline_expires_in_queue, oom_at_admit, oom_storm_at_dispatch,
    oom_at_harvest, hung_sync, drain_timeout, graceful_drain, never_fitting,
    reset_stats, acceptance_storm)}

# what the reference's own tests assert of each, checked on the port
EXPECT = {
    "bounded_queue_reject_new": lambda o: (
        o["stats"]["shed"] == 4 and o["telemetry"]["shed_total"] == 4
        and o["telemetry"]["queue_depth"] == 0),
    "bounded_queue_shed_oldest": lambda o: o["statuses"] == [
        "shed", "shed", "completed", "completed"],
    "deadline_expires_in_queue": lambda o: o["statuses"] == [
        "completed"] + ["deadline_exceeded"] * 3
        and o["telemetry"]["deadline_exceeded_total"] == 3,
    "oom_at_admit": lambda o: o["statuses"] == [
        "oom_quarantined", "completed", "completed"]
        and o["stats"]["oom_recoveries"] == 1 and o["cuts"] == 1
        and o["watermark"] == 2,
    "oom_storm_at_dispatch": lambda o: o["stats"]["oom_recoveries"] == 3
        and o["stats"]["oom_quarantined"] == 3 and o["cuts"] >= 1
        and o["statuses"][-1] == "completed",
    "oom_at_harvest": lambda o: o["statuses"] == [
        "oom_quarantined", "oom_quarantined", "completed"]
        and o["stats"]["oom_recoveries"] == 1
        and all(len(p) >= 1 for p in o["partial"]),
    "hung_sync": lambda o: o["saw_degraded"] and o["healthz"]["ok"]
        and not o["healthz"]["degraded"] and o["trips"] == 1
        and o["telemetry"]["degraded"] == 0,
    "drain_timeout": lambda o: o["caught"][:3] == (True, True, 1)
        and o["caught"][3] >= 1 and o["statuses"][0] == "completed",
    "graceful_drain": lambda o: o["statuses"] == [
        "completed", "shed", "shed", "shed", "shed"]
        and o["summary_shed"] == 3 and o["healthz"]["draining"],
    "never_fitting": lambda o: o["statuses"] == ["shed", "shed"]
        and o["healthz"]["running"] == o["healthz"]["queued"] == 0,
    "reset_stats": lambda o: o["shed_before"] == 2
        and o["stats"]["shed"] == o["stats"]["completed"] == 0
        and o["telemetry"]["shed_total"] == 0
        and o["telemetry"]["deadline_exceeded_total"] == 0
        and o["telemetry"]["oom_recoveries_total"] == 0,
    "acceptance_storm": lambda o: o["storm"]["stats"]["shed"] == 12
        and o["storm"]["stats"]["oom_recoveries"] == 3 and o["saw_degraded"]
        and o["storm"]["healthz"]["ok"] and o["floor"] == 1
        and o["extras"]["statuses"] == ["completed", "completed"]
        and o["watermark"] == 2,
}


@pytest.mark.parametrize("name", sorted(SLOT_SCENARIOS))
def test_slot_scenario_equals_reference(sides, name):
    ref_side, port_side = sides
    want = SLOT_SCENARIOS[name](ref_side)
    got = SLOT_SCENARIOS[name](port_side)
    assert EXPECT[name](got), got
    assert got == want


def test_deadline_mid_decode_keeps_partial_output(sides):
    """Time-dependent: compare what the reference's test asserts."""
    for side in sides:
        eng = slot(side, n_slots=1, chunk=2)
        r = req(side, 5, max_new=40, deadline_s=30.0)
        eng.submit(r)
        eng.step()
        assert not r.done and len(r.output) >= 1
        r._deadline = time.monotonic() - 1.0
        eng.step()
        assert r.done and r.status == side.overload.STATUS_DEADLINE_EXCEEDED
        assert len(r.output) >= 1
        assert not eng.running and not eng.queue
        assert eng.stats["deadline_exceeded"] == 1
        assert eng.stats["requests_done"] == 1


def test_sample_n_surfaces_partial_results(sides):
    """``sample_n`` cut by its iteration bound returns what it has (the
    draws differ between the packages' generators: compare shapes)."""
    seen = []
    for side in sides:
        eng = slot(side, n_slots=2)
        reqs = eng.sample_n([3, 1, 4, 1], n=2, max_new=24, temperature=0.7,
                            max_iters=2)
        assert len(reqs) == 2
        assert any(not r.done for r in reqs)
        assert all(len(r.output) >= 1 for r in reqs)
        seen.append(([r.done for r in reqs], [len(r.output) for r in reqs],
                     len(eng.prefixes)))
        eng.run()
        assert not eng.running and not eng.queue
    assert seen[1] == seen[0]


def test_trace_keep_decisions_equal_reference(sides):
    """Every request gets a trace at submit; sheds and quarantines are
    always kept, the 1st, 17th ... sampled. (The SLO is opened wide so
    that no completed request is kept for a violation a loaded host
    could cause.)"""
    from tpushare import tracing as jtracing
    from tpushare.workloads.slo import SLOPolicy as JSLOPolicy
    from tpushare_torch import tracing
    from tpushare_torch.workloads.slo import SLOPolicy
    kept = []
    for side, ring, policy in zip(sides,
                                  (jtracing.RECORDER, tracing.RECORDER),
                                  (JSLOPolicy, SLOPolicy)):
        ring.clear()
        plan = side.Plan()
        plan.add("admit", side.Fault(times=1, kind="oom"))
        eng = slot(side, n_slots=1, queue_limit=2, faults=plan)
        eng.telemetry.slo = policy(ttft_s=1e9, decode_per_token_s=1e9)
        reqs = [req(side, 4 + (i % 3), max_new=3) for i in range(5)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        kept.append(([r._trace.sampled for r in reqs],
                     sorted(s.attrs["status"] for tid in ring.trace_ids()
                            for s in ring.trace(tid) if s.name == "request")))
    assert kept[1] == kept[0]
    assert kept[0][1].count("shed") == 3


# ---------------------------------------------------------------------------
# the paged storm, both codecs
# ---------------------------------------------------------------------------

def paged_storm(side, kv_codec):
    plan = side.Plan()
    plan.add("dispatch", side.Fault(times=3, kind="oom"))
    plan.add("sync", side.Fault(times=1, kind="hang", delay_s=0.6))
    ctl = side.Admission(3, md_cooldown_s=0.0, ai_step=0.5)
    eng = paged(side, queue_limit=4, faults=plan, admission=ctl,
                sync_timeout_s=0.1, kv_codec=kv_codec)
    reqs = [side.Request(prompt=prompt(4 + (i % 5), 120 + i),
                         max_new=6 + (i % 3)) for i in range(16)]

    def body():
        for r in reqs:
            eng.submit(r)
        eng.run()
    saw = run_polling_health(eng, body)
    assert_exact_accounting(side, eng, reqs)
    storm = outcome(side, eng, reqs)
    leaks = (eng.alloc.pages_in_use(), eng.alloc.leaked())
    floor = ctl.floor_reached
    extras = [side.Request(prompt=prompt(5, 140), max_new=6),
              side.Request(prompt=prompt(6, 141), max_new=6)]
    for r in extras:
        eng.submit(r)
    eng.run()
    return {"storm": storm, "saw_degraded": saw, "floor": floor,
            "leaks": leaks, "extras": outcome(side, eng, extras),
            "watermark": ctl.watermark(),
            "leaks_after": (eng.alloc.pages_in_use(), eng.alloc.leaked())}


@pytest.mark.parametrize("kv_codec", ["bf16", "int8"])
def test_paged_storm_equals_reference(sides, kv_codec):
    ref_side, port_side = sides
    want = paged_storm(ref_side, kv_codec)
    got = paged_storm(port_side, kv_codec)
    assert got["storm"]["stats"]["shed"] == 12
    assert got["storm"]["stats"]["oom_recoveries"] == 3
    assert got["saw_degraded"] and got["storm"]["healthz"]["ok"]
    assert got["floor"] == 1 and got["watermark"] == 3
    assert got["leaks"] == got["leaks_after"] == (0, 0)
    assert got["extras"]["statuses"] == ["completed", "completed"]
    assert got == want


@pytest.mark.parametrize("kv_codec", ["bf16", "int8"])
def test_paged_oom_at_admit_and_drain_equal_reference(sides, kv_codec):
    outs = []
    for side in sides:
        plan = side.Plan()
        plan.add("admit", side.Fault(times=1, kind="oom"))
        eng = paged(side, faults=plan, kv_codec=kv_codec)
        reqs = [side.Request(prompt=prompt(5, 150 + i), max_new=6)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        first = outcome(side, eng, reqs)
        eng2 = paged(side, n_lanes=1, n_pages=9, kv_codec=kv_codec)
        reqs2 = [side.Request(prompt=prompt(5, 160 + i), max_new=8)
                 for i in range(3)]
        for r in reqs2:
            eng2.submit(r)
        eng2.step()
        stats = eng2.drain()
        late = side.Request(prompt=prompt(5, 170), max_new=4)
        eng2.submit(late)
        outs.append((first, outcome(side, eng2, reqs2 + [late]),
                     stats["completed"], stats["shed"],
                     eng.alloc.leaked(), eng2.alloc.pages_in_use()))
    assert outs[1][0]["statuses"] == ["oom_quarantined", "completed",
                                      "completed"]
    assert outs[1][1]["statuses"] == ["completed", "shed", "shed", "shed"]
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# the port's own readings
# ---------------------------------------------------------------------------

def greedy_transcripts(port, make, prompts):
    eng = make(port)
    reqs = [port.Request(prompt=p, max_new=12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_real_oom_inside_a_chunk_quarantines_its_snapshot(sides, engine,
                                                          monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` raised by layer 1 of the third
    step of a decode chunk: the chunk has already advanced the lanes'
    device lengths (and written their cache rows) past the host mirror,
    so every request in the chunk is quarantined with its consistent
    partial output — the reference's harvest-OOM rule — no page leaks,
    and the next request decodes exactly as on a clean engine."""
    _, port = sides
    make = slot if engine == "slot" else paged
    prompts = [prompt(5, 200), prompt(7, 201), prompt(6, 202)]
    clean = greedy_transcripts(port, make, prompts)

    real_model_layer = serving.model_layer
    calls = {"n": 0, "armed": False, "seen": None}
    eng = make(port)

    def flaky_model_layer(*args, **kw):
        if calls["armed"]:
            calls["n"] += 1
            if calls["n"] == 2 * CFG.n_layers + 2:     # step 3, layer 1
                state = eng.slots if engine == "slot" else eng.state
                calls["seen"] = (state["lengths"].tolist(),
                                 dict(eng._lengths))
                calls["armed"] = False
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real_model_layer(*args, **kw)
    monkeypatch.setattr(serving, "model_layer", flaky_model_layer)

    reqs = [port.Request(prompt=p, max_new=12) for p in prompts[:2]]
    for r in reqs:
        eng.submit(r)
    eng.step()                       # admission + one clean chunk
    assert all(not r.done for r in reqs)
    calls["armed"] = True
    eng.step()
    lanes, mirror = calls["seen"]
    for lane, host_len in mirror.items():
        assert lanes[lane] == host_len + 2   # device ahead of the host
    for r, want in zip(reqs, clean[:2]):
        assert r.status == overload.STATUS_OOM_QUARANTINED
        assert r.output == want[:len(r.output)] and len(r.output) == 5
    assert eng.stats["oom_recoveries"] == 1 and not eng.running
    assert not eng._lengths
    if engine == "paged":
        assert eng.alloc.pages_in_use() == 0 and eng.alloc.leaked() == 0
        assert not eng.state["tables"].any()
    late = port.Request(prompt=prompts[2], max_new=12)
    eng.submit(late)
    eng.run()
    assert late.status == overload.STATUS_COMPLETED
    assert late.output == clean[2]


def test_admission_is_sized_by_the_paged_engines_lanes(monkeypatch):
    """``infer --mode serve --paged --slots 2`` builds 4 lanes. The
    reference's controller is sized by --slots (``infer.py:229``), so its
    paged serve admits at most 2 at once; the port's is sized by the
    lanes (as the reference's own fleet branch, ``infer.py:396``) and
    fills all 4 — the int8 pool holds enough pages for both readings."""
    from tpushare.workloads import infer as jinfer
    from tpushare_torch.workloads import infer

    built = []

    class Recording(jserving.PagedServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(jserving, "PagedServingEngine", Recording)
    monkeypatch.setenv(jconsts.ENV_DISABLE_ISOLATION, "true")
    monkeypatch.delenv(consts.ENV_HBM_LIMIT_MIB, raising=False)
    flags = ["--mode", "serve", "--paged", "--kv-codec", "int8", "--slots",
             "2", "--requests", "8", "--seq", "32", "--steps", "8",
             "--hbm-limit-mib", "2000"]
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert jinfer.main(flags) == 0
    finally:
        signal.signal(signal.SIGTERM, prev)
    (ref_eng,) = built
    assert ref_eng.n_lanes == 4 and ref_eng.admission.n_slots == 2
    assert ref_eng.stats["peak_running"] <= 2

    res = infer.run(infer.parse_args(flags + ["--device", "cpu"]))
    eng = res["engine"]
    assert signal.getsignal(signal.SIGTERM) == prev
    assert eng.n_lanes == 4 and eng.admission.n_slots == 4
    assert eng.stats["peak_running"] == 4
    assert all(r.status == "completed" for r in res["requests"])
    snap = res["telemetry"]
    assert snap[consts.TELEMETRY_ADMISSION_WATERMARK] == 4
    assert snap[consts.TELEMETRY_KV_CODEC] == "int8"
    # the weights are the controller's base charge, the limit its cap
    assert eng.admission.cap_mib == 2000.0
    assert 0 < eng.admission.base_mib < 2000.0


def test_infer_queue_limit_and_deadline_flags():
    from tpushare_torch.workloads import infer
    res = infer.run(infer.parse_args(
        ["--device", "cpu", "--mode", "serve", "--requests", "6", "--seq",
         "40", "--slots", "2", "--steps", "8", "--hbm-limit-mib", "2000",
         "--queue-limit", "3", "--deadline-s", "30"]))
    eng, reqs = res["engine"], res["requests"]
    assert eng.queue_limit == 3 and eng.default_deadline_s == 30
    assert [r.status for r in reqs].count("shed") == 3
    assert res["telemetry"][consts.TELEMETRY_SHED] == 3
    res = infer.run(infer.parse_args(
        ["--device", "cpu", "--mode", "serve", "--requests", "2", "--seq",
         "40", "--slots", "2", "--steps", "8", "--hbm-limit-mib", "2000",
         "--no-admission"]))
    assert res["engine"].admission is None
    assert res["telemetry"][consts.TELEMETRY_ADMISSION_WATERMARK] == -1.0
