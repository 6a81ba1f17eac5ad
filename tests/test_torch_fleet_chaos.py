"""The port's fleet fault tolerance, held against the reference on the
CPU (the reference's ``tests/test_fleet_chaos.py``, every scenario run
on both packages over the same ``bridge``-carried f32 weights and the
same fault plans): member-scoped fault routes, the dispatch-fault,
probe-timeout and OOM-storm breakers, half-open recovery, salvage by
page migration mid-decode on both codecs, an ``install`` fault that
aborts one salvage and lands the request on the next member, hedged
re-admission within its budget and the typed ``member_failed`` shed
past it, respawn through the factory with the prefix registered again
and the provider slot taken back, scale-in, and the acceptance storm
(a kill, a hang and an install fault at once). Statuses, tokens,
``router.stats``, breaker verdicts, handoff counters and allocator
snapshots must be equal; completed requests equal the dense offline
decode (or, on int8 pools, the unmigrated int8 engine).

A sampled request salvaged off a failed member continues its stream on
the port (migrated against unmigrated, same seed): the reference keys
its sampling by JAX PRNG keys, the port by ``torch.Generator`` state,
so sampled tokens are compared within the port only.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import torch_fleet_sides as fs  # noqa: E402

KNOBS = fs.KNOBS


@pytest.fixture(autouse=True)
def _one_thread_and_clean_provider():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    fs.clear_providers()


def both(scenario, *args):
    ref, port = (scenario(side, *args) for side in fs.SIDES)
    assert ref == port
    return port


def exact(reqs) -> bool:
    return all(q.output == fs.PORT.offline(q.prompt, q.max_new)
               for q in reqs if q.status == "completed")


def terminal(side, reqs) -> bool:
    return all(q.done and q.status in side.overload.TERMINAL_STATUSES
               for q in reqs)


def sc_fault_routes(side):
    plan = side.Plan()
    for route in ("step", "healthz", "install"):
        plan.add(route, side.Fault(times=1))
    with pytest.raises(ValueError, match="unknown fault route"):
        plan.add("teleport", side.Fault())
    plan.clear()
    plan.add("step", side.Fault(times=1, kind="fatal"))
    with pytest.raises(side.FakeMemberDeath) as e:
        plan.fire("step")
    return {"oom_like": side.overload.is_resource_exhausted(e.value),
            "triggered": plan.triggered}


def test_member_scoped_fault_routes():
    assert both(sc_fault_routes)["oom_like"] is False


def sc_dispatch_faults(side):
    plan = side.Plan()
    e0, e1 = fs.paged(side, faults=plan), fs.paged(side)
    r = side.FleetRouter([e0, e1], breaker_dispatch_faults=2, **KNOBS)
    reqs = [fs.req(side, 10 + i, 5, 24) for i in range(6)]
    for q in reqs:
        r.submit(q)
    for _ in range(2):
        r.step()
    live = bool(e0.running)
    plan.add("step", side.Fault(times=-1, kind="fatal"))
    r.run()
    fs.assert_no_leaks(e0, e1)
    return {"live": live, "terminal": terminal(side, reqs),
            "statuses": fs.statuses(reqs), "tokens": fs.outputs(reqs),
            "exact": exact(reqs), "ok": r.healthz()["ok"],
            "router": fs.router_view(r)}


def test_dispatch_faults_trip_breaker_and_evacuate():
    got = both(sc_dispatch_faults)
    assert got["live"] and got["terminal"] and got["exact"]
    m = got["router"]["members"][0]
    assert (m["state"], m["reason"], m["fatal"]) == (
        "open", "dispatch_faults", True)
    assert not got["ok"] and got["router"]["stats"]["breaker_opens"] == 1
    assert any(s == ("completed", True) for s in got["statuses"])


def sc_probe_and_storm(side):
    plan = side.Plan()
    e0, e1 = fs.paged(side, faults=plan), fs.paged(side)
    r = side.FleetRouter([e0, e1], **KNOBS)
    plan.add("healthz", side.Fault(times=1, kind="hang", delay_s=1.0))
    states = r.probe()
    reason = r.healthz()["members"][0]["reason"]
    d = r.submit(fs.req(side, 20, 5, 4))
    r.run()
    e2, e3 = fs.paged(side), fs.paged(side)
    r2 = side.FleetRouter([e2, e3], **KNOBS)
    e2.stats["oom_recoveries"] = side.consts.FLEET_BREAKER_OOM_STORM
    states2 = r2.probe()
    fs.assert_no_leaks(e0, e1, e2, e3)
    return {"states": states, "reason": reason, "engine": d.engine,
            "states2": states2,
            "reason2": r2.healthz()["members"][0]["reason"]}


def test_probe_timeout_and_oom_storm_open_breaker():
    got = both(sc_probe_and_storm)
    assert got["states"][0] == "open" and got["reason"] == "probe_timeout"
    assert got["engine"] == 1
    assert got["states2"][0] == "open" and got["reason2"] == "oom_storm"


def sc_half_open(side):
    plan = side.Plan()
    r = side.FleetRouter([fs.paged(side, faults=plan), fs.paged(side)],
                         **KNOBS)
    plan.add("healthz", side.Fault(times=1, kind="hang", delay_s=1.0))
    first = r.probe()[0]
    time.sleep(0.06)
    second = r.probe()[0]
    q = fs.req(side, 30, 5, 4)
    r.submit(q)
    r.run()
    fs.assert_no_leaks(*r.engines)
    return {"states": (first, second), "ok": r.healthz()["ok"],
            "status": q.status, "router": fs.router_view(r)}


def test_half_open_recovery_closes_breaker():
    got = both(sc_half_open)
    assert got["states"] == ("open", "closed") and got["ok"]
    assert got["router"]["stats"]["breaker_recoveries"] == 1


# ---------------------------------------------------------------------------
# transactional in-flight migration
# ---------------------------------------------------------------------------

def sc_salvage(side, codec):
    plan = side.Plan()
    e0 = fs.paged(side, kv_codec=codec, faults=plan, n_lanes=6)
    e1 = fs.paged(side, kv_codec=codec, n_lanes=6)
    r = side.FleetRouter([e0, e1], breaker_dispatch_faults=1, **KNOBS)
    reqs = [fs.req(side, 40 + i, 5 + i, 24) for i in range(6)]
    for q in reqs:
        r.submit(q)
    for _ in range(3):
        r.step()
    victims = sum(1 for q in e0.running.values() if q.output)
    plan.add("step", side.Fault(times=-1, kind="fatal"))
    r.run()
    fs.assert_no_leaks(e0, e1)
    oracle = []
    for q in reqs:
        e = fs.paged(side, kv_codec=codec)
        oq = side.Request(prompt=list(q.prompt), max_new=q.max_new)
        e.submit(oq)
        e.run()
        oracle.append(oq.output)
    return {"victims": victims, "statuses": fs.statuses(reqs),
            "tokens": fs.outputs(reqs), "oracle": oracle,
            "terminal": terminal(side, reqs), "router": fs.router_view(r)}


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_salvage_mid_decode_byte_exact_both_codecs(codec):
    got = both(sc_salvage, codec)
    stats = got["router"]["stats"]
    assert got["victims"] > 0 and stats["migrations"] >= got["victims"]
    assert got["router"]["handoffs"][1][0] == stats["migrations"]
    for (status, _), toks, want in zip(got["statuses"], got["tokens"],
                                       got["oracle"]):
        if status == "completed":
            assert toks == want
    assert got["terminal"]


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_salvage_continues_generator_stream(codec):
    """Port only: a sampled request salvaged mid-decode (operator open)
    continues its generator stream on an engine of another seed."""
    side = fs.PORT
    stay_eng = fs.paged(side, seed=7, kv_codec=codec)
    stay = fs.req(side, 50, 9, 16, temperature=0.8)
    stay_eng.submit(stay)
    stay_eng.run()
    e0 = fs.paged(side, seed=7, kv_codec=codec)
    e1 = fs.paged(side, seed=99, kv_codec=codec)
    r = side.FleetRouter([e0, e1], **KNOBS)
    moved = fs.req(side, 50, 9, 16, temperature=0.8)
    r.submit(moved)
    for _ in range(2):
        r.step()
    assert moved in e0.running.values() and moved.output
    r.open_member(0)
    assert r.stats["migrations"] == 1
    r.run()
    assert moved.status == "completed"
    assert moved.output == stay.output
    assert moved.logprobs == pytest.approx(stay.logprobs)
    fs.assert_no_leaks(e0, e1)


def sc_install_fault_salvage(side):
    plan_dst = side.Plan()
    e0, e1, e2 = fs.paged(side), fs.paged(side, faults=plan_dst), \
        fs.paged(side)
    r = side.FleetRouter([e0, e1, e2], **KNOBS)
    q = fs.req(side, 60, 9, 24)
    r.submit(q)
    for _ in range(2):
        r.step()
    on_e0 = q in e0.running.values() and bool(q.output)
    plan_dst.add("install", side.Fault(times=1, kind="oom"))
    r.open_member(0)
    aborts = e1.alloc.snapshot()["install_aborts"]
    in_use = e1.alloc.pages_in_use()
    r.run()
    fs.assert_no_leaks(e0, e1, e2)
    return {"on_e0": on_e0, "aborts": aborts, "in_use": in_use,
            "status": q.status, "tokens": q.output, "exact": exact([q]),
            "router": fs.router_view(r)}


def test_install_fault_mid_salvage_aborts_and_retries_next_member():
    got = both(sc_install_fault_salvage)
    assert got["on_e0"] and got["aborts"] == 1 and got["in_use"] == 0
    assert got["router"]["stats"]["migrations"] == 1
    assert got["router"]["handoffs"][2][0] == 1
    assert got["status"] == "completed" and got["exact"]


# ---------------------------------------------------------------------------
# hedged prefill + typed shed accounting
# ---------------------------------------------------------------------------

def sc_hedge(side, budget):
    e0, e1 = fs.paged(side), fs.paged(side)
    r = side.FleetRouter([e0, e1], hedge_budget=budget, **KNOBS)
    reqs = [fs.req(side, (70 if budget else 80) + i, 5, 4)
            for i in range(4)]
    for q in reqs:
        r.submit(q)
    on_e0 = [q for q in reqs if q in e0.queue]
    r.open_member(0)
    after = [(q.done, q.status, q in e1.queue) for q in on_e0]
    snap = fs.snap_view(r.snapshot())
    r.run()
    fs.assert_no_leaks(e0, e1)
    return {"n_on_e0": len(on_e0), "after": after, "snap": snap,
            "statuses": fs.statuses(reqs), "router": fs.router_view(r)}


@pytest.mark.parametrize("budget", [2, 0])
def test_hedged_prefill_within_budget_and_typed_shed_past_it(budget):
    got = both(sc_hedge, budget)
    c = fs.PORT.consts
    n = got["n_on_e0"]
    assert n > 0
    if budget:
        assert all(a == (False, None, True) for a in got["after"])
        assert got["router"]["stats"]["hedged"] == n
        assert all(s == ("completed", True) for s in got["statuses"])
    else:
        assert all(a[:2] == (True, "shed") for a in got["after"])
        assert got["router"]["stats"]["reasons"]["member_failed"] == n
        assert got["snap"][c.TELEMETRY_FLEET_SHED_MEMBER_FAILED] == n
        assert got["snap"][c.TELEMETRY_FLEET_MEMBERS_OPEN] == 1


# ---------------------------------------------------------------------------
# elastic self-healing
# ---------------------------------------------------------------------------

def sc_respawn(side):
    plan = side.Plan()
    e0, e1 = fs.paged(side, faults=plan), fs.paged(side)
    built = []

    def factory(i):
        built.append(fs.paged(side))
        return built[-1]

    r = side.FleetRouter([e0, e1], factory=factory,
                         breaker_dispatch_faults=1, **KNOBS)
    sysp = fs.prompt(90, 13)
    r.register_prefix("sys", sysp, engine=0)
    q = side.Request(prompt=fs.prompt(91, 5), max_new=6, prefix="sys")
    r.submit(q)
    plan.add("step", side.Fault(times=-1, kind="fatal"))
    r.run()
    replaced = len(built) == 1 and r.engines[0] is built[0]
    c = side.consts
    provider = side.telemetry.current_snapshot()
    oracle = fs.paged(side)
    oracle.register_prefix("sys", sysp)
    oq = side.Request(prompt=list(q.prompt), max_new=6, prefix="sys")
    oracle.submit(oq)
    oracle.run()
    extra = fs.req(side, 92, 5, 4)
    r.submit(extra)
    r.run()
    view = fs.router_view(r)
    r.drop_prefix("sys")
    oracle.drop_prefix("sys")
    fs.assert_no_leaks(e0, e1, built[0], oracle)
    return {"replaced": replaced, "ok": r.healthz()["ok"],
            "respawns": r.snapshot()[c.TELEMETRY_FLEET_RESPAWNS],
            "provider": (provider[c.TELEMETRY_FLEET_ENGINES],
                         provider[c.TELEMETRY_FLEET_RESPAWNS]),
            "status": q.status, "tokens": q.output, "oracle": oq.output,
            "extra": extra.status, "router": view}


def test_fatal_failure_respawns_replacement_and_reregisters_prefix():
    got = both(sc_respawn)
    assert got["replaced"] and got["ok"] and got["respawns"] == 1
    assert got["provider"] == (2, 1)
    assert got["router"]["states"] == ["closed", "closed"]
    assert got["status"] == got["extra"] == "completed"
    assert got["tokens"] == got["oracle"]


def sc_scale_in(side):
    e0, e1 = fs.paged(side), fs.paged(side)
    r = side.FleetRouter([e0, e1], **KNOBS)
    with pytest.raises(ValueError, match="no factory was given") as e:
        r.respawn_member(0)
    reqs = [fs.req(side, 95 + i, 5, 4) for i in range(4)]
    for q in reqs:
        r.submit(q)
    queued = len(e0.queue)
    moved = r.scale_in(0)
    all_on_1 = all(q in e1.queue for q in reqs)
    d = r.submit(fs.req(side, 99, 5, 4))
    r.run()
    fs.assert_no_leaks(e0, e1)
    return {"err": str(e.value), "moved": (moved, queued),
            "all_on_1": all_on_1, "late": d.engine,
            "statuses": fs.statuses(reqs), "router": fs.router_view(r)}


def test_respawn_without_factory_raises_typed_and_scale_in_retires():
    got = both(sc_scale_in)
    assert got["moved"][0] == got["moved"][1] > 0
    assert got["all_on_1"] and got["late"] == 1
    assert got["router"]["members"][0]["retired"]
    assert got["router"]["stats"]["scale_ins"] == 1


# ---------------------------------------------------------------------------
# the acceptance storm
# ---------------------------------------------------------------------------

def sc_acceptance(side):
    plans = [side.Plan() for _ in range(3)]
    e0, e1, e2 = (fs.paged(side, faults=p, n_lanes=6) for p in plans)
    built = []

    def factory(i):
        built.append(fs.paged(side, n_lanes=6))
        return built[-1]

    r = side.FleetRouter([e0, e1, e2], factory=factory,
                         breaker_dispatch_faults=2, **KNOBS)
    reqs = [fs.req(side, 100 + i, 4 + (i % 5), 16 + (i % 5))
            for i in range(12)]
    for q in reqs:
        r.submit(q)
    for _ in range(2):
        r.step()
    live = bool(e0.running and e1.running)
    plans[0].add("step", side.Fault(times=-1, kind="fatal"))
    plans[1].add("healthz", side.Fault(times=1, kind="hang", delay_s=1.0))
    plans[2].add("install", side.Fault(times=1, kind="oom"))
    states = r.probe()
    r.run()
    aborts = e2.alloc.snapshot()["install_aborts"]
    time.sleep(0.06)
    recovered = r.probe()[1]
    by = {s: sum(1 for q in reqs if q.status == s)
          for s in side.overload.TERMINAL_STATUSES}
    ledger = {s: 0 for s in side.overload.TERMINAL_STATUSES}
    for e in (e0, e1, e2, *built):
        for s in side.overload.TERMINAL_STATUSES:
            ledger[s] += e.stats[s]
    ledger["shed"] += r.stats["shed"]
    extra = fs.req(side, 130, 5, 5)
    r.submit(extra)
    r.run()
    fs.assert_no_leaks(e0, e1, e2, *built)
    c = side.consts
    snap = r.snapshot()
    return {"live": live, "states": states, "aborts": aborts,
            "recovered": recovered, "by": by, "ledger": ledger,
            "built": len(built), "statuses": fs.statuses(reqs),
            "tokens": fs.outputs(reqs), "exact": exact(reqs),
            "terminal": terminal(side, reqs), "extra": extra.status,
            "open": snap[c.TELEMETRY_FLEET_MEMBERS_OPEN],
            "migrations": (snap[c.TELEMETRY_FLEET_MIGRATIONS],
                           r.stats["migrations"]),
            "router": fs.router_view(r)}


def test_acceptance_storm_kill_hang_and_install_fault():
    got = both(sc_acceptance)
    stats = got["router"]["stats"]
    assert got["live"] and got["states"][1] == "open"
    assert stats["breaker_opens"] >= 2 and stats["respawns"] == 1
    assert got["built"] == 1 and got["aborts"] >= 1
    assert got["recovered"] == "closed" and stats["breaker_recoveries"] >= 1
    assert got["ledger"] == got["by"] and sum(got["by"].values()) == 12
    assert got["terminal"] and got["exact"] and got["extra"] == "completed"
    assert got["open"] == 0 and got["migrations"][0] == got["migrations"][1]
