"""The port's ``FleetRouter`` and ``fleet_snapshot``, held against the
reference on the CPU (the reference's ``tests/test_fleet.py``, every
scenario run on both packages over the same ``bridge``-carried f32
weights): construction guards word for word, depth / affinity /
replication / pressure / fleet-full routing with the same decisions and
reason maps, the drain re-route, the fleet-scope OOM storm with its
exact ledger, the whole-fleet drain, the merged snapshot (counters,
fleet keys, member ids, the process provider) and the aggregated
healthz. Tokens, statuses, ``router.stats``, member states, handoff
counters, allocator snapshots and the merged snapshot's counters must be
equal; completed requests must also equal the dense offline decode.
``infer --fleet / --disaggregate / --listen / --join`` against the
reference payload: the same flag combinations exit 2, and a
disaggregated fleet run sizes its members and reports its handoffs as
the reference's does. Then the port's own: the five fleet metric series
advance as the reference's do, and nothing of the port or
``chip_smoke.py`` imports ``jax`` or ``tpushare``.
"""

import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import torch_fleet_sides as fs  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


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


# ---------------------------------------------------------------------------
# routing policy
# ---------------------------------------------------------------------------

def sc_guards(side):
    msgs = []
    cases = [
        (lambda: side.FleetRouter([]), "at least one engine"),
        (lambda: side.FleetRouter([fs.paged(side, kv_codec="bf16"),
                                   fs.paged(side, kv_codec="int8")]),
         "handoff layout mismatch"),
        (lambda: side.FleetRouter([fs.paged(side, max_seq=96),
                                   fs.paged(side, max_seq=64)]),
         "share max_seq"),
        (lambda: side.FleetRouter([fs.paged(side)], disaggregate=True),
         "n_prefill"),
        (lambda: side.FleetRouter([fs.paged(side)], replicate_depth=0),
         "replicate_depth")]
    for build, match in cases:
        with pytest.raises(ValueError, match=match) as e:
            build()
        msgs.append(str(e.value))
    return msgs


def test_construction_guards():
    both(sc_guards)


def sc_depth(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)])
    reqs = [fs.req(side, i, 5, 4) for i in range(4)]
    decisions = [(d.engine, d.reason) for d in map(r.submit, reqs)]
    r.run()
    fs.assert_no_leaks(*r.engines)
    return {"decisions": decisions, "tokens": fs.outputs(reqs),
            "router": fs.router_view(r)}


def test_depth_routing_balances_and_counts_reasons():
    got = both(sc_depth)
    assert {e for e, _ in got["decisions"]} == {0, 1}
    assert got["router"]["stats"]["reasons"] == {"depth_spill": 4}


def sc_affinity_hit(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)])
    home = r.register_prefix("sys", fs.prompt(1, 13))
    d = r.submit(side.Request(prompt=fs.prompt(2, 5), max_new=4,
                              prefix="sys"))
    with pytest.raises(ValueError, match="unknown prefix") as e:
        r.submit(side.Request(prompt=[1], max_new=2, prefix="nope"))
    r.run()
    view = fs.router_view(r)
    r.drop_prefix("sys")
    fs.assert_no_leaks(*r.engines)
    return {"home": home, "decision": (d.engine, d.reason),
            "err": str(e.value), "router": view}


def test_affinity_hit_routes_to_pinned_engine():
    got = both(sc_affinity_hit)
    assert got["decision"] == (got["home"], "affinity_hit")
    assert got["router"]["stats"]["affinity_hits"] == 1


def sc_replicate(side, affinity):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)],
                         replicate_depth=1, affinity=affinity)
    home = r.register_prefix("sys", fs.prompt(3, 13))
    qs = [side.Request(prompt=fs.prompt(4, 5), max_new=4, prefix="sys")
          for _ in range(4)]
    decisions = [(d.engine, d.reason) for d in map(r.submit, qs)]
    pinned = ["sys" in e.prefixes for e in r.engines]
    r.run()
    view = fs.router_view(r)
    r.drop_prefix("sys")
    fs.assert_no_leaks(*r.engines)
    return {"home": home, "decisions": decisions, "pinned": pinned,
            "statuses": fs.statuses(qs), "tokens": fs.outputs(qs),
            "router": view}


@pytest.mark.parametrize("affinity", [True, False])
def test_hot_prefix_replication_and_affinity_off(affinity):
    got = both(sc_replicate, affinity)
    stats = got["router"]["stats"]
    if affinity:
        assert got["decisions"][0][1] == "affinity_hit"
        assert "affinity_miss" in [r for _, r in got["decisions"][1:]]
        assert stats["replications"] == 1 and stats["handoffs"] == 1
        assert got["pinned"] == [True, True]
    else:
        assert all(d == (got["home"], "depth_spill")
                   for d in got["decisions"])
        assert stats["replications"] == 0 and stats["affinity_hits"] == 0
    assert len({tuple(t) for t in got["tokens"]}) == 1


def sc_pressure(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)])
    r.engines[0].telemetry.set_degraded(True)
    d = r.submit(fs.req(side, 7, 5, 4))
    r.engines[0].telemetry.set_degraded(False)
    r.run()
    fs.assert_no_leaks(*r.engines)
    return {"decision": (d.engine, d.reason), "router": fs.router_view(r)}


def test_pressure_spills_away_from_degraded_engine():
    assert both(sc_pressure)["decision"] == (1, "pressure_spill")


def sc_fleet_full(side):
    r = side.FleetRouter([fs.paged(side, queue_limit=1),
                          fs.paged(side, queue_limit=1)])
    keep = [fs.req(side, 8 + i, 5, 4) for i in range(2)]
    for q in keep:
        r.submit(q)
    extra = fs.req(side, 19, 5, 4)
    d = r.submit(extra)
    r.run()
    fs.assert_no_leaks(*r.engines)
    return {"decision": (d.engine, d.reason),
            "extra": (extra.done, extra.status),
            "statuses": fs.statuses(keep), "tokens": fs.outputs(keep),
            "router": fs.router_view(r)}


def test_shed_on_fleet_full_rides_overload_statuses():
    got = both(sc_fleet_full)
    assert got["decision"] == (None, "fleet_full")
    assert got["extra"] == (True, "shed")
    assert got["router"]["stats"]["shed"] == 1


# ---------------------------------------------------------------------------
# drain re-route + the fleet chaos storm
# ---------------------------------------------------------------------------

def sc_drain_engine(side):
    r = side.FleetRouter([fs.paged(side, n_lanes=1),
                          fs.paged(side, n_lanes=1)])
    reqs = [fs.req(side, 30 + i, 5, 6) for i in range(6)]
    for q in reqs:
        r.submit(q)
    r.step()
    queued = list(r.engines[0].queue)
    moved = r.drain_engine(0)
    rerouted = [(not q.done, q in r.engines[1].queue) for q in queued]
    r.run()
    fs.assert_no_leaks(*r.engines)
    return {"moved": (moved, len(queued)), "rerouted": rerouted,
            "statuses": fs.statuses(reqs), "tokens": fs.outputs(reqs),
            "router": fs.router_view(r), "exact": exact(reqs)}


def test_drain_engine_reroutes_queued_requests():
    got = both(sc_drain_engine)
    assert got["moved"][0] == got["moved"][1] > 0
    assert all(a and b for a, b in got["rerouted"])
    assert got["exact"]


def sc_storm(side):
    plan = side.Plan()
    plan.add("dispatch", side.Fault(times=2, kind="oom"))
    e0, e1 = fs.paged(side, n_lanes=2, faults=plan), fs.paged(side, n_lanes=2)
    r = side.FleetRouter([e0, e1])
    reqs = [fs.req(side, 40 + i, 4 + (i % 5), 6 + (i % 3))
            for i in range(12)]
    for q in reqs:
        r.submit(q)
    for _ in range(3):
        r.step()
    r.drain_engine(0)
    r.run()
    by = {s: sum(1 for q in reqs if q.status == s)
          for s in side.overload.TERMINAL_STATUSES}
    ledger = {s: 0 for s in side.overload.TERMINAL_STATUSES}
    for e in (e0, e1):
        for s in side.overload.TERMINAL_STATUSES:
            ledger[s] += e.stats[s]
    ledger["shed"] += r.stats["shed"]
    fs.assert_no_leaks(e0, e1)
    extra = fs.req(side, 60, 5, 5)
    r.submit(extra)
    r.run()
    fs.assert_no_leaks(e0, e1)
    return {"by": by, "ledger": ledger, "statuses": fs.statuses(reqs),
            "tokens": fs.outputs(reqs), "exact": exact(reqs),
            "oom_recoveries": e0.stats["oom_recoveries"],
            "extra": extra.status, "router": fs.router_view(r)}


def test_fleet_chaos_storm_exact_accounting_zero_leaks():
    got = both(sc_storm)
    assert got["ledger"] == got["by"] and sum(got["by"].values()) == 12
    assert got["by"]["oom_quarantined"] == 2
    assert got["oom_recoveries"] == 2 and got["exact"]
    assert got["extra"] == "completed"


def sc_fleet_drain(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)])
    reqs = [fs.req(side, 70 + i, 5, 6) for i in range(6)]
    for q in reqs:
        r.submit(q)
    r.step()
    stats = r.drain()
    snap = r.snapshot()
    late = fs.req(side, 80, 5, 4)
    d = r.submit(late)
    r.cancel_drain()
    ok = fs.req(side, 81, 5, 4)
    r.submit(ok)
    r.run()
    fs.assert_no_leaks(*r.engines)
    c = side.consts
    return {"drained": (stats["completed"], stats["shed"]),
            "flags": (snap[c.TELEMETRY_DRAINING], snap[c.TELEMETRY_DRAINED]),
            "late": (d.reason, late.status), "ok": ok.status,
            "statuses": fs.statuses(reqs), "router": fs.router_view(r)}


def test_fleet_drain_sheds_everywhere_and_reports_drained():
    got = both(sc_fleet_drain)
    assert sum(got["drained"]) == 6 and got["flags"] == (1, 1)
    assert got["late"] == ("fleet_full", "shed") and got["ok"] == "completed"


# ---------------------------------------------------------------------------
# fleet telemetry
# ---------------------------------------------------------------------------

def sc_snapshot(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)],
                         replicate_depth=1)
    r.register_prefix("sys", fs.prompt(90, 13))
    qs = [side.Request(prompt=fs.prompt(91, 5), max_new=4, prefix="sys")
          for _ in range(4)]
    for q in qs:
        r.submit(q)
    r.run()
    c = side.consts
    snap = r.snapshot()
    members = [e.telemetry.snapshot()[c.TELEMETRY_FLEET_ENGINE_ID]
               for e in r.engines]
    provider = side.telemetry.current_snapshot()[c.TELEMETRY_FLEET_ENGINES]
    ttft = snap[c.TELEMETRY_TTFT_P50_MS] > 0
    pages = snap[c.TELEMETRY_PAGES_TOTAL] == sum(e.alloc.usable_pages
                                                  for e in r.engines)
    r.drop_prefix("sys")
    fs.assert_no_leaks(*r.engines)
    return {"snap": fs.snap_view(snap), "keys": sorted(snap),
            "members": members, "provider": provider, "ttft": ttft,
            "pages": pages, "router": fs.router_view(r)}


def test_fleet_snapshot_merges_counters_and_fleet_keys():
    got = both(sc_snapshot)
    snap = got["snap"]
    c = fs.PORT.consts
    assert snap[c.TELEMETRY_FLEET_ENGINES] == 2
    assert snap[c.TELEMETRY_FLEET_HANDOFFS] == 1
    assert snap[c.TELEMETRY_RETIRED] == 4
    assert got["members"] == [0, 1] and got["provider"] == 2
    assert got["ttft"] and got["pages"]


def sc_healthz(side):
    r = side.FleetRouter([fs.paged(side), fs.paged(side)])
    doc = r.healthz()
    r.engines[1].telemetry.set_degraded(True)
    return {"first": (doc["ok"], doc["draining"], len(doc["engines"])),
            "degraded_ok": r.healthz()["ok"], "pressured": r._pressured(1)}


def test_fleet_healthz_aggregates_members():
    got = both(sc_healthz)
    assert got == {"first": (True, False, 2), "degraded_ok": True,
                   "pressured": True}


def test_fleet_snapshot_merge_rules_on_fake_members():
    """``fleet_snapshot`` over hand-set member telemetry on both
    packages: sums, the exact tail over the union of the sample pools,
    worst-member degraded / draining, goodput of healthy members only,
    the largest compile count."""
    def run(side):
        members = []
        for i, (ttft, degraded) in enumerate(((0.1, False), (0.9, True))):
            t = side.telemetry.EngineTelemetry()
            for j in range(5):
                t.ttft.observe(ttft + j * 0.01)
            t.set_degraded(degraded)
            t.set_pages(20, 5 + i, 10.0 * i)
            members.append(t)
        snap = side.telemetry.fleet_snapshot(members, extra={"x": 1})
        return {k: v for k, v in snap.items()
                if k not in (side.consts.TELEMETRY_COMPILE_SECONDS,
                             side.consts.TELEMETRY_COMPILES,
                             side.consts.TELEMETRY_KERNEL_FALLBACKS)}
    ref, port = run(fs.REF), run(fs.PORT)
    assert ref == port
    assert port[fs.PORT.consts.TELEMETRY_TTFT_P99_MS] == 940.0
    assert port[fs.PORT.consts.TELEMETRY_DEGRADED] == 1


# ---------------------------------------------------------------------------
# the port's own: metric series, isolation
# ---------------------------------------------------------------------------

def test_fleet_metric_series_advance_like_the_reference():
    """The five series under the reference's names and labels: the
    same breaker transitions, one-hot member states and failover
    outcomes after one manual open of member 0 on each package."""
    def run(side):
        from tpushare import metrics as jmetrics
        mod = side.metrics if side is fs.PORT else jmetrics
        series = (mod.FLEET_MEMBER_STATE, mod.FLEET_BREAKER_TRANSITIONS,
                  mod.FLEET_FAILOVER_OUTCOMES)
        before = [_values(s) for s in series]
        r = side.FleetRouter([fs.paged(side), fs.paged(side)], **fs.KNOBS)
        q = fs.req(side, 95, 5, 8)
        r.submit(q)
        r.step()
        r.open_member(0 if q in r.engines[0].running.values() else 1)
        r.run()
        deltas = []
        for s, b in zip(series, before):
            now = _values(s)
            deltas.append({k: now[k] - b.get(k, 0.0) for k in now
                           if now[k] != b.get(k, 0.0)})
        return {"names": [s.name for s in series], "deltas": deltas,
                "status": q.status}
    assert run(fs.REF) == run(fs.PORT)


def _values(family) -> dict:
    with family._lock:
        return {k: c.value for k, c in family._children.items()}


def test_constants_equal_the_reference_value_for_value():
    from tpushare import consts as jconsts
    port = fs.PORT.consts
    names = [n for n in dir(port) if n.isupper()
             and (n.startswith(("FLEET_", "WIRE_FAULT", "REMOTE_MEMBER",
                                "ERR_FLEET", "ERR_HANDOFF",
                                "TELEMETRY_FLEET", "METRIC_FLEET")))]
    assert len(names) > 60
    for n in names:
        assert getattr(port, n) == getattr(jconsts, n), n


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "tpushare_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    src = (REPO / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|tpushare)\b(?!_torch)",
                     src, flags=re.M)
    assert not bad, f"{path} imports {bad}"


# ---------------------------------------------------------------------------
# infer --fleet / --disaggregate / --listen / --join against the reference
# ---------------------------------------------------------------------------

INFER_FLAGS = ["--mode", "serve", "--slots", "2", "--requests", "4",
               "--seq", "32", "--steps", "8", "--hbm-limit-mib", "2000"]


@pytest.fixture()
def ref_infer(monkeypatch):
    """The reference payload's ``main`` with its SIGTERM handler put back
    after, isolation off, the HBM limit from the flags."""
    import signal

    from tpushare import consts as jconsts
    from tpushare.workloads import infer as jinfer
    monkeypatch.setenv(jconsts.ENV_DISABLE_ISOLATION, "true")
    monkeypatch.delenv(fs.PORT.consts.ENV_HBM_LIMIT_MIB, raising=False)
    prev = signal.getsignal(signal.SIGTERM)
    yield jinfer.main
    signal.signal(signal.SIGTERM, prev)


@pytest.mark.parametrize("bad", [
    ["--listen", "127.0.0.1:0", "--fleet", "2"],
    ["--listen", "127.0.0.1:0", "--join", "127.0.0.1:1"],
    ["--fleet", "1"],
    ["--disaggregate"],
    ["--join", "nohost"],
    ["--fleet", "2", "--ragged"],
], ids=["listen+fleet", "listen+join", "fleet1", "disagg-alone",
        "join-not-host-port", "fleet+ragged"])
def test_infer_fleet_guards_exit_2_like_the_reference(bad, ref_infer,
                                                      capsys):
    from tpushare_torch.workloads import infer
    assert ref_infer(INFER_FLAGS + bad) == 2
    with pytest.raises(SystemExit) as e:
        infer.run(infer.parse_args(INFER_FLAGS + bad + ["--device", "cpu"]))
    assert e.value.code == 2


def test_infer_fleet_sizing_and_report_like_the_reference(ref_infer,
                                                          monkeypatch):
    """``--fleet 2 --disaggregate`` through both payloads: the member
    pools split one budget (the same pages and lanes per member), the
    draft-free prefill member hands every request to the decode member,
    and the reports count the same handoffs and completions."""
    from tpushare_torch.workloads import infer
    routers = []

    class Recording(fs.REF.FleetRouter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            routers.append(self)

    monkeypatch.setattr(fs.REF.fleet, "FleetRouter", Recording)
    flags = INFER_FLAGS + ["--fleet", "2", "--disaggregate"]
    assert ref_infer(flags) == 0
    res = infer.run(infer.parse_args(flags + ["--device", "cpu"]))

    def view(router):
        return {"members": [(e.n_lanes, e.alloc.n_pages, e.kv_codec,
                             e.stats["handoffs_in"], e.stats["handoffs_out"],
                             e.stats["completed"]) for e in router.engines],
                "disaggregate": router.disaggregate,
                "handoffs": router.stats["handoffs"],
                "reasons": dict(router.stats["reasons"])}

    (ref_router,) = routers
    port_router = res["engine"]
    assert view(port_router) == view(ref_router)
    assert view(port_router)["handoffs"] == 4
    assert res["fleet_stats"]["completed"] == 4
    assert res["member_decode_steps"][0] == 0
