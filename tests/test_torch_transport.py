"""The port's cross-process fleet — RPC transport, ``EngineHost`` and
``RemoteMember`` — held against the reference on the CPU (the
reference's ``tests/test_transport_chaos.py``, every in-process scenario
run on both packages over the same ``bridge``-carried f32 weights and
the same fault plans): the fault plan's ledger, every fault kind typed
on the client, retries absorbing transients with idempotency tokens (an
install whose answer was lost lands once), remote members token-exact
on both pool codecs, a remote prefill member handing off across the
socket to a spec-armed local decode member with prefix subscribers, the
wire breaker opening, evacuating and reconnecting, a remote migration
counted as such, and the acceptance storm's exact fault ledger. Tokens,
statuses, ``router.stats``, breaker verdicts, wire counters and
allocator snapshots must be equal. A sampled request served remotely
equals the same package's in-process engine of the same seed (its
generator state and the sampled tokens ride the sync).

The port alone: a sampler prefilled locally and handed to a remote
decode member continues its stream across the wire (its generator
state in the handoff frame), and a control that reseeds the state on
the wire parts it. Then across two OS processes: a second interpreter
hosts a port engine on a socket (bound to port 0; the child is killed
in a ``finally``), the fleet serves across it, and the host dies under
SIGKILL mid-decode — every request ends in exactly one terminal status,
completions are token-exact, the wire breaker opens and the local pool
drains clean.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import torch_fleet_sides as fs  # noqa: E402

# the reference chaos idiom: manual probes, a fast probe timeout
KNOBS = {**fs.KNOBS, "probe_timeout_s": 0.5}


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


def one_shot(side):
    """A retry policy that surfaces every injected fault."""
    return side.retry.RetryPolicy(max_attempts=1, base_delay_s=0.01,
                                  max_delay_s=0.02, overall_deadline_s=5.0)


def drive(front, reqs, iters=600):
    for _ in range(iters):
        if all(q.done for q in reqs):
            return
        front.step()
    raise AssertionError(f"undrained after {iters} steps: "
                         f"{[q.status for q in reqs]}")


def exact(reqs) -> bool:
    return all(q.output == fs.PORT.offline(q.prompt, q.max_new)
               for q in reqs if q.status == "completed")


def wire_view(stats: dict) -> dict:
    return {k: stats[k] for k in ("wire_faults", "fault_kinds",
                                  "fault_log")}


# ---------------------------------------------------------------------------
# the fault plan and the transport
# ---------------------------------------------------------------------------

def sc_fault_plan(side):
    T = side.transport
    with pytest.raises(ValueError, match="unknown transport fault"):
        T.TransportFault(kind="teleport")
    plan = T.TransportFaultPlan()
    plan.add("step", T.TransportFault(times=2, kind=T.FAULT_SLOW))
    plan.add("*", T.TransportFault(times=1, kind=T.FAULT_CUT))
    kinds = [getattr(plan.take("step"), "kind", None) for _ in range(4)]
    ledger = list(plan.triggered)
    plan.clear()
    plan.add("healthz", T.TransportFault(times=-1, kind=T.FAULT_PARTITION))
    forever = [plan.take("healthz").kind for _ in range(5)]
    return {"kinds": kinds, "ledger": ledger, "forever": forever}


def test_fault_plan_routes_and_exact_accounting():
    got = both(sc_fault_plan)
    assert got["kinds"] == ["slow", "slow", "cut", None]
    assert got["forever"] == ["partition"] * 5


def sc_every_fault_kind(side):
    T, c = side.transport, side.consts
    srv = T.RpcServer(lambda op, args: op)
    plan = T.TransportFaultPlan()
    cli = T.RpcClient(srv.address, faults=plan, call_policy=one_shot(side))
    seen = []
    try:
        seen.append(cli.call("ping"))
        for kind in (T.FAULT_PARTITION, T.FAULT_CUT, T.FAULT_CORRUPT,
                     T.FAULT_ACK_DROP):
            plan.add("ping", T.TransportFault(times=1, kind=kind))
            with pytest.raises(T.TransportError) as e:
                cli.call("ping")
            seen.append((kind, e.value.kind))
        plan.add("ping", T.TransportFault(times=1, kind=T.FAULT_HANG))
        with pytest.raises(T.TransportError) as e:
            cli.call("ping", deadline_s=0.2)
        seen.append(e.value.kind)
        plan.add("ping", T.TransportFault(times=1, kind=T.FAULT_SLOW,
                                          delay_s=0.01))
        seen.append(cli.call("ping"))
        reconnects = cli.stats["reconnects"] >= 2
        srv2 = T.RpcServer(
            lambda op, args: (_ for _ in ()).throw(RuntimeError("no")))
        cli2 = T.RpcClient(srv2.address)
        with pytest.raises(T.RemoteOpError) as e:
            cli2.call("boom")
        seen.append((e.value.exc_type, cli2.stats["wire_faults"]))
        cli2.close()
        srv2.close()
    finally:
        cli.close()
        srv.close()
    return {"seen": seen, "wire": wire_view(cli.stats),
            "reconnects": reconnects,
            "timeout": c.WIRE_FAULT_TIMEOUT}


def test_every_fault_kind_surfaces_typed():
    got = both(sc_every_fault_kind)
    assert got["seen"][1:5] == [("partition", "refused"), ("cut", "cut"),
                                ("corrupt", "crc_mismatch"),
                                ("ack_drop", "cut")]
    assert got["seen"][5] == "timeout" and got["seen"][6] == "ping"
    assert got["seen"][7] == ("RuntimeError", 0)
    assert got["wire"]["wire_faults"] == 5 and got["reconnects"]


def sc_retry_idempotency(side):
    T = side.transport
    ran = []

    def handler(op, args):
        ran.append(op)
        return len(ran)

    srv = T.RpcServer(handler)
    plan = T.TransportFaultPlan()
    cli = T.RpcClient(srv.address, faults=plan)
    try:
        plan.add("inc", T.TransportFault(times=1, kind=T.FAULT_CUT))
        first = cli.call("inc", mutating=True)
        plan.add("inc", T.TransportFault(times=1, kind=T.FAULT_ACK_DROP))
        second = cli.call("inc", mutating=True)
    finally:
        cli.close()
        srv.close()
    return {"answers": (first, second), "ran": ran,
            "wire": wire_view(cli.stats)}


def test_retry_absorbs_transients_and_idempotency_dedupes():
    got = both(sc_retry_idempotency)
    assert got["answers"] == (1, 2) and got["ran"] == ["inc", "inc"]


def test_server_close_joins_its_thread():
    srv = fs.PORT.transport.RpcServer(lambda op, args: op)
    cli = fs.PORT.transport.RpcClient(srv.address)
    assert cli.call("x") == "x"
    cli.close()
    srv.close()
    assert not srv._thread.is_alive()


# ---------------------------------------------------------------------------
# remote members
# ---------------------------------------------------------------------------

def sc_ack_drop_install(side):
    T = side.transport
    plan = T.TransportFaultPlan()
    host = side.remote.EngineHost(fs.paged(side))
    member = side.remote.RemoteMember(host.address, faults=plan)
    src = fs.paged(side)
    try:
        q = fs.req(side, 1, 13, 10)
        src.submit(q)
        src._admit_waiting()
        (lane, _), = src.running.items()
        record = src.extract_request(lane)
        plan.add("install", T.TransportFault(times=1, kind=T.FAULT_ACK_DROP))
        landed = member.install_request(record) is not None
        once = (host.engine.stats["handoffs_in"], len(host.engine.running))
        src.detach_request(lane)
        drive(member, [q])
        fs.assert_no_leaks(src, host.engine)
        return {"landed": landed, "once": once, "ledger": plan.triggered,
                "wire": wire_view(member.wire_stats), "status": q.status,
                "tokens": q.output}
    finally:
        member.close()
        host.close()


def test_ack_drop_install_never_double_installs():
    got = both(sc_ack_drop_install)
    assert got["landed"] and got["once"] == (1, 1)
    assert got["status"] == "completed"
    assert got["tokens"] == fs.PORT.offline(fs.prompt(1, 13), 10)


def sc_remote_member(side, codec):
    oracle = fs.paged(side, kv_codec=codec, seed=7)
    o_greedy = fs.req(side, 11, 13, 10)
    o_sampled = fs.req(side, 12, 9, 10, temperature=0.8)
    for q in (o_greedy, o_sampled):
        oracle.submit(q)
    oracle.run()
    host = side.remote.EngineHost(fs.paged(side, kv_codec=codec, seed=7))
    member = side.remote.RemoteMember(host.address)
    try:
        greedy = fs.req(side, 11, 13, 10)
        sampled = fs.req(side, 12, 9, 10, temperature=0.8)
        for q in (greedy, sampled):
            member.submit(q)
        drive(member, [greedy, sampled])
        sampled_same = (sampled.output == o_sampled.output
                        and sampled.logprobs == pytest.approx(
                            o_sampled.logprobs))
        fs.assert_no_leaks(host.engine)
        return {"greedy": greedy.output, "oracle": o_greedy.output,
                "sampled_same": sampled_same,
                "completed": member.stats["completed"]}
    finally:
        member.close()
        host.close()


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_remote_member_token_exact_with_generator_continuity(codec):
    got = both(sc_remote_member, codec)
    assert got["greedy"] == got["oracle"] and got["sampled_same"]
    assert got["completed"] == 2
    if codec == "bf16":
        assert got["greedy"] == fs.PORT.offline(fs.prompt(11, 13), 10)


def sc_disagg_remote(side, codec):
    hostp = side.remote.EngineHost(fs.paged(side, kv_codec=codec))
    prefill = side.remote.RemoteMember(hostp.address)
    dec = fs.paged(side, kv_codec=codec, draft=(side.params, side.cfg, 4))
    r = side.FleetRouter([prefill, dec], disaggregate=True, n_prefill=1,
                         **KNOBS)
    try:
        sysp = fs.prompt(20, 13)
        r.register_prefix("sys", sysp)
        reqs = [side.Request(prompt=fs.prompt(21 + i, 9), max_new=8,
                             prefix="sys" if i % 2 else None)
                for i in range(4)]
        for q in reqs:
            r.submit(q)
        drive(r, reqs)
        oracle = fs.paged(side, kv_codec=codec)
        oracle.register_prefix("sys", sysp)
        want = []
        for q in reqs:
            oq = side.Request(prompt=list(q.prompt), max_new=q.max_new,
                              prefix=q.prefix)
            oracle.submit(oq)
            oracle.run()
            want.append(oq.output)
        handoffs = r.stats["handoffs"]
        wave2 = [fs.req(side, 26 + i, 6, 12) for i in range(2)]
        for q in wave2:
            r.submit(q)
        drive(r, wave2)
        view = fs.router_view(r)
        r.drop_prefix("sys")
        oracle.drop_prefix("sys")
        fs.assert_no_leaks(dec, hostp.engine, oracle)
        return {"tokens": fs.outputs(reqs), "oracle": want,
                "statuses": fs.statuses(reqs + wave2),
                "wave2": fs.outputs(wave2), "handoffs": handoffs,
                "spec_rounds": dec.stats["spec_rounds"] > 0,
                "router": view}
    finally:
        prefill.close()
        hostp.close()


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_disaggregated_remote_prefill_prefix_and_spec_exact(codec):
    got = both(sc_disagg_remote, codec)
    assert got["tokens"] == got["oracle"] and got["handoffs"] >= 4
    assert all(s == ("completed", True) for s in got["statuses"])
    assert got["spec_rounds"]


# ---------------------------------------------------------------------------
# the wire breaker
# ---------------------------------------------------------------------------

def sc_wire_breaker(side):
    T, c = side.transport, side.consts
    plan = T.TransportFaultPlan()
    host = side.remote.EngineHost(fs.paged(side))
    remote = side.remote.RemoteMember(host.address, faults=plan)
    local = fs.paged(side)
    r = side.FleetRouter([remote, local], breaker_wire_faults=2, **KNOBS)
    try:
        reqs = [fs.req(side, 30 + i, 5, 8) for i in range(4)]
        for q in reqs:
            r.submit(q)
        r.step()
        busy = bool(remote.running or remote.queue)
        plan.add("*", T.TransportFault(times=-1, kind=T.FAULT_PARTITION))
        for _ in range(4):
            r.step()
        opened = (r.member_states()[0], dict(r.healthz()["members"][0]),
                  not remote.running and not remote.queue)
        r.run()
        plan.clear()
        plan.add("healthz", T.TransportFault(times=1, kind=T.FAULT_CUT))
        time.sleep(0.06)
        before = remote.wire_stats["reconnects"]
        recovered = r.probe()[0]
        redialed = remote.wire_stats["reconnects"] > before
        extra = fs.req(side, 39, 5, 4)
        r.submit(extra)
        r.run()
        snap = r.snapshot()
        fs.assert_no_leaks(local)
        return {"busy": busy, "opened": opened, "recovered": recovered,
                "redialed": redialed, "statuses": fs.statuses(reqs),
                "exact": exact(reqs), "extra": extra.status,
                "wire": (snap[c.TELEMETRY_FLEET_WIRE_FAULTS]
                         == remote.wire_stats["wire_faults"],
                         snap[c.TELEMETRY_FLEET_WIRE_RECONNECTS]
                         == remote.wire_stats["reconnects"],
                         snap[c.TELEMETRY_FLEET_REMOTE_MEMBERS]),
                "router": {k: v for k, v in fs.router_view(r).items()
                           if k != "allocs"}}
    finally:
        remote.close()
        host.close()


def test_wire_breaker_opens_evacuates_and_reconnects():
    got = both(sc_wire_breaker)
    state, member, evacuated = got["opened"]
    assert got["busy"] and state == "open" and evacuated
    assert member["reason"] == "transport_faults" and not member["fatal"]
    assert got["recovered"] == "closed" and got["redialed"]
    assert got["router"]["stats"]["breaker_recoveries"] == 1
    assert got["exact"] and got["extra"] == "completed"
    assert got["wire"] == (True, True, 1)


def sc_remote_migration(side):
    host = side.remote.EngineHost(fs.paged(side))
    remote = side.remote.RemoteMember(host.address)
    local = fs.paged(side)
    r = side.FleetRouter([remote, local], **KNOBS)
    try:
        q = fs.req(side, 40, 9, 16)
        r.submit(q)
        while not (remote.running
                   and any(x.output for x in remote.running.values())):
            r.step()
        r.open_member(0)
        counts = (r.stats["migrations"], r.stats["remote_migrations"],
                  local.stats["handoffs_in"])
        r.run()
        snap = r.snapshot()
        fs.assert_no_leaks(local, host.engine)
        return {"counts": counts, "status": q.status, "tokens": q.output,
                "snap": snap[side.consts.TELEMETRY_FLEET_REMOTE_MIGRATIONS]}
    finally:
        remote.close()
        host.close()


def test_remote_migration_counts_cross_process_moves():
    got = both(sc_remote_migration)
    assert got["counts"] == (1, 1, 1) and got["snap"] == 1
    assert got["status"] == "completed"
    assert got["tokens"] == fs.PORT.offline(fs.prompt(40, 9), 16)


# ---------------------------------------------------------------------------
# the acceptance storm
# ---------------------------------------------------------------------------

def sc_storm(side):
    T, c = side.transport, side.consts
    plan = T.TransportFaultPlan()
    host = side.remote.EngineHost(fs.paged(side, n_lanes=6))
    remote = side.remote.RemoteMember(host.address, faults=plan)
    e1, e2 = fs.paged(side, n_lanes=6), fs.paged(side, n_lanes=6)
    r = side.FleetRouter([remote, e1, e2], breaker_wire_faults=2, **KNOBS)
    try:
        reqs = [fs.req(side, 100 + i, 4 + (i % 5), 8 + (i % 4))
                for i in range(24)]
        for q in reqs:
            r.submit(q)
        for _ in range(2):
            r.step()
        live = bool(remote.running)
        for kind, times in ((T.FAULT_SLOW, 1), (T.FAULT_CORRUPT, 1),
                            (T.FAULT_CUT, 1), (T.FAULT_PARTITION, 2)):
            plan.add("step", T.TransportFault(times=times, kind=kind,
                                              delay_s=0.01))
        plan.add("step", T.TransportFault(times=1, kind=T.FAULT_DEATH,
                                          hook=host.close))
        r.run()
        by = {s: sum(1 for q in reqs if q.status == s)
              for s in side.overload.TERMINAL_STATUSES}
        evacuated = not remote.running and not remote.queue
        extra = fs.req(side, 140, 5, 4)
        r.submit(extra)
        r.run()
        fs.assert_no_leaks(e1, e2)
        snap = r.snapshot()
        return {"live": live, "ledger": plan.triggered, "by": by,
                "statuses": fs.statuses(reqs), "tokens": fs.outputs(reqs),
                "exact": exact(reqs), "evacuated": evacuated,
                "extra": extra.status,
                "snap": (snap[c.TELEMETRY_FLEET_REMOTE_MEMBERS],
                         snap[c.TELEMETRY_FLEET_WIRE_FAULTS]
                         == remote.wire_stats["wire_faults"]),
                "router": {k: v for k, v in fs.router_view(r).items()
                           if k != "allocs"}}
    finally:
        remote.close()
        host.close()


def test_acceptance_storm_full_fault_plan_under_burst():
    got = both(sc_storm)
    assert got["live"] and got["evacuated"] and got["exact"]
    assert got["ledger"] == [("step", "slow"), ("step", "corrupt"),
                             ("step", "cut"), ("step", "partition"),
                             ("step", "partition"), ("step", "death")]
    stats = got["router"]["stats"]
    assert stats["wire_faults"] == 2 and stats["breaker_opens"] == 1
    m = got["router"]["members"][0]
    assert m["reason"] == "transport_faults" and not m["fatal"]
    assert sum(got["by"].values()) == 24 and got["by"]["completed"] > 0
    assert got["extra"] == "completed" and got["snap"] == (1, True)


# ---------------------------------------------------------------------------
# two OS processes: the port's host killed with SIGKILL mid-decode
# ---------------------------------------------------------------------------

_CHILD = """
import torch
from tpushare_torch.workloads.models import transformer as tt
from tpushare_torch.workloads.remote import EngineHost
from tpushare_torch.workloads.serving import PagedServingEngine

torch.set_num_threads(1)
CFG = tt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                           d_ff=128, max_seq=256, dtype=torch.float32)
g = torch.Generator()
g.manual_seed(0)
eng = PagedServingEngine(tt.init_params(g, CFG, "cpu"), CFG, n_lanes=3,
                         max_seq=96, n_pages=40, page_size=8,
                         prompt_buckets=(8, 32), chunk=4)
host = EngineHost(eng)
print("PORT", host.address[1], flush=True)
host.serve_forever()
"""


def test_two_os_process_fleet_kill9_mid_decode():
    from tpushare_torch.workloads import decode
    from tpushare_torch.workloads.models import transformer as tt
    side = fs.PORT
    g = torch.Generator()
    g.manual_seed(0)
    params = tt.init_params(g, fs.CFG, "cpu")   # the child's weights
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(fs.__file__).rsplit("/tests/", 1)[0],
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, text=True)
    # a child that never answers must not hang the suite
    watchdog = threading.Timer(120.0, proc.kill)
    watchdog.start()
    remote = None
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("PORT "):
                port = int(line.split()[1])
                break
        assert port is not None, "host process never came up"
        remote = side.remote.RemoteMember(("127.0.0.1", port))
        local = side.Paged(params, fs.CFG, **fs.PAGED_KW)
        r = side.FleetRouter([remote, local], breaker_wire_faults=2,
                             **KNOBS)
        reqs = [fs.req(side, 50 + i, 7, 12) for i in range(6)]
        for q in reqs:
            r.submit(q)
        for _ in range(100):
            r.step()
            if any(q.output for q in remote.running.values()):
                break
        assert any(q.output for q in remote.running.values()), \
            "no token in flight on the remote host"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        r.run()
        for q in reqs:
            assert q.done and q.status in side.overload.TERMINAL_STATUSES
            if q.status == "completed":
                want = decode.generate(params, torch.tensor([q.prompt]),
                                       fs.CFG, q.max_new)[0].tolist()
                assert q.output == want
        assert r.member_states()[0] == "open"
        assert r.healthz()["members"][0]["reason"] == "transport_faults"
        assert r.stats["wire_faults"] >= 2
        assert remote.wire_stats["wire_faults"] >= 2
        fs.assert_no_leaks(local)
    finally:
        watchdog.cancel()
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# a sampled stream across the wire (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reseed", [False, True], ids=["carried", "control"])
def test_sampled_handoff_across_the_wire_continues_the_stream(reseed,
                                                             monkeypatch):
    """A temperature-0.8 request prefilled on a local member and handed
    to a remote decode member: the lane's generator state crosses the
    wire in the handoff frame and the stream continues — tokens and
    logprobs equal the same request, same seed, on one engine. The
    control reseeds the generator in every record the wire carries (as
    an encoding that dropped the state would) and must part the
    stream."""
    side = fs.PORT
    stay_eng = fs.paged(side, seed=7)
    stay = fs.req(side, 60, 9, 16, temperature=0.8)
    stay_eng.submit(stay)
    stay_eng.run()
    if reseed:
        encode = side.wirecodec.encode_handoff

        def reseeded(record):
            gen = torch.Generator()
            gen.manual_seed(12345)
            return encode({**record, "generator": gen.get_state()})
        monkeypatch.setattr(side.wirecodec, "encode_handoff", reseeded)
    host = side.remote.EngineHost(fs.paged(side, seed=99))
    member = side.remote.RemoteMember(host.address)
    prefill = fs.paged(side, seed=7)
    r = side.FleetRouter([prefill, member], disaggregate=True, **KNOBS)
    try:
        moved = fs.req(side, 60, 9, 16, temperature=0.8)
        r.submit(moved)
        drive(r, [moved])
        assert moved.status == "completed"
        assert r.stats["handoffs"] == 1
        if reseed:
            assert moved.output != stay.output
        else:
            assert moved.output == stay.output
            assert moved.logprobs == pytest.approx(stay.logprobs)
        fs.assert_no_leaks(prefill, host.engine)
    finally:
        member.close()
        host.close()
