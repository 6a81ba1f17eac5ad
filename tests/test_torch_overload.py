"""The port's overload core held against the reference's on the CPU:
``AdmissionController`` gives the same verdicts, reasons, watermarks
and counters for the same call sequence under one fake clock (both
admit decisions, OOM cuts, progress, a pressure signal polled inline);
``from_env`` reads the same env dicts the same way; ``SyncWatchdog``
degrades, recovers, re-raises and never returns before its call ends;
``DrainTimeout``, the OOM test, the signal bridge and the unit math."""

import gc
import queue
import signal
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")

from tpushare import consts as jconsts  # noqa: E402
from tpushare import usageclient as jusage  # noqa: E402
from tpushare.tpu import device as jdevice  # noqa: E402
from tpushare.workloads import overload as joverload  # noqa: E402
from tpushare_torch import consts, device  # noqa: E402
from tpushare_torch.tpu.fake import (FakeMemberDeath,  # noqa: E402
                                     FakeResourceExhausted, WorkloadFault,
                                     WorkloadFaultPlan)
from tpushare_torch.workloads import overload  # noqa: E402


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def counters(ctl):
    return (ctl.watermark(), ctl.cuts, ctl.deferred_hbm, ctl.deferred_pages,
            ctl.deferred_watermark, ctl.floor_reached)


# (op, args...) — "t" advances the clock, "p" sets the pressure reading
SEQUENCES = {
    "hbm-gate": [("admit_ok", 0, 10.0), ("admit_ok", 1, 10.0, 95.0),
                 ("admit_ok", 1, 10.0, 90.0), ("could_ever_fit", 80.0),
                 ("could_ever_fit", 120.0), ("admit_ok", 3, 1.0),
                 ("admit_ok", 4, 1.0)],
    "pages-and-oom": [("admit_ok_pages", 0, 3, 10), ("admit_ok_pages", 1, 11,
                                                     10),
                      ("on_oom",), ("on_oom",), ("t", 0.5), ("on_oom",),
                      ("admit_ok_pages", 1, 2, 10), ("on_progress",),
                      ("on_progress",), ("admit_ok_pages", 1, 2, 10),
                      ("t", 2.0), ("on_oom",), ("on_oom",), ("on_oom",),
                      ("admit_ok_pages", 0, 1, 10),
                      ("could_ever_fit_pages", 12, 11),
                      ("could_ever_fit_pages", 11, 11)]
    + [("on_progress",)] * 20 + [("admit_ok_pages", 3, 1, 10)],
    "pressure": [("p", None), ("admit_ok", 0), ("p", 0.95),
                 ("pressure_deferring", 0), ("admit_ok", 0),
                 ("pressure_deferring", 1), ("admit_ok", 1), ("t", 1.5),
                 ("admit_ok_pages", 1, 1, 5), ("p", 0.5),
                 ("admit_ok_pages", 1, 1, 5), ("pressure_deferring", 1),
                 ("on_progress",), ("on_progress",), ("admit_ok", 2)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_admission_controller_equals_reference(name):
    clock = FakeClock()
    reading = {"p": None}
    kw = dict(cap_mib=100.0, base_mib=5.0, clock=clock,
              pressure_interval_s=0, md_cooldown_s=1.0)
    if name == "pressure":
        kw["pressure_fn"] = lambda: reading["p"]
    ours = overload.AdmissionController(4, **kw)
    ref = joverload.AdmissionController(4, **kw)
    assert counters(ours) == counters(ref)
    for op, *args in SEQUENCES[name]:
        if op == "t":
            clock.t += args[0]
            continue
        if op == "p":
            reading["p"] = args[0]
            continue
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args), op
        assert counters(ours) == counters(ref), op


ENVS = [
    {},
    {consts.ENV_HBM_LIMIT_MIB: "4096"},
    {consts.ENV_HBM_LIMIT_MIB: "bogus", consts.ENV_RESOURCE_BY_POD: "3"},
    {consts.ENV_RESOURCE_BY_POD: "3"},
    {consts.ENV_RESOURCE_BY_POD: "x"},
    {consts.ENV_USAGE_URL: "http://127.0.0.1:9/usage",
     consts.ENV_RESOURCE_INDEX: "1"},
    {consts.ENV_HOST_IP: "127.0.0.1", consts.ENV_USAGE_PORT: "9",
     consts.ENV_RESOURCE_INDEX: "0"},
    {consts.ENV_HOST_IP: "127.0.0.1", consts.ENV_RESOURCE_INDEX: "0"},
    {consts.ENV_USAGE_URL: "http://127.0.0.1:9",
     consts.ENV_RESOURCE_INDEX: "nan"},
]


@pytest.mark.parametrize("unit", [consts.MIB, consts.GIB])
@pytest.mark.parametrize("env", range(len(ENVS)))
def test_from_env_equals_reference(env, unit):
    ours = overload.AdmissionController.from_env(3, environ=ENVS[env],
                                                 memory_unit=unit)
    ref = joverload.AdmissionController.from_env(3, environ=ENVS[env],
                                                 memory_unit=unit)
    assert ours.cap_mib == ref.cap_mib
    assert ours.n_slots == ref.n_slots == 3
    # the pressure signal is wired (never polled here: no request leaves)
    assert (ours.pressure_fn is None) == (ref.pressure_fn is None)


def test_chip_pressure_and_units_equal_reference():
    doc = {"chips": [{"chip": 0, "pressure": {"capacity": 0.42}},
                     {"chip": 1, "pressure": {"capacity": None}},
                     {"chip": 2, "pressure": {"capacity": True}},
                     "junk", {"chip": "3", "pressure": {"capacity": 1}},
                     {"chip": 0, "pressure": {"capacity": 0.97}}]}
    for chip in range(4):
        assert overload.chip_pressure(doc, chip) == \
            jusage.chip_pressure(doc, chip)
    assert overload.chip_pressure(None, 0) is None
    for units, unit, chunk in ((3, consts.MIB, None), (3, consts.GIB, None),
                               (5, consts.MIB, 256)):
        assert device.units_to_mib(units, unit, chunk) == \
            jdevice.units_to_mib(units, unit, chunk)
    with pytest.raises(ValueError):
        device.units_to_mib(1, "TiB")
    assert consts.PRESSURE_ENGAGE == jconsts.PRESSURE_ENGAGE


def test_fetch_chip_pressure_reads_a_local_usage_endpoint():
    """One GET of a usage document served on localhost; a closed port is
    no signal, not an error."""
    import http.server
    import json

    doc = {"chips": [{"chip": 1, "pressure": {"capacity": 0.93}}]}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = json.dumps(doc).encode()
            self.send_response(200 if self.path == "/usage" else 404)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert overload.fetch_chip_pressure(url, 1) == 0.93
        assert overload.fetch_chip_pressure(url + "/usage", 0) is None
        ctl = overload.AdmissionController.from_env(
            4, environ={consts.ENV_USAGE_URL: url + "/usage",
                        consts.ENV_RESOURCE_INDEX: "1"},
            pressure_interval_s=0)
        assert ctl.admit_ok(1) == (False, "pressure")
        assert ctl.cuts == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_sync_watchdog_degrades_recovers_and_waits_for_the_call():
    events = []
    dog = overload.SyncWatchdog(0.05, on_degrade=lambda: events.append("d"),
                                on_recover=lambda: events.append("r"),
                                poll_s=0.01)
    assert dog.call(lambda: 7) == 7 and not events
    finished = threading.Event()

    def slow():
        time.sleep(0.3)
        finished.set()
        return "late"
    seen = []
    watcher = threading.Thread(
        target=lambda: (time.sleep(0.15), seen.append(dog.degraded)))
    watcher.start()
    assert dog.call(slow) == "late"
    # the caller never proceeds while the call may still touch its state
    assert finished.is_set()
    watcher.join()
    assert seen == [True] and not dog.degraded
    assert events == ["d", "r"] and dog.trips == 1

    def boom():
        raise FakeResourceExhausted()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        dog.call(boom)
    assert dog.call(lambda: 1) == 1
    with pytest.raises(ValueError):
        overload.SyncWatchdog(0)


def test_drain_timeout_carries_the_undrained():
    a, b = object(), object()
    exc = overload.DrainTimeout("did not drain", undrained=[a, b],
                                queue_depth=1)
    assert isinstance(exc, RuntimeError)
    assert exc.undrained == [a, b] and exc.queue_depth == 1
    assert exc.undrained_ids == [id(a), id(b)]
    assert overload.DrainTimeout("x").undrained == []


def test_is_resource_exhausted_matches_the_cards_oom():
    assert overload.is_resource_exhausted(FakeResourceExhausted())
    assert overload.is_resource_exhausted(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    try:
        try:
            raise torch.cuda.OutOfMemoryError("inner")
        except torch.cuda.OutOfMemoryError as inner:
            raise RuntimeError("dispatch failed") from inner
    except RuntimeError as outer:
        assert overload.is_resource_exhausted(outer)
    assert not overload.is_resource_exhausted(FakeMemberDeath())
    assert not overload.is_resource_exhausted(ValueError("nope"))
    assert not overload.is_resource_exhausted(None)


def test_fault_plan_schedules_like_the_reference():
    from tpushare.tpu import fake as jfake
    plans = (WorkloadFaultPlan(), jfake.WorkloadFaultPlan())
    for plan, mod in zip(plans, (None, jfake)):
        fault = WorkloadFault if mod is None else mod.WorkloadFault
        plan.add("dispatch", fault(times=2, kind="oom"))
        plan.add("sync", fault(times=1, kind="slow", delay_s=0.0))
        plan.add("step", fault(times=1, kind="fatal"))
        with pytest.raises(ValueError):
            plan.add("nope", fault())
    outcomes = []
    for plan in plans:
        got = []
        for route in ("dispatch", "sync", "dispatch", "dispatch", "step",
                      "admit"):
            try:
                plan.fire(route)
                got.append("ok")
            except Exception as e:  # noqa: BLE001
                got.append(type(e).__name__)
        outcomes.append((got, plan.triggered))
    (ours, ours_log), (ref, ref_log) = outcomes
    assert ours_log == ref_log
    assert [o.replace("FakeResourceExhausted", "oom") for o in ours] == \
        [o.replace("FakeResourceExhausted", "oom") for o in ref]


class Drainable:
    def __init__(self) -> None:
        self.drains = 0

    def request_drain(self) -> None:
        self.drains += 1


def test_watch_signal_queue_drains_on_the_first_matching_signal():
    eng, q, seen = Drainable(), queue.Queue(), []
    t = overload.watch_signal_queue(eng, q, signals=(signal.SIGTERM,),
                                    on_signal=seen.append)
    q.put(signal.SIGHUP)
    q.put(signal.SIGTERM)
    t.join(timeout=5)
    assert not t.is_alive()
    assert eng.drains == 1 and seen == [signal.SIGTERM]


def test_watch_signal_queue_ends_on_none_without_a_drain():
    eng, q = Drainable(), queue.Queue()
    t = overload.watch_signal_queue(eng, q)
    q.put(None)
    t.join(timeout=5)
    assert not t.is_alive() and eng.drains == 0


def test_serve_drain_watcher_ends_with_the_serve_run():
    """``infer``'s SIGTERM drain is scoped to the serve run: after it the
    handler is restored and the watcher thread has ended, so the engine
    is not kept alive by it."""
    from tpushare_torch.workloads import infer

    def watchers():
        return sum(t.name == "drain-on-signal" and t.is_alive()
                   for t in threading.enumerate())

    before, prev = watchers(), signal.getsignal(signal.SIGTERM)
    eng = Drainable()
    gone = weakref.ref(eng)
    with infer._drain_on_sigterm(eng):
        assert watchers() == before + 1
        assert signal.getsignal(signal.SIGTERM) != prev
    assert watchers() == before
    assert signal.getsignal(signal.SIGTERM) == prev
    del eng
    gc.collect()
    assert gone() is None


def test_sync_watchdog_worker_does_not_pin_its_owner():
    """The worker holds its queues only: a watchdog dropped by its owner
    is freed with what its callbacks close over (an engine), and that
    ends the worker."""
    owner = Drainable()
    wd = overload.SyncWatchdog(5.0, on_degrade=owner.request_drain)
    assert wd.call(lambda: 7) == 7
    worker, gone = wd._worker, weakref.ref(owner)
    del wd, owner
    gc.collect()
    worker.join(timeout=5)
    assert gone() is None and not worker.is_alive()


def test_install_signal_queue_delivers_sigterm():
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        q = overload.install_signal_queue(signals=(signal.SIGUSR1,))
        signal.raise_signal(signal.SIGUSR1)
        assert q.get(timeout=5) == signal.SIGUSR1
    finally:
        signal.signal(signal.SIGUSR1, prev)
