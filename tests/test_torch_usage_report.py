"""The port's payload surface against the reference's: the allocator cap
from the pod's HBM grant (``device.memory_fraction`` / ``apply_hbm_cap``
against ``deviceplugin.allocate.isolation_envs``), the usage reports
(``workloads/usage_report.py``) landing in the reference daemon's
``UsageStore`` as the reference payload's do, the drain and resume
directives through a local HTTP server, and the poisoned Allocate env.

Nothing here reaches an outside host: every server listens on
127.0.0.1.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

torch = pytest.importorskip("torch")

from tpushare import consts as jconsts  # noqa: E402
from tpushare import metrics as jmetrics  # noqa: E402
from tpushare.deviceplugin.allocate import isolation_envs  # noqa: E402
from tpushare.deviceplugin.usage import UsageStore  # noqa: E402
from tpushare.testing.builders import make_pod  # noqa: E402
from tpushare.workloads import infer as jinfer  # noqa: E402
from tpushare.workloads import usage_report as jusage  # noqa: E402
from tpushare_torch import consts, device  # noqa: E402
from tpushare_torch.workloads import infer, telemetry  # noqa: E402
from tpushare_torch.workloads import usage_report  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_handlers():
    yield
    usage_report.set_drain_handler(None)
    jusage.set_drain_handler(None)
    telemetry.set_snapshot_provider(None)


@pytest.fixture()
def store(api, apiserver):
    s = UsageStore(api=api, stale_s=60.0)
    yield s, apiserver
    s.detach_metrics()


@pytest.fixture()
def obs(store):
    """The reference daemon's obs endpoint with the store as its sink."""
    from tpushare.obs import serve_metrics, set_usage_sink
    s, apiserver = store
    set_usage_sink(s.handle)
    httpd = serve_metrics(0, host="127.0.0.1")
    try:
        yield s, apiserver, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        set_usage_sink(None)
        httpd.shutdown()


class _Directives:
    """A local daemon stand-in: answers each POST with the next queued
    directive body and keeps what it was sent."""

    def __init__(self, answers: list[dict]) -> None:
        self.answers = list(answers)
        self.bodies: list[dict] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                outer.bodies.append(json.loads(self.rfile.read(n)))
                body = json.dumps(outer.answers.pop(0)
                                  if outer.answers else {}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/usage"

    def close(self) -> None:
        self.httpd.shutdown()


# ---------------------------------------------------------------------------
# the allocator cap
# ---------------------------------------------------------------------------

LIMITS = (0, 1, 512, 2000, 8191, 16_384, 32_768, 36_000, 40_000, 81_559,
          95_000, 10 ** 6)
TOTALS = (0, 16_384, 32_768, 81_559, 95_830)


@pytest.mark.parametrize("total", TOTALS)
def test_cap_fraction_equals_the_references_isolation_envs(total):
    """The port's fraction is the one the reference's Allocate writes
    into ``XLA_PYTHON_CLIENT_MEM_FRACTION``: clamped to [0, 1], floored
    at the 4th decimal, 1 for a card of unknown size."""
    for limit in LIMITS:
        ref = isolation_envs(limit, total)[jconsts.ENV_XLA_MEM_FRACTION]
        ours = device.memory_fraction(limit, total)
        assert f"{ours:.4f}" == ref, (limit, total)
        assert 0.0 <= ours <= 1.0
    # co-resident grants never sum past the card
    assert device.memory_fraction(36_000, 81_559) * 2 <= 1.0


def test_cap_is_skipped_off_the_card_and_when_isolation_is_off(capsys):
    assert device.apply_hbm_cap("cpu", 1000) is None
    env = {consts.ENV_DISABLE_ISOLATION: "true"}
    assert device.apply_hbm_cap("cuda", 1000, environ=env) is None
    assert "allocator cap: off" in capsys.readouterr().out


def _stub_cards(monkeypatch, n_cards: int, card_mib: int = 81_079):
    """A host of ``n_cards`` CUDA cards, its calls stubbed; returns the
    list the cap's ``set_per_process_memory_fraction`` calls land in."""
    set_to = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {
                            "total_memory": card_mib * 2 ** 20})())
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda frac, i: set_to.append((frac, i)))
    return set_to


def test_cap_takes_allocates_fraction_else_derives_it(monkeypatch, capsys):
    """With a card (its calls stubbed here): Allocate's fraction wins
    when the env carries one; otherwise the fraction is the limit over
    the card's memory, by the reference's rule."""
    card_mib = 81_079
    set_to = _stub_cards(monkeypatch, 1, card_mib)
    assert device.apply_hbm_cap("cuda", 32768, environ={}) == \
        device.memory_fraction(32768, card_mib) == 0.4041
    given = {consts.ENV_XLA_MEM_FRACTION: "0.2500"}
    assert device.apply_hbm_cap("cuda:0", 32768, environ=given) == 0.25
    assert set_to == [(0.4041, 0), (0.25, 0)]
    out = capsys.readouterr().out
    assert out.count("allocator cap: XLA_PYTHON_CLIENT_MEM_FRACTION=") == 2
    assert "not the CUDA context" in out


@pytest.mark.parametrize("tp,pp,cards", [(1, 1, [0]), (2, 1, [0, 1]),
                                         (2, 2, [0, 1, 2, 3])])
def test_cap_covers_every_card_of_the_payloads_mesh(monkeypatch, capsys,
                                                    tp, pp, cards):
    """A ``--tp``/``--pp`` serve allocates on each card of its mesh, so
    the cap is set once on each of them, as the reference's fraction
    holds every device of its client; a card named twice is capped
    once."""
    set_to = _stub_cards(monkeypatch, 4)
    args = infer.parse_args(["--mode", "serve", "--tp", str(tp),
                             "--pp", str(pp)])
    devs = infer.payload_devices(args)
    assert len(devs) == tp * pp
    frac = device.memory_fraction(32768, 81_079)
    assert device.apply_hbm_cap(devs, 32768, environ={}) == frac
    assert set_to == [(frac, i) for i in cards]
    set_to.clear()
    assert device.apply_hbm_cap([torch.device("cuda", 0)] * 4, 32768,
                                environ={}) == frac
    assert set_to == [(frac, 0)]
    out = capsys.readouterr().out
    assert out.count("allocator cap: XLA_PYTHON_CLIENT_MEM_FRACTION=") == 2
    assert all(f"cuda:{i} (" in out for i in cards)


def test_usage_sums_the_allocator_figures_of_every_card(monkeypatch):
    """A sharded payload's report is its whole footprint: the allocator's
    current and peak bytes summed over the process's cards (a card it
    never allocated on adds 0); one named card reads alone."""
    mib = 2 ** 20
    stats = {0: {"allocated_bytes.all.current": 100 * mib,
                 "allocated_bytes.all.peak": 300 * mib},
             1: {"allocated_bytes.all.current": 50 * mib,
                 "allocated_bytes.all.peak": 70 * mib},
             2: {"allocated_bytes.all.current": 0,
                 "allocated_bytes.all.peak": 0}}
    _stub_cards(monkeypatch, 3)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: stats[torch.device(d).index])
    assert usage_report.read_hbm_usage() == {
        "used_mib": 150.0, "peak_mib": 370.0, "peak_kind": "allocator",
        "source": "memory_stats"}
    assert usage_report.read_hbm_usage("cuda:1")["peak_mib"] == 70.0


# ---------------------------------------------------------------------------
# the poisoned Allocate env
# ---------------------------------------------------------------------------

def test_poisoned_visible_chips_exits_3_on_both_payloads(monkeypatch,
                                                         capsys):
    """A failed Allocate answers gRPC success with a poisoned
    ``TPU_VISIBLE_CHIPS``; the payload must fail loudly (exit 3) rather
    than serve."""
    poison = jconsts.ERR_VISIBLE_DEVICES_FMT.format(amount=4096, unit="MiB")
    assert poison.startswith(consts.ERR_VISIBLE_DEVICES_PREFIX)
    monkeypatch.setenv(consts.ENV_TPU_VISIBLE_CHIPS, poison)
    assert jinfer.main([]) == 3
    assert infer.main(["--device", "cpu", "--mode", "serve"]) == 3
    assert f"allocation failed: {poison}" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# usage reports into the reference daemon
# ---------------------------------------------------------------------------

def _annotation(apiserver, pod: str) -> dict:
    ann = apiserver.get_pod("default", pod)["metadata"]["annotations"]
    return json.loads(ann[jconsts.USED_ANNOTATION])


def test_port_post_lands_in_the_reference_store_like_the_references(obs):
    """The same usage figures posted by each package's ``post_usage``
    reach the daemon's annotation and gauge identically."""
    s, apiserver, base = obs
    for name, mod in (("ref-pod", jusage), ("port-pod", usage_report)):
        apiserver.add_pod(make_pod(name, hbm=4))
        assert mod.post_usage(f"{base}/usage", name, "default",
                              {"used_mib": 512.0, "peak_mib": 600.0,
                               "peak_kind": "allocator",
                               "source": "memory_stats"},
                              telemetry={})
    ref, port = _annotation(apiserver, "ref-pod"), _annotation(apiserver,
                                                             "port-pod")
    ref.pop("ts"), port.pop("ts")
    assert port == ref
    assert port["used_mib"] == 512.0 and port["peak_kind"] == "allocator"
    assert jmetrics.HBM_USED_MIB.current() == 1024.0
    body = urllib.request.urlopen(f"{base}/metrics").read().decode()
    assert "tpushare_hbm_used_mib 1024.0" in body


def test_post_now_carries_the_engines_telemetry_and_trace_id(obs,
                                                              monkeypatch):
    """``post_now`` resolves the env contract, posts the shutdown body
    where no allocator stats exist (the CPU), attaches the live serving
    snapshot, and rides the Allocate trace id."""
    s, apiserver, base = obs
    apiserver.add_pod(make_pod("srv", hbm=4))
    monkeypatch.setenv(consts.ENV_USAGE_URL, f"{base}/usage")
    monkeypatch.setenv(consts.ENV_POD_NAME, "srv")
    monkeypatch.setenv(consts.ENV_POD_NAMESPACE, "default")
    monkeypatch.setenv(consts.ENV_TRACE_ID, "trace-7")
    assert usage_report.resolve_trace_id() == "trace-7"
    assert usage_report.read_hbm_usage() is None          # no CUDA here
    assert usage_report.read_hbm_usage("cpu") is None
    eng = telemetry.EngineTelemetry().publish()
    eng.set_kv_codec("bf16", 4096.0)
    assert usage_report.post_now()
    ann = _annotation(apiserver, "srv")
    assert ann["used_mib"] == 0.0 and ann["peak_mib"] == 0.0
    r = s._reports[("default", "srv")]
    assert r.telemetry[jconsts.TELEMETRY_KV_CODEC] == "bf16"
    assert r.telemetry[jconsts.TELEMETRY_KV_BYTES_PER_TOKEN] == 4096.0


def test_unconfigured_reporting_is_a_silent_no_op(monkeypatch):
    for env in (consts.ENV_USAGE_URL, consts.ENV_HOST_IP,
                consts.ENV_USAGE_PORT, consts.ENV_POD_NAME):
        monkeypatch.delenv(env, raising=False)
    assert usage_report.resolve_report_url() is None
    assert usage_report.start_reporter() is None
    assert usage_report.post_now() is False
    monkeypatch.setenv(consts.ENV_HOST_IP, "10.0.0.7")
    monkeypatch.setenv(consts.ENV_USAGE_PORT, "9310")
    assert usage_report.resolve_report_url() == \
        jusage.resolve_report_url() == "http://10.0.0.7:9310/usage"
    # a dead endpoint is a False, never an exception
    assert usage_report.post_usage("http://127.0.0.1:9/usage", "p",
                                   "default", {"used_mib": 1.0},
                                   timeout_s=0.2, telemetry={}) is False


def test_drain_and_resume_directives_reach_the_handlers_as_the_references():
    """A POST answered ``{"drain": true}`` fires the drain handler once
    (repeats do not re-fire), ``{"drain": false}`` fires the resume
    handler once, and both packages call them in the same order."""
    answers = [{"drain": True}, {"drain": True}, {"drain": False},
               {"drain": False}, {"drain": True}]
    calls = {}
    for name, mod in (("ref", jusage), ("port", usage_report)):
        srv = _Directives(answers)
        seen: list[str] = []
        try:
            mod.set_drain_handler(lambda: seen.append("drain"),
                                  on_resume=lambda: seen.append("resume"))
            for _ in answers:
                assert mod.post_usage(srv.url, "p", "default",
                                      {"used_mib": 1.0}, telemetry={})
        finally:
            srv.close()
        calls[name] = seen
        assert srv.bodies[0]["pod"] == "p"
    assert calls["port"] == calls["ref"] == ["drain", "resume", "drain"]


def test_drain_directive_drains_a_serving_engine_and_resume_reopens_it():
    """The payload wires the directive to the serve front's
    ``request_drain`` / ``cancel_drain``: a paged engine stops admitting
    on the directive and admits again once it is withdrawn."""
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                            d_ff=64, max_seq=64, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = PagedServingEngine(params, cfg, n_lanes=2, max_seq=64, n_pages=9,
                             page_size=8, prompt_buckets=(8,), chunk=4)
    srv = _Directives([{"drain": True}, {"drain": False}])
    try:
        usage_report.set_drain_handler(eng.request_drain,
                                       on_resume=eng.cancel_drain)
        assert usage_report.post_usage(srv.url, "p", "default",
                                       {"used_mib": 1.0}, telemetry={})
        assert eng.draining
        shed = Request(prompt=[1, 2, 3], max_new=2)
        eng.submit(shed)
        eng.run()
        assert shed.status == consts.STATUS_SHED
        assert usage_report.post_usage(srv.url, "p", "default",
                                       {"used_mib": 1.0}, telemetry={})
        assert not eng.draining
        ok = Request(prompt=[1, 2, 3], max_new=2)
        eng.submit(ok)
        eng.run()
        assert ok.status == consts.STATUS_COMPLETED
    finally:
        srv.close()


def test_infer_serve_wires_the_directive_and_posts_its_last_report(
        monkeypatch, capsys):
    """``infer`` serves with the directive wired to its engine (and lets
    go of it after the run), and a serve run's last POST carries the
    final counters."""
    srv = _Directives([])
    try:
        monkeypatch.setenv(consts.ENV_USAGE_URL, srv.url)
        monkeypatch.setenv(consts.ENV_POD_NAME, "payload")
        seen = []
        real = usage_report.set_drain_handler

        def spy(fn, on_resume=None):
            seen.append((fn, on_resume))
            real(fn, on_resume)

        monkeypatch.setattr(usage_report, "set_drain_handler", spy)
        assert infer.main(["--device", "cpu", "--mode", "serve", "--paged",
                           "--steps", "4", "--requests", "2", "--seq", "32",
                           "--slots", "2"]) == 0
    finally:
        srv.close()
    fn, on_resume = seen[0]
    assert fn.__name__ == "request_drain"
    assert on_resume.__name__ == "cancel_drain"
    assert seen[-1] == (None, None)
    last = srv.bodies[-1]
    assert last["pod"] == "payload" and last["source"] == "shutdown"
    tel = last[consts.USAGE_TELEMETRY_KEY]
    assert tel[consts.TELEMETRY_RETIRED] >= 2


def test_a_fleet_reports_its_merged_snapshot():
    """Under ``infer --fleet`` the router publishes the merged snapshot
    as the process's provider, so a usage POST carries the fleet's view,
    as the reference's does."""
    from tpushare_torch.workloads.fleet import FleetRouter
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    from tpushare_torch.workloads.serving import PagedServingEngine
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                            d_ff=64, max_seq=64, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    engines = [PagedServingEngine(params, cfg, n_lanes=2, max_seq=64,
                                  n_pages=9, page_size=8,
                                  prompt_buckets=(8,), chunk=4)
               for _ in range(2)]
    router = FleetRouter(engines)
    snap = usage_report._telemetry_snapshot()
    assert snap[consts.TELEMETRY_FLEET_ENGINES] == 2
    assert snap == router.snapshot()


def test_train_payload_posts_its_last_report_only_on_a_sigterm_drain(
        monkeypatch, tmp_path, capsys):
    """The training payload posts one immediate usage report when a
    SIGTERM drained it (its checkpoint written first), as the
    reference's does, and none on a run that ends normally."""
    import queue
    import signal

    from tpushare_torch.workloads import train_payload
    posts = []
    monkeypatch.setattr(usage_report, "post_now",
                        lambda *a, **k: posts.append(1) or True)
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
            "16", "--checkpoint-dir", str(tmp_path / "ck")]
    assert train_payload.main(argv) == 0
    assert posts == []
    real = train_payload.install_signal_queue

    def evicted(signals):
        q: queue.Queue = real(signals)
        q.put(signal.SIGTERM)
        return q

    monkeypatch.setattr(train_payload, "install_signal_queue", evicted)
    assert train_payload.main(argv[:3] + ["4"] + argv[4:]) == 0
    out = capsys.readouterr().out
    assert "graceful drain at step 2" in out
    assert posts == [1]
