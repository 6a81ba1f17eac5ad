"""The port's serving telemetry, SLO policy and request traces held
against the reference's on the CPU: ``EngineTelemetry`` driven through
the same hook sequence under one injected clock gives the reference's
snapshot key for key and value for value — the compile pair aside (the
port counts its kernel builds there, the reference JAX compile events)
— with the conditional keys appearing and disappearing together;
``SLOPolicy.attribute`` and ``phase_reached`` agree over a grid of phase
times; ``RequestTrace`` keeps, drops and shapes its spans as the
reference's does."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from tpushare import consts as jconsts  # noqa: E402
from tpushare import tracing as jtracing  # noqa: E402
from tpushare.workloads import slo as jslo  # noqa: E402
from tpushare.workloads import telemetry as jtel  # noqa: E402
from tpushare.workloads.ops import registry as jregistry  # noqa: E402
from tpushare_torch import consts, tracing  # noqa: E402
from tpushare_torch.workloads import slo, telemetry  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402

COMPILE_KEYS = {consts.TELEMETRY_COMPILES, consts.TELEMETRY_COMPILE_SECONDS}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _clean_process_state():
    registry.reset_fallbacks()
    jregistry.reset_fallbacks()
    yield
    registry.reset_fallbacks()
    jregistry.reset_fallbacks()
    telemetry.set_snapshot_provider(None)
    jtel.set_snapshot_provider(None)


def without_compiles(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k not in COMPILE_KEYS}


def status(name):
    return {"completed": "completed", "shed": "shed",
            "deadline": "deadline_exceeded", "oom": "oom_quarantined"}[name]


# (op, args...) — "t" advances the shared clock, "snap" compares the two
# snapshots; every other op is the same-named hook called on both
def lifecycle(key, ttft_parts=(0.1, 0.05, 0.2), decode=(0.3, 6),
              end="completed"):
    q, a, p = ttft_parts
    d, toks = decode
    return [("submitted", key), ("t", q), ("admit_start", key), ("t", a),
            ("prefill_start", key), ("prefill_chunk", 32), ("t", p),
            ("admitted", key), ("first_token", key), ("t", d),
            ("decode_chunk", 4, d, toks - 1), ("tokens", 1),
            ("retired", key, toks, status(end)), ("snap",)]


SCENARIOS = {
    # a slot engine: no page, codec, drain, spec, mesh or fleet keys
    "slot-good": lifecycle(1) + lifecycle(2, (0.2, 0.0, 0.1), (0.1, 3)),
    "slot-ttft-and-decode-violations":
        lifecycle(1, (2.5, 0.1, 0.1)) + lifecycle(2, (0.1, 1.9, 0.4))
        + lifecycle(3, (0.1, 0.1, 3.0)) + lifecycle(4, decode=(9.0, 5)),
    "overload-terminals": [
        ("set_watermark", 4), ("submitted", 1), ("shed", 1), ("shed", None),
        ("submitted", 2), ("t", 0.3), ("deadline_exceeded", 2, True),
        ("submitted", 3), ("admit_start", 3), ("prefill_start", 3),
        ("oom_recovery", 3, True), ("oom_recovery",), ("snap",),
        *lifecycle(4, end="deadline"), ("deadline_exceeded", 4),
        *lifecycle(5, end="oom"), ("set_watermark", 2),
        ("set_degraded", True), ("snap",), ("set_degraded", False),
        ("set_watermark", None), ("snap",)],
    "paged-pool": [
        ("snap",), ("set_kv_codec", "int8", 17408.0),
        ("set_pool_shard_mib", 123.456), ("snap",),
        ("set_pages", 32, 5, 12.345, 0, 0), ("snap",),
        *lifecycle(1), ("set_pages", 32, 0, 0.0, 0, 0),
        ("set_prefix_stats", 3, 1), ("snap",)],
    "drain": [*lifecycle(1), ("set_drain_state", True, False), ("snap",),
              ("set_drain_state", True, True), ("snap",),
              ("set_drain_state", False, False), ("snap",)],
    "spec-mesh-fleet": [("set_spec_stats", 0, 0, 0, 0), ("snap",),
                        ("set_spec_stats", 4, 12, 7, 11),
                        ("set_mesh", 2, 1), ("set_fleet_engine_id", 3),
                        ("snap",), ("set_fleet_engine_id", None), ("snap",)],
    "window-and-reset": [
        *lifecycle(1), ("t", 30.0), *lifecycle(2), ("t", 45.0), ("snap",),
        ("t", 61.0), ("snap",), ("set_spec_stats", 1, 2, 1, 2),
        ("set_pages", 8, 2, 0.0, 0, 0), ("reset",), ("snap",),
        *lifecycle(3)],
    "requeue-cancel-evict": [
        ("submitted", 1), ("submitted", 2), ("submitted", 3),
        ("requeued", 2), ("admit_start", 1), ("cancelled", 1),
        ("waited", 3), ("t", 0.5), ("waited", 3), ("first_token", 3),
        ("waited", 3), ("submitted", 4), ("submitted", 5), ("submitted", 6),
        ("retired", 4, 2, "completed"), ("retired", 9, 0),
        ("snap",)],
}


def drive(ops, clock, ours, ref):
    """Apply ``ops`` to both telemetries; returns the hook results and
    the snapshot pairs."""
    results, snaps = [], []
    for op, *args in ops:
        if op == "t":
            clock.t += args[0]
        elif op == "snap":
            snaps.append((ours.snapshot(), ref.snapshot()))
            results.append((ours.tokens_per_s(), ref.tokens_per_s()))
            results.append((ours.goodput_tokens_per_s(),
                            ref.goodput_tokens_per_s()))
            results.append((ours.pressure_view(), ref.pressure_view()))
        else:
            results.append((getattr(ours, op)(*args),
                            getattr(ref, op)(*args)))
    return results, snaps


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_snapshot_equals_reference(name):
    clock = FakeClock()
    max_pending = 2 if name == "requeue-cancel-evict" else 4096
    ours = telemetry.EngineTelemetry(clock=clock, max_pending=max_pending)
    ref = jtel.EngineTelemetry(clock=clock, max_pending=max_pending)
    results, snaps = drive(SCENARIOS[name], clock, ours, ref)
    for got, want in results:
        assert got == want
    assert snaps
    for got, want in snaps:
        assert set(got) - COMPILE_KEYS == set(want) - COMPILE_KEYS
        assert without_compiles(got) == without_compiles(want)
        assert COMPILE_KEYS <= set(got)
        assert got[consts.TELEMETRY_COMPILES] >= 0


def test_kernel_fallbacks_ride_the_snapshot_like_the_reference():
    ours = telemetry.EngineTelemetry()
    ref = jtel.EngineTelemetry()
    assert consts.TELEMETRY_KERNEL_FALLBACKS not in ours.snapshot()
    registry.record_fallback("paged", "cpu")
    registry.record_fallback("paged", "cpu")
    jregistry.record_fallback("paged", "cpu")
    jregistry.record_fallback("paged", "cpu")
    got, want = ours.snapshot(), ref.snapshot()
    assert got[consts.TELEMETRY_KERNEL_FALLBACKS] == \
        want[jconsts.TELEMETRY_KERNEL_FALLBACKS] == {"paged:cpu": 2}
    assert without_compiles(got) == without_compiles(want)


def test_compile_keys_count_kernel_builds(monkeypatch):
    """The compile pair is the port's kernel-build ratchet: a delta of
    ``build.BUILDS`` from the telemetry's start (and its reset)."""
    from tpushare_torch.workloads.kernels import build
    monkeypatch.setitem(build.BUILDS, "count", 5)
    monkeypatch.setitem(build.BUILDS, "seconds", 10.0)
    t = telemetry.EngineTelemetry()
    assert t.snapshot()[consts.TELEMETRY_COMPILES] == 0
    build.BUILDS["count"] += 2
    build.BUILDS["seconds"] += 3.25
    snap = t.snapshot()
    assert snap[consts.TELEMETRY_COMPILES] == 2
    assert snap[consts.TELEMETRY_COMPILE_SECONDS] == 3.25
    t.reset()
    assert t.snapshot()[consts.TELEMETRY_COMPILES] == 0


def test_snapshot_provider_matches_reference_contract():
    assert telemetry.current_snapshot() is None
    t = telemetry.EngineTelemetry().publish()
    assert telemetry.current_snapshot() == t.snapshot()

    def broken():
        raise RuntimeError("provider down")
    telemetry.set_snapshot_provider(broken)
    assert telemetry.current_snapshot() is None


def test_consts_equal_the_reference():
    names = [n for n in dir(consts)
             if n.startswith(("TELEMETRY_", "SLO_", "ENV_", "REJECT",
                              "SHED_", "STATUS_", "PRESSURE_ENGAGE",
                              "ERR_VISIBLE_DEVICES", "ERR_SERVING_MESH_"))
             or n in ("MIB", "GIB", "TERMINAL_STATUSES", "KERNEL_IMPLS",
                      "USAGE_TELEMETRY_KEY")]
    assert len(names) > 60
    from tpushare.workloads import overload as joverload
    from tpushare.workloads import profiling as jprofiling
    for n in names:
        # the reference keeps the statuses and reject policies in its
        # overload module, the trace directory's env in its profiler
        home = next(m for m in (jconsts, joverload, jprofiling)
                    if hasattr(m, n))
        assert getattr(consts, n) == getattr(home, n), n


GRID = [0.0, 0.05, 0.4, 0.9, 1.7, 2.5]


@pytest.mark.parametrize("policy", [(2.0, 0.1), (1.0, 0.05), (0.3, 0.5)])
def test_slo_attribute_equals_reference_over_a_grid(policy):
    ours, ref = slo.SLOPolicy(*policy), jslo.SLOPolicy(*policy)
    n = 0
    for q, a, p, d in itertools.product(GRID, repeat=4):
        for toks in (0, 1, 7):
            assert ours.attribute(q, a, p, d, toks) == \
                ref.attribute(q, a, p, d, toks)
            n += 1
    assert n == len(GRID) ** 4 * 3
    assert slo.SLOPolicy() == slo.SLOPolicy(jconsts.SLO_TTFT_S,
                                            jconsts.SLO_DECODE_PER_TOKEN_S)


def test_phase_reached_equals_reference():
    for flags in itertools.product((False, True), repeat=3):
        assert slo.phase_reached(*flags) == jslo.phase_reached(*flags)


def trace_shape(ring, trace_id):
    """Names, parent links (root or child) and attrs of a kept trace,
    in record order — everything but the clock."""
    spans = ring.trace(trace_id)
    root = next(s for s in spans if s.name == "request")
    return sorted((s.name, s.parent_id == root.span_id, s.process,
                   sorted(s.attrs.items()), s.end_ns >= s.start_ns)
                  for s in spans)


TRACE_CASES = [
    # marks reached, events, bumps, finish(status, violated, keep)
    ((), (), (), ("shed", None, True)),
    (("admit",), (), (), ("oom_quarantined", None, True)),
    (("admit", "prefill", "first"), (("route", {"member": 1}),),
     (("decode_chunks", 3), ("prefill_chunks", 1)),
     ("completed", "decode", True)),
    (("admit", "prefill", "first"), (), (("decode_chunks", 2),),
     ("completed", None, False)),
    (("admit", "prefill"), (), (), ("deadline_exceeded", None, True)),
]


@pytest.mark.parametrize("case", range(len(TRACE_CASES)))
def test_request_trace_keeps_and_shapes_spans_like_the_reference(case):
    marks, events, bumps, (st, violated, keep) = TRACE_CASES[case]
    ring, jring = tracing.TraceRing(), jtracing.TraceRing()
    attrs = {"prompt_len": 5, "max_new": 4}
    ours = tracing.RequestTrace(attrs=attrs, sampled=case % 2 == 0)
    ref = jtracing.RequestTrace(attrs=attrs, sampled=case % 2 == 0)
    for rt in (ours, ref):
        for m in marks:
            rt.mark(m)
        for name, ev in events:
            rt.event(name, **ev)
        for c, n in bumps:
            rt.bump(c, n)
    got = ours.finish(st, violated=violated, keep=keep, ring=ring)
    want = ref.finish(st, violated=violated, keep=keep, ring=jring)
    assert (got is None) == (want is None)
    assert ours.finish(st, ring=ring) is None       # idempotent
    assert ref.finish(st, ring=jring) is None
    if want is None:
        assert len(ring) == len(jring) == 0
        return
    assert got == ours.trace_id
    assert trace_shape(ring, got) == trace_shape(jring, want)
    assert ring.to_jsonl().count("\n") == jring.to_jsonl().count("\n")


def test_trace_ring_bounds_like_the_reference():
    ring = tracing.TraceRing(capacity=2, max_spans_per_trace=3)
    jring = jtracing.TraceRing(capacity=2, max_spans_per_trace=3)
    for r, mod in ((ring, tracing), (jring, jtracing)):
        tr = mod.Tracer("payload", ring=r)
        for tid in ("a", "b", "a", "c"):
            for i in range(4):
                tr.event(f"e{i}", tid)
        with pytest.raises(ValueError):
            with tr.span("boom", "c"):
                raise ValueError("x")
    assert ring.trace_ids() == jring.trace_ids() == ["a", "c"]
    for tid in ("a", "c"):
        assert [s.name for s in ring.trace(tid)] == \
            [s.name for s in jring.trace(tid)]
        assert [s.error for s in ring.trace(tid)] == \
            [s.error for s in jring.trace(tid)]
