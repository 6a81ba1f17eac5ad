"""The port's step spans (``tracing.step_span``) inside the paged serving
engine and the train step: off, they record nothing and reach no
profile; on, each engine step and each train step is one trace with the
parent links and counters its phases promise, the outputs are bitwise
those of a run with spans off, the spans share the profiler's clock,
and a ring too small for the run says its export is incomplete. On the
card (``cuda``) the device-timed spans carry ``device_ms``.

The weights are the port's own (seeded ``init_params``): no reference
is needed, so this file imports no JAX."""

from __future__ import annotations

import statistics

import pytest

torch = pytest.importorskip("torch")

from tpushare_torch import tracing  # noqa: E402
from tpushare_torch.workloads import train  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request)

CFG = tt.TransformerConfig(vocab=128, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_seq=96, dtype=torch.float32)
# on the card: a head width the paged and flash kernels take
CARD_CFG = tt.TransformerConfig(vocab=128, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_seq=96,
                                dtype=torch.float32)
# two lanes for five requests: a wave stops on lanes; prompts past the
# largest bucket prefill in several chunks
ENGINE_KW = dict(n_lanes=2, max_seq=96, n_pages=40, page_size=8,
                 prompt_buckets=(8, 16), chunk=4)
PROMPTS = [(37, 6), (9, 3), (20, 5), (5, 4), (30, 2)]
B, S = 4, 16

# a span's parent, by name, as the engine and the train step nest them
PARENT = {"serve.step": None, "serve.admit_wave": "serve.step",
          "serve.admit": "serve.admit_wave",
          "serve.prefill_chunk": "serve.admit",
          "serve.page_install": "serve.admit",
          "serve.first_tokens": "serve.admit_wave",
          "serve.decode_dispatch": "serve.step",
          "serve.harvest": "serve.step",
          "train.step": None, "train.loss_and_grads": "train.step",
          "train.optimizer_update": "train.step"}


@pytest.fixture(autouse=True)
def _spans_off_and_one_thread():
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    tracing.stop_step_spans()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tracing.stop_step_spans()
    torch.set_num_threads(n)
    set_snapshot_provider(None)


def params_on(device, cfg):
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return tt.init_params(g, cfg, device=device)


def serve(device="cpu", cfg=CFG):
    """Every request of :data:`PROMPTS` through a fresh engine; returns
    (engine, requests, the number of ``step()`` calls)."""
    eng = PagedServingEngine(params_on(device, cfg), cfg, **ENGINE_KW)
    g = torch.Generator()
    g.manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,),
                                         generator=g).tolist(),
                    max_new=m) for n, m in PROMPTS]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
    return eng, reqs, steps


def train_steps(device="cpu", accum_steps=1, n=2, cfg=CFG):
    params = params_on(device, cfg)
    opt = train.make_optimizer()
    state = train.init_state(params, opt)
    step = train.make_train_step(cfg, opt, device=device,
                                 accum_steps=accum_steps)
    g = torch.Generator()
    g.manual_seed(2)
    for _ in range(n):
        x = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
        state, _ = step(state, x[:, :-1], x[:, 1:])
    return state


def recorded(run):
    """``run()`` with step spans on; (its result, the export)."""
    assert tracing.start_step_spans()
    try:
        out = run()
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        export = tracing.stop_step_spans()
    return out, export


def by_trace(spans):
    traces = {}
    for sp in spans:
        traces.setdefault(sp["trace_id"], []).append(sp)
    return traces


def check_links(spans):
    ids = {sp["span_id"]: sp for sp in spans}
    for sp in spans:
        want = PARENT[sp["name"]]
        if want is None:
            assert sp["parent_id"] is None
            continue
        parent = ids[sp["parent_id"]]
        assert parent["name"] == want
        assert parent["trace_id"] == sp["trace_id"]
        assert parent["start_ns"] <= sp["start_ns"] <= sp["end_ns"] \
            <= parent["end_ns"]


def named(spans, name):
    return [sp for sp in spans if sp["name"] == name]


def test_spans_off_record_nothing_and_reach_no_profile(monkeypatch):
    # off, a hook reads the switch and nothing else: no span, clock
    # read, record_function or event is made
    def refuse(*a, **k):
        raise AssertionError("a step span was made while spans are off")
    monkeypatch.setattr(tracing, "_StepSpan", refuse)
    monkeypatch.setattr(tracing, "_NamedSpan", refuse)
    monkeypatch.setattr(tracing.Tracer, "begin", refuse)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve()
        train_steps()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith(("serve.", "train.")) for n in names)
    assert tracing.stop_step_spans() is None


def test_engine_steps_are_traces_with_the_phases_counters():
    (eng, reqs, steps), export = recorded(serve)
    assert export["complete"]
    spans = export["spans"]
    check_links(spans)
    traces = by_trace(spans)
    # one trace a step, rooted at its serve.step
    assert len(traces) == steps
    for tr in traces.values():
        assert [sp["name"] for sp in tr if sp["parent_id"] is None] \
            == ["serve.step"]
    # five requests through two lanes: admitted over several waves, one
    # serve.admit and one page install each
    admits = named(spans, "serve.admit")
    assert len(admits) == len(named(spans, "serve.page_install")) \
        == len(reqs)
    ids = {sp["span_id"]: sp for sp in spans}
    admitting = {ids[a["parent_id"]]["span_id"] for a in admits}
    assert len(admitting) > 1
    # each wave that admitted reads its first tokens once
    firsts = named(spans, "serve.first_tokens")
    assert sorted(f["parent_id"] for f in firsts) == sorted(admitting)
    chunks = named(spans, "serve.prefill_chunk")
    assert len(chunks) == eng.stats["prefill_chunks"] > len(reqs)
    # the chunks' real tokens are the admitted prompts, padding left out
    assert sum(c["attrs"]["tokens"] for c in chunks) == \
        sum(len(r.prompt) for r in reqs)
    # off the card a device-timed span carries no device time
    assert not any("device_ms" in c["attrs"] for c in chunks)
    launched = [d for d in named(spans, "serve.decode_dispatch")
                if d["attrs"]["launched"]]
    assert len(launched) == eng.stats["chunks"]
    assert len(named(spans, "serve.harvest")) == len(launched)


def test_decode_dispatch_steps_are_the_chunks_launched(monkeypatch):
    # steps and launched at each dispatch: the chunk's steps as the
    # engine asked for them, and whether a chunk went out
    seen = []
    dispatch = PagedServingEngine._dispatch

    def spy(self, n):
        out = dispatch(self, n)
        seen.append((n, out is not None))
        return out
    monkeypatch.setattr(PagedServingEngine, "_dispatch", spy)
    _, export = recorded(serve)
    disp = sorted(named(export["spans"], "serve.decode_dispatch"),
                  key=lambda d: d["start_ns"])
    assert [(d["attrs"]["steps"], d["attrs"]["launched"]) for d in disp] \
        == seen
    assert any(launched for _, launched in seen)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_steps_are_traces_of_their_halves(accum_steps):
    _, export = recorded(lambda: train_steps(accum_steps=accum_steps))
    assert export["complete"]
    spans = export["spans"]
    check_links(spans)
    traces = by_trace(spans)
    assert len(traces) == 2
    for tr in traces.values():
        assert len(named(tr, "train.step")) == 1
        assert len(named(tr, "train.loss_and_grads")) == accum_steps
        assert len(named(tr, "train.optimizer_update")) == 1


@pytest.mark.parametrize("what", ["serve", "train"])
def test_outputs_are_bitwise_with_spans_on_and_off(what):
    if what == "serve":
        _, off, _ = serve()
        (_, on, _), _ = recorded(serve)
        assert [r.output for r in on] == [r.output for r in off]
        assert [r.logprobs for r in on] == [r.logprobs for r in off]
        return
    off = train_steps()
    on, _ = recorded(train_steps)
    for tree in ("params",):
        for a, b in zip(train.tree_leaves(on[tree]),
                        train.tree_leaves(off[tree])):
            assert torch.equal(a, b)
    for moment in ("mu", "nu"):
        for a, b in zip(train.tree_leaves(on["opt"][moment]),
                        train.tree_leaves(off["opt"][moment])):
            assert torch.equal(a, b)
    assert on["opt"]["count"] == off["opt"]["count"] == 2


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, export = recorded(lambda: (serve(), train_steps()))
    events: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("serve.", "train.")):
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    spans = export["spans"]
    assert {sp["name"] for sp in spans} == set(events)
    starts, ends = [], []
    for name, evs in events.items():
        mine = sorted((sp["start_ns"], sp["end_ns"])
                      for sp in named(spans, name))
        assert len(mine) == len(evs)
        for (s0, s1), (e0, e1) in zip(mine, sorted(evs)):
            # each profiler event lies within its span: on two clocks an
            # offset of more than the few microseconds between a span's
            # edge and its record_function would put events outside
            assert s0 <= e0 and e1 <= s1
            starts.append(e0 - s0)
            ends.append(s1 - e1)
    # and close to its edges: within 1 ms at the median edge (a host that
    # deschedules the process between an edge and its record_function
    # parts a single pair by its time slice, 4 ms under a loaded runner)
    assert statistics.median(starts) <= 1_000_000
    assert statistics.median(ends) <= 1_000_000


@pytest.mark.parametrize("cap", ["traces", "spans"])
def test_a_ring_too_small_reports_its_export_incomplete(cap, monkeypatch):
    if cap == "spans":
        monkeypatch.setattr(tracing.StepSpans, "MAX_SPANS_PER_TRACE", 3)
    assert tracing.start_step_spans(capacity=2 if cap == "traces" else 64)
    # on already: a second switch changes nothing
    assert not tracing.start_step_spans()
    serve()
    export = tracing.stop_step_spans()
    assert export is not None and not export["complete"]
    assert tracing.stop_step_spans() is None


def test_a_span_that_raises_carries_its_error():
    tracing.start_step_spans()
    with pytest.raises(ValueError):
        with tracing.step_span("train.step", root=True):
            with tracing.step_span("train.optimizer_update"):
                raise ValueError("boom")
    export = tracing.stop_step_spans()
    assert export["complete"]
    errs = {sp["name"]: sp.get("error") for sp in export["spans"]}
    assert errs == {"train.step": "ValueError: boom",
                    "train.optimizer_update": "ValueError: boom"}


def test_the_profiling_region_turns_spans_on_and_drops_them(tmp_path,
                                                           monkeypatch):
    import json
    import os

    from tpushare_torch.workloads import profiling

    # the region only names the profile: no span, ring or event is made
    def refuse(*a, **k):
        raise AssertionError("the profiling region recorded a span")
    monkeypatch.setattr(tracing, "_StepSpan", refuse)
    monkeypatch.setattr(tracing.Tracer, "begin", refuse)
    with profiling.trace(str(tmp_path / "tb"), block=False):
        assert tracing.step_span("train.step") is not tracing.NO_SPAN
        train_steps(n=1)
    assert tracing.step_span("train.step") is tracing.NO_SPAN
    f, = os.listdir(tmp_path / "tb")
    doc = json.loads((tmp_path / "tb" / f).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"train.step", "train.loss_and_grads",
            "train.optimizer_update"} <= names
    # spans a caller turned on outlive the region
    monkeypatch.undo()
    tracing.start_step_spans()
    with profiling.trace(str(tmp_path / "tb2"), block=False):
        pass
    assert tracing.stop_step_spans() is not None


def test_names_only_spans_nest_in_the_profile_and_bind_none():
    from torch.profiler import ProfilerActivity, profile
    assert tracing.start_step_spans(record=False)
    with tracing.step_span("train.step", root=True) as sp:
        assert sp is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (eng, reqs, steps) = serve()
    # nothing was recorded to export
    assert tracing.stop_step_spans() is None
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("serve.")]
    count = {}
    for e in events:
        count[e.name()] = count.get(e.name(), 0) + 1
    assert count["serve.step"] == steps
    assert count["serve.admit"] == count["serve.page_install"] == len(reqs)
    assert count["serve.prefill_chunk"] == eng.stats["prefill_chunks"]
    # each phase's event lies inside a step's
    outer = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.name() == "serve.step")
    for e in events:
        assert any(s0 <= e.start_ns() <= e.end_ns() <= s1
                   for s0, s1 in outer)


@pytest.mark.cuda
def test_device_timed_spans_carry_device_ms_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the device")
    dev = torch.device("cuda")
    (_, reqs, _), export = recorded(lambda: serve(dev, CARD_CFG))
    assert export["complete"] and all(r.done for r in reqs)
    chunks = named(export["spans"], "serve.prefill_chunk")
    assert chunks and all(c["attrs"]["device_ms"] > 0 for c in chunks)
    # host-only spans carry none
    assert not any("device_ms" in sp["attrs"] for sp in export["spans"]
                   if sp["name"] != "serve.prefill_chunk")
    _, export = recorded(lambda: train_steps(dev, accum_steps=2,
                                             cfg=CARD_CFG))
    assert export["complete"]
    for name, n in (("train.loss_and_grads", 4),
                    ("train.optimizer_update", 2)):
        got = named(export["spans"], name)
        assert len(got) == n and all(s["attrs"]["device_ms"] > 0
                                     for s in got)
