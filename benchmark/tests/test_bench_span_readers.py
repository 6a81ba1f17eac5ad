"""The readers over the port's step spans (``benchmark/spans.py`` and the
metric files that use it) on hand-made exports: prefill chunks' device
time over their real tokens, decode dispatches that launched nothing
left out, microbatches summed into their step, and nothing read without
an export, from an incomplete one, or, for the device-timed ones, off
the card. Last, a real export from the port's engine and train step on
the CPU."""

import pytest

from benchmark import harness

MS = 1_000_000


def read(name, rec):
    return harness.metric_reader(name)(rec)


def span(name, start_ms, end_ms, trace="t0", sid=None, parent=None,
         **attrs):
    return {"name": name, "trace_id": trace, "span_id": sid or f"{name}@{start_ms}",
            "parent_id": parent, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "attrs": attrs}


def rec_of(kind, spans, device="cuda", complete=True):
    return {"kind": kind, "device": device,
            "program_spans": {"spans": spans, "complete": complete}}


def serve_spans():
    return [
        span("serve.admit_wave", 100, 300),
        span("serve.admit", 120, 290),
        span("serve.prefill_chunk", 130, 140, tokens=16, device_ms=4.0),
        span("serve.prefill_chunk", 140, 150, tokens=4, device_ms=2.0),
        span("serve.admit_wave", 500, 600),
        span("serve.admit", 510, 590),
        span("serve.prefill_chunk", 520, 526, tokens=10, device_ms=3.0),
        span("serve.decode_dispatch", 700, 712, steps=8, launched=True),
        span("serve.decode_dispatch", 800, 801, steps=1, launched=True),
        # a dispatch that launched nothing adds no step and no time
        span("serve.decode_dispatch", 900, 950, steps=8, launched=False),
    ]


def test_prefill_device_time_over_real_tokens():
    rec = rec_of("serve", serve_spans())
    assert read("prefill_device_ms_per_ktok.docqa", rec) == \
        pytest.approx(1e3 * 9.0 / 30)


def test_decode_host_time_over_launched_steps():
    rec = rec_of("serve", serve_spans())
    assert read("decode_host_ms_per_step.docqa", rec) == \
        pytest.approx((12 + 1) / 9)


def train_spans(accum=2):
    out = []
    for i, (fb, opt) in enumerate([((300, 320), 150), ((310, 330), 170),
                                   ((305, 400), 160)]):
        t = f"step{i}"
        out.append(span("train.step", 1000 * i, 1000 * i + 900, trace=t,
                        sid=f"r{i}"))
        for a in range(accum):
            out.append(span("train.loss_and_grads", 1000 * i + a,
                            1000 * i + a + 1, trace=t, parent=f"r{i}",
                            device_ms=float(fb[a] if a < len(fb) else 0)))
        out.append(span("train.optimizer_update", 1000 * i + 800,
                        1000 * i + 850, trace=t, parent=f"r{i}",
                        device_ms=float(opt)))
    return out


def test_train_halves_are_medians_of_per_step_sums():
    rec = rec_of("train", train_spans(accum=2))
    # per step 620, 640, 705 (microbatches summed): median 640
    assert read("fwd_bwd_ms.train", rec) == pytest.approx(640.0)
    assert read("adamw_ms.train", rec) == pytest.approx(160.0)
    rec = rec_of("train", train_spans(accum=1))
    assert read("fwd_bwd_ms.train", rec) == pytest.approx(305.0)


SPAN_METRICS = ["adamw_ms.train", "fwd_bwd_ms.train",
                "prefill_device_ms_per_ktok.docqa",
                "decode_host_ms_per_step.docqa"]
# the device-timed readers, by the span whose device time they read
DEVICE_TIMED = {"adamw_ms.train": "train.optimizer_update",
                "fwd_bwd_ms.train": "train.loss_and_grads",
                "prefill_device_ms_per_ktok.docqa": "serve.prefill_chunk"}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_read_without_a_complete_export(name):
    kind = "train" if name.endswith(".train") else "serve"
    docs = train_spans() if kind == "train" else serve_spans()
    assert read(name, rec_of(kind, docs)) is not None
    assert read(name, {"kind": kind, "device": "cuda"}) is None
    assert read(name, {"kind": kind, "device": "cuda",
                       "program_spans": None}) is None
    assert read(name, rec_of(kind, docs, complete=False)) is None
    other = "serve" if kind == "train" else "train"
    assert read(name, rec_of(other, docs)) is None
    if name not in DEVICE_TIMED:
        assert read(name, rec_of(kind, docs, device="cpu")) is not None
        return
    assert read(name, rec_of(kind, docs, device="cpu")) is None
    # one device-timed span without its time: nothing read
    timed = next(d for d in docs if d["name"] == DEVICE_TIMED[name])
    del timed["attrs"]["device_ms"]
    assert read(name, rec_of(kind, docs)) is None


def test_a_real_export_from_the_port_on_the_cpu():
    torch = pytest.importorskip("torch")
    from tpushare_torch import tracing
    from tpushare_torch.workloads import train
    from tpushare_torch.workloads.models import transformer as tt
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    from tpushare_torch.workloads.telemetry import set_snapshot_provider

    cfg = tt.TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=1,
                               d_ff=32, max_seq=64, dtype=torch.float32)
    g = torch.Generator()
    g.manual_seed(0)
    params = tt.init_params(g, cfg, device="cpu")
    tracing.stop_step_spans()
    tracing.start_step_spans()
    try:
        eng = PagedServingEngine(params, cfg, n_lanes=2, max_seq=64,
                                 n_pages=24, page_size=8,
                                 prompt_buckets=(8, 16), chunk=4)
        reqs = [Request(prompt=list(range(1, n + 1)), max_new=5)
                for n in (20, 7, 12)]
        for r in reqs:
            eng.submit(r)
        while not all(r.done for r in reqs):
            eng.step()
        serve_export = tracing.stop_step_spans()
        tracing.start_step_spans()
        opt = train.make_optimizer()
        state = train.init_state(params, opt)
        step = train.make_train_step(cfg, opt, device="cpu")
        x = torch.randint(0, cfg.vocab, (2, 9), generator=g)
        step(state, x[:, :-1], x[:, 1:])
        train_export = tracing.stop_step_spans()
    finally:
        tracing.stop_step_spans()
        set_snapshot_provider(None)
    srec = {"kind": "serve", "device": "cpu", "program_spans": serve_export}
    trec = {"kind": "train", "device": "cpu", "program_spans": train_export}
    assert read("decode_host_ms_per_step.docqa", srec) > 0
    # the device-timed readings stay unread off the card
    assert read("prefill_device_ms_per_ktok.docqa", srec) is None
    assert read("adamw_ms.train", trec) is None
    assert read("fwd_bwd_ms.train", trec) is None
