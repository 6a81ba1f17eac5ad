"""Metric readers on hand-made records: rates are window totals,
percentiles are taken over every request (missing ones included), and
device numbers are read only from a run on the card."""

import math

import pytest

from benchmark import harness
from benchmark.harness import percentile
from benchmark.trace import kernel_time, summarize

M = {"vocab": 100, "d_model": 8, "n_heads": 2, "kv_heads": 1,
     "head_dim": 4, "n_layers": 2, "d_ff": 16}


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_percentile_nearest_rank_hand_cases():
    assert percentile([5.0], 90) == 5.0
    assert percentile(list(range(1, 11)), 90) == 9
    assert percentile(list(range(1, 11)), 50) == 5
    assert percentile(list(range(1, 101)), 90) == 90
    assert percentile([3, 1, 2], 100) == 3
    assert percentile(list(range(1, 12)), 90) == 10    # ceil(9.9) = 10th


def serve_rec(ttfts, device="cpu", span=20.0):
    reqs = [{"prompt": [1] * 10, "output": [2] * 4, "due_s": float(i),
             "ttft_s": t, "queue_s": None if t is None else t / 2}
            for i, t in enumerate(ttfts)]
    return {"kind": "serve", "m": M, "requests": reqs, "span_s": span,
            "device": device, "trace": None,
            "waves": [(0.0, 0.5, 1000), (1.0, 1.25, 1000)],
            "chunks": [(0.0, 0.1, 8), (1.0, 1.3, 16), (2.0, 2.0, 0)],
            "k5": {"bytes": 0, "ops": 0, "steps": 0}}


def test_ttft_p90_over_every_request():
    rec = serve_rec([0.1 * i for i in range(1, 11)])
    assert read("ttft_p90_ms", rec) == pytest.approx(900.0)
    assert read("queue_wait_p90_ms.docqa", rec) == pytest.approx(450.0)


def test_missing_request_counts_as_waiting_until_the_end():
    # nine answered fast; the tenth never got a token: it waited from its
    # due instant (9 s) until the run stopped (20 s)
    rec = serve_rec([0.1] * 9 + [None])
    assert read("ttft_p90_ms", rec) == pytest.approx(100.0)
    # two missing (due at 8 s and 9 s): waits of 12 s and 11 s; the 90th
    # percentile of ten is the ninth smallest
    rec = serve_rec([0.1] * 8 + [None, None])
    assert read("ttft_p90_ms", rec) == pytest.approx(1e3 * (20.0 - 9.0))


def test_prefill_and_decode_are_window_totals():
    rec = serve_rec([0.1])
    # 0.75 s of admission waves over 2000 prompt tokens
    assert read("prefill_ms_per_ktok.docqa", rec) == pytest.approx(375.0)
    # 0.4 s of decode chunks over 24 kept tokens
    assert read("decode_ms_per_token.docqa", rec) == pytest.approx(400 / 24)


def test_train_rate_is_every_step_over_the_window():
    rec = {"kind": "train", "steps": 7, "tokens_per_step": 4096,
           "window_s": 10.5, "device": "cpu"}
    assert read("train_tokens_per_s", rec) == pytest.approx(7 * 4096 / 10.5)
    assert read("ttft_p90_ms", rec) is None
    assert read("train_tokens_per_s", serve_rec([1.0])) is None


DEVICE_METRICS = ["peak_hbm_gib", "serve_mfu.docqa", "k5_roofline.docqa",
                  "device_idle.docqa", "step_mfu.train", "k6_roofline.train",
                  "device_idle.train"]


@pytest.mark.parametrize("name", DEVICE_METRICS)
def test_device_metrics_refuse_without_a_card(name):
    trace = {"window_s": 1.0, "busy_s": 0.5, "kernels": {
        "splash_fwd_mma": (0.1, 2), "paged_partial_kernel": (0.1, 2)},
        "breakdown": {}}
    for rec in (serve_rec([0.1]), {"kind": "train", "steps": 2,
                                   "window_s": 1.0, "m": M,
                                   "mix": {"batch": 1, "seq": 8}}):
        rec.update(device="cpu", trace=trace, peak_bytes=2 ** 30)
        rec["k5"] = {"bytes": 10 ** 6, "ops": 10 ** 6, "steps": 1}
        assert read(name, rec) is None


def test_device_metrics_on_a_card_record():
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "kernels": {"void splash_fwd_mma<128>": (0.002, 4),
                         "void paged_partial_kernel<x>": (0.001, 10),
                         "sgemm": (1.0, 9)}, "breakdown": {}}
    rec = {"kind": "train", "steps": 3, "window_s": 2.0, "m": M,
           "mix": {"batch": 1, "seq": 8}, "device": "cuda", "trace": trace,
           "peak_bytes": 3 * 2 ** 30, "trace_launches": {"splash_fwd": 4}}
    assert read("device_idle.train", rec) == pytest.approx(25.0)
    assert read("peak_hbm_gib", rec) == pytest.approx(3.0)
    from benchmark import roofline as R
    want = 100 * 4 * R.bound_s(R.attn_fwd_ops(1, 2, 8, 4),
                               R.attn_fwd_bytes(1, 2, 1, 8, 4, lse=True))[0]
    assert read("k6_roofline.train", rec) == pytest.approx(want / 0.002)
    # a profile that saw fewer launches than the port counted reads nothing
    short = {**rec, "trace_launches": {"splash_fwd": 5}}
    assert read("k6_roofline.train", short) is None
    flops = 3 * R.train_step_flops(M, 1, 8)
    assert read("step_mfu.train", rec) == pytest.approx(
        100 * flops / 989e12 / 2.0)


def test_trace_summary_busy_gaps_and_labels():
    dev = [(100, 200, "k1"), (150, 250, "k2"), (400, 450, "k1"),
           (50, 60, "before-window")]
    cpu = [(90, 700, "bench.window"), (90, 700, "bench.train_step"),
           (240, 420, "aten::item"), (460, 690, "aten::copy_")]
    s = summarize(dev, cpu, "bench.window")
    assert s["window_s"] == pytest.approx(610e-6)
    assert s["busy_s"] == pytest.approx(200e-6)          # [100,250]+[400,450]
    assert kernel_time(s, "k1") == (pytest.approx(150e-6), 2)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # gaps [90,100], [250,400], [450,700], each named by what the host
    # ran when it opened
    assert gaps["bench.train_step > aten::item"] == pytest.approx(150e-6)
    assert gaps["bench.train_step"] == pytest.approx(260e-6)
    assert s["breakdown"]["device_ops"][0][0] == "k1"
    assert not any(math.isnan(v) for _, v in s["breakdown"]["device_ops"])


def test_trace_summary_over_a_named_slice():
    """A run that names a slice of its recording is read over the slice:
    busy, idle, the kernels and the breakdown."""
    dev = [(100, 200, "k1"), (300, 380, "k1"), (500, 600, "k2")]
    cpu = [(0, 700, "bench.window"), (250, 450, "bench.slice"),
           (260, 440, "aten::mm")]
    s = summarize(dev, cpu, "bench.slice")
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(80e-6)
    assert kernel_time(s, "k1") == (pytest.approx(80e-6), 1)
    assert kernel_time(s, "k2") == (0.0, 0)
    assert s["breakdown"]["device_ops"] == [["k1", pytest.approx(80e-6)]]
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == {"bench.window": pytest.approx(50e-6),
                    "bench.window > aten::mm": pytest.approx(70e-6)}


def test_trace_kernels_go_by_their_launch_instant():
    """A kernel launched in the window counts for it even where the
    device's clock places it past the window's end; one launched before
    the window does not, though it ran inside."""
    dev = [(440, 460, "k5", 430), (260, 300, "k5", 200), (300, 320, "k9", None)]
    cpu = [(0, 700, "bench.window"), (250, 450, "bench.slice")]
    s = summarize(dev, cpu, "bench.slice")
    assert kernel_time(s, "k5") == (pytest.approx(20e-6), 1)
    assert kernel_time(s, "k9") == (pytest.approx(20e-6), 1)
    assert s["busy_s"] == pytest.approx(70e-6)
