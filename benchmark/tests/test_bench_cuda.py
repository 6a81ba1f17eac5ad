"""On the card: the device trace reads the card, and both drivers run
their whole path through the port's kernels at a small size with the
per-layer metrics read. Skips inside each test without a card; run on
the card with ``python -m pytest benchmark/tests -m cuda``."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.run import run_workload

pytestmark = pytest.mark.cuda

# head_dim 128 and S = 4096: the shape splash (K6) serves
SMALL_MHA = {"vocab": 1024, "d_model": 256, "n_heads": 2, "kv_heads": 2,
             "head_dim": 128, "n_layers": 2, "d_ff": 512, "rope_theta": 1e4,
             "rms_eps": 1e-6, "dtype": torch.bfloat16}
# eight heads over two KV heads: K5 at group 4, as the cell's read
SMALL_GQA = {**SMALL_MHA, "d_model": 1024, "n_heads": 8, "rope_theta": 1e6}


def test_device_trace_reads_the_card(card):
    from benchmark.trace import DeviceTrace
    a = torch.randn(2048, 2048, device=card)
    with DeviceTrace() as t:
        for _ in range(10):
            a = a @ a
            a = a / a.norm()
    s = t.summary()
    assert 0 < s["busy_s"] <= s["window_s"] * 1.001
    assert s["breakdown"]["device_ops"]


def test_train_cell_path_on_the_card(card):
    bench = harness.load_benchmark()
    result, rec = run_workload(
        "deepseek7b-train-s4096", 2 ** 31 + 5, 2.0, True, device="cuda",
        t_start=time.perf_counter(),
        overrides={"m": SMALL_MHA, "mix": {"batch": 1, "seq": 4096},
                   "cell": {"trace": {"start_s": 0.5}}})
    assert result["correct"], result["checks"]
    assert rec["launches"].get("splash_fwd", 0) >= 2 * rec["steps"]
    want = {m["name"] for m in harness.cell_metrics(
        bench, "deepseek7b-train-s4096", trace=True)}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)


def test_serve_cell_path_on_the_card(card):
    result, rec = run_workload(
        "mistral7b-docqa", 2 ** 31 + 6, 4.0, True, device="cuda",
        t_start=time.perf_counter(),
        overrides={"m": SMALL_GQA,
                   "cell": {"engine": {"n_lanes": 8, "max_seq": 1024,
                                       "n_pages": 257,
                                       "prompt_buckets": [64, 128, 256],
                                       "chunk": 4},
                            "rate_rps": 4.0, "check": {"sample_tokens": 32},
                            "trace": {"slice_s": [1.0, 3.0]}},
                   "mix": {"prompt": {"median": 256, "min": 64, "max": 768},
                           "answer": {"median": 16, "min": 8, "max": 32}}})
    assert result["correct"], result["checks"]
    assert rec["launches"].get("paged_decode", 0) > 0
    assert "k5_roofline.docqa" in result["metrics"]
    assert 0 < result["metrics"]["k5_roofline.docqa"]["value"] <= 105
    # the trace is read over the slice alone
    assert rec["trace"]["window_s"] == pytest.approx(2.0, abs=0.6)
    assert 0 < rec["trace"]["busy_s"] <= rec["trace"]["window_s"]
