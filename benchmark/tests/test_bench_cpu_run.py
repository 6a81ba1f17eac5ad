"""The harness's whole run at a tiny size on the CPU: the port's timed
path under the cell's own limits comes out correct, and comes out not
correct when the timed path is broken underneath (the faults a cell
can have) or when the control — the reference computed with fp8
operands — stands in the program's place. Device numbers stay unread
without a card. A tiny model here stands for the cell's, so the limits
are the cell files' own."""

import time

import pytest
import torch

from benchmark import checks, harness, model, traffic
from benchmark.run import run_workload

TRAIN = "deepseek7b-train-s4096"
SERVE = "mistral7b-docqa"
SEED = 2 ** 31 + 99

TINY_MHA = {"vocab": 256, "d_model": 64, "n_heads": 4, "kv_heads": 4,
            "head_dim": 16, "n_layers": 2, "d_ff": 128, "rope_theta": 1e4,
            "rms_eps": 1e-6, "dtype": torch.bfloat16}
TINY_GQA = {**TINY_MHA, "kv_heads": 2, "rope_theta": 1e6}
TRAIN_OV = {"m": TINY_MHA, "mix": {"batch": 1, "seq": 64}}
SERVE_OV = {"m": TINY_GQA,
            "cell": {"engine": {"n_lanes": 4, "max_seq": 256, "n_pages": 33,
                                "prompt_buckets": [16, 32, 64], "chunk": 4},
                     "rate_rps": 6.0, "drain_seconds": 30,
                     "check": {"sample_tokens": 24}},
            "mix": {"prompt": {"median": 48, "min": 16, "max": 160},
                    "answer": {"median": 8, "min": 4, "max": 12}}}


def train_run(seconds=0.3):
    return run_workload(TRAIN, SEED, seconds, False, device="cpu",
                        t_start=time.perf_counter(), overrides=TRAIN_OV)


def serve_run(seconds=1.5):
    return run_workload(SERVE, SEED, seconds, False, device="cpu",
                        t_start=time.perf_counter(), overrides=SERVE_OV)


def test_train_run_is_correct_and_reads_no_device_number():
    result, rec = train_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] == rec["steps"] >= 1
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert rec["launches"] == {}                    # no kernel off the card


def test_train_state_left_unchanged_is_caught(monkeypatch):
    import tpushare_torch.workloads.train as port

    def no_update(self, grads, state, params):
        state["count"] += 1
    monkeypatch.setattr(port.AdamW, "update", no_update)
    result, rec = train_run()
    assert not result["correct"]
    assert rec["numbers"]["change_norm_gap"] == pytest.approx(1.0)


def test_train_half_batch_is_caught(monkeypatch):
    import tpushare_torch.workloads.train as port
    from tpushare_torch.workloads.models.transformer import forward
    sound = port.loss_and_grads

    def half_loss(params, inputs, targets, cfg):
        S = targets.shape[1]
        logp = torch.log_softmax(forward(params, inputs, cfg)[:, :S // 2], -1)
        return -logp.gather(-1, targets[:, :S // 2, None]).mean()
    monkeypatch.setattr(port, "loss_and_grads",
                        lambda p, i, t, cfg: sound(p, i, t, cfg,
                                                   loss_of=half_loss))
    result, _ = train_run()
    assert not result["correct"], result["checks"]


def test_train_control_fails_a_limit():
    from benchmark.drivers import train as drv
    cell = harness.load_cell(TRAIN)
    mix = {**traffic.load_mix(cell["traffic"]), **TRAIN_OV["mix"]}
    ctx = {"cell": cell, "m": TINY_MHA, "mix": mix, "seed": SEED,
           "traffic": traffic.generator(mix), "device": "cpu"}

    def batch(k):
        return ctx["traffic"].make_batch(mix, SEED, k, TINY_MHA["vocab"],
                                         "cpu")
    ref = drv.reference(ctx, batch)
    ctl = drv.reference(ctx, batch, prec="fp8")
    numbers = checks.train_numbers(ctl, ref)
    judged = harness.judge(numbers, cell["limits"])
    assert not all(c["ok"] for c in judged.values()), judged


def test_serve_run_is_correct_and_reads_no_device_number():
    result, rec = serve_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] == len(rec["requests"]) > 3
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"ttft_p90_ms", "setup_s"}
    assert rec["numbers"]["_sampled_tokens"] >= 24
    assert rec["waves"] and rec["chunks"]
    pool = rec["pool"]
    assert 0 < pool["peak_pages_in_use"] <= pool["pages"] == 32
    assert 1 <= pool["peak_running_lanes"] <= pool["lanes"] == 4


def test_serve_logprob_shifted_is_caught(monkeypatch):
    """The right token with a wrong logprob (a normaliser off by a
    constant) fails the logprob comparison alone."""
    import tpushare_torch.workloads.serving as port
    sound = port._sample_rows

    def shifted(logits, *a, **k):
        nxt, lp = sound(logits, *a, **k)
        return nxt, lp - 1.0
    monkeypatch.setattr(port, "_sample_rows", shifted)
    result, _ = serve_run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["logit_gap"]["ok"]
    assert not result["checks"]["logprob_gap"]["ok"]


def test_serve_token_altered_is_caught(monkeypatch):
    import tpushare_torch.workloads.serving as port
    sound = port._sample_rows

    def altered(logits, *a, **k):
        nxt, lp = sound(logits, *a, **k)
        return (nxt + 1) % logits.shape[-1], lp
    monkeypatch.setattr(port, "_sample_rows", altered)
    result, _ = serve_run()
    assert not result["correct"], result["checks"]


def test_serve_step_leaving_state_unchanged_is_caught(monkeypatch):
    import tpushare_torch.workloads.serving as port
    sound = port._paged_step

    def stuck(params, state, *a, **k):
        lengths, tokens = state["lengths"], state["tokens"]
        out = sound(params, state, *a, **k)
        state["lengths"], state["tokens"] = lengths, tokens
        return out
    monkeypatch.setattr(port, "_paged_step", stuck)
    result, _ = serve_run()
    assert not result["correct"], result["checks"]


def test_serve_control_fails_the_limit():
    from benchmark.reference.serve import served_gaps
    cell = harness.load_cell(SERVE)
    result, rec = serve_run()
    done = [r for r in rec["requests"] if r["completed"]]
    gaps = served_gaps(SEED, TINY_GQA,
                       [(r["prompt"], r["output"], r["logprobs"])
                        for r in done[:6]], "cpu", control=True)
    assert max(g["control_gap"] for g in gaps) > cell["limits"]["logit_gap"]


def test_config_dims_are_the_published_ones():
    m = model.dims(model.load_config("mistral-7b-v0.3"))
    assert (m["vocab"], m["d_model"], m["n_heads"], m["kv_heads"],
            m["head_dim"], m["n_layers"], m["d_ff"]) == \
        (32768, 4096, 32, 8, 128, 32, 14336)
    m = model.dims(model.load_config("deepseek-llm-7b"))
    assert (m["vocab"], m["kv_heads"], m["n_layers"], m["d_ff"]) == \
        (102400, 32, 30, 11008)
    # Mistral's file keeps the published eps and names the departure; the
    # run and the reference use the port's value
    mistral = model.load_config("mistral-7b-v0.3")
    assert mistral["rms_norm_eps"] == 1e-5 and mistral["reduced"] == []
    assert model.dims(mistral)["rms_eps"] == model.PORT_RMS_EPS
    with pytest.raises(ValueError):
        model.dims({**mistral, "departures": []})
