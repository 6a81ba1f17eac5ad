"""The port's seeded traffic held against the reference's: ``generate``
gives the reference's JSONL byte for byte for every scenario at three
seeds, traces round-trip through ``save_trace`` / ``load_trace``, and
``replay`` over both port engines (tiny f32 model on the CPU, weights
bridged from the reference's ``init_params``) brings every offered
request to exactly one terminal status."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import traffic as jtraffic  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, overload, traffic  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, ServingEngine)
from tpushare_torch.workloads.slo import SLOPolicy  # noqa: E402

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes: one intra-op
    thread keeps these tiny models' many small ops from oversubscribing
    the cores (each op otherwise waits on every pool thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return bridge.params_from_numpy(
        jax.tree.map(np.asarray, jt.init_params(jax.random.key(0), JCFG)),
        device="cpu")


@pytest.fixture(autouse=True)
def _clear_telemetry_provider():
    yield
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    set_snapshot_provider(None)


def jsonl(events) -> str:
    return "".join(ev.to_json() + "\n" for ev in events)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("scenario", sorted(jtraffic.SCENARIOS))
def test_generate_is_byte_identical_to_the_reference(scenario, seed):
    kw = dict(seed=seed, duration_s=20.0, rate_rps=3.0)
    ours = traffic.generate(scenario, **kw)
    ref = jtraffic.generate(scenario, **kw)
    assert ours
    assert jsonl(ours) == jsonl(ref)


def test_generate_refuses_unknown_scenarios_like_the_reference():
    assert sorted(traffic.SCENARIOS) == sorted(jtraffic.SCENARIOS)
    with pytest.raises(ValueError, match="scenario"):
        traffic.generate("nope", seed=0)


def test_trace_round_trips_and_reads_reference_files(tmp_path):
    events = traffic.generate("adversarial", seed=3, duration_s=8.0)
    path = traffic.save_trace(events, str(tmp_path / "t.jsonl"))
    assert traffic.load_trace(path) == events
    ref_path = jtraffic.save_trace(
        jtraffic.generate("adversarial", seed=3, duration_s=8.0),
        str(tmp_path / "ref.jsonl"))
    assert open(ref_path).read() == open(path).read()
    assert traffic.load_trace(ref_path) == events


def assert_accounted(report, events, eng):
    terminal = sum(report["statuses"].values())
    assert report["offered"] == terminal > 0
    assert report["offered"] + report["skipped_dependents"] == len(events)
    assert set(report["statuses"]) <= set(overload.TERMINAL_STATUSES)
    s = eng.stats
    assert (s["completed"] + s["shed"] + s["deadline_exceeded"]
            + s["oom_quarantined"]) == terminal
    assert report["slo_good"] + report["slo_violations_total"] == terminal
    assert not eng.queue and not eng.running


@pytest.mark.parametrize("scenario", ["bursty", "agentic", "chat"])
def test_replay_on_the_slot_engine_accounts_every_request(params, scenario):
    eng = ServingEngine(params, CFG, n_slots=2, max_seq=256,
                        prompt_buckets=(16, 64), chunk=4, queue_limit=6)
    events = traffic.generate(scenario, seed=0, duration_s=6.0,
                              rate_rps=2.0)
    traffic.set_slo(eng, SLOPolicy(ttft_s=0.05, decode_per_token_s=0.01))
    report = traffic.replay(eng, events, time_scale=0.01,
                            vocab=CFG.vocab, max_wall_s=60.0)
    assert_accounted(report, events, eng)
    if scenario == "chat":
        assert set(eng.prefixes) == {"sys0", "sys1"}


@pytest.mark.parametrize("kv_codec", ["bf16", "int8"])
@pytest.mark.parametrize("scenario", ["bursty", "agentic"])
def test_replay_on_the_paged_engine_accounts_every_request(params, scenario,
                                                           kv_codec):
    eng = PagedServingEngine(params, CFG, n_lanes=3, max_seq=128, n_pages=24,
                             page_size=8, prompt_buckets=(16, 64), chunk=4,
                             kv_codec=kv_codec,
                             admission=overload.AdmissionController(3))
    events = traffic.generate(scenario, seed=0, duration_s=6.0,
                              rate_rps=2.0)
    report = traffic.replay(eng, events, time_scale=0.01, vocab=CFG.vocab,
                            max_wall_s=60.0)
    assert_accounted(report, events, eng)
    snap = eng.telemetry.snapshot()
    assert snap[consts.TELEMETRY_KV_CODEC] == kv_codec
    assert snap[consts.TELEMETRY_PAGES_IN_USE] == 0
    assert eng.alloc.leaked() == 0
