"""The port's block-paged serving engine, mirroring the reference's
``tests/test_paged_serving.py`` on the CPU: token identity against the
port's offline ``generate`` and against the JAX ``PagedServingEngine``
(f32, greedy, bridged weights), a request joining mid-wave, pool
exhaustion deferring admission, a never-fitting request shed, and no
leaked pages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, overload  # noqa: E402
from tpushare_torch.workloads.decode import generate  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request)

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")


@pytest.fixture(autouse=True)
def _clear_telemetry_provider():
    yield
    from tpushare.workloads.telemetry import set_snapshot_provider
    set_snapshot_provider(None)


def offline(prompt, steps):
    out = generate(PARAMS, torch.tensor([prompt]), CFG, steps)
    return out[0].tolist()


def rand_prompt(seed, n):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, CFG.vocab, n)]


ENGINE_KW = dict(n_lanes=3, max_seq=64, n_pages=25, page_size=8,
                 prompt_buckets=(8, 32), chunk=4)


def paged(**kw):
    return PagedServingEngine(PARAMS, CFG, **{**ENGINE_KW, **kw})


def assert_no_leaks(eng):
    assert eng.alloc.pages_in_use() == 0
    assert eng.alloc.leaked() == 0
    assert eng.alloc.free_pages() == eng.alloc.usable_pages


def test_paged_engine_matches_offline_and_reference_engine():
    """More requests than lanes, varied lengths, pages recycled between
    waves: every output equals the port's offline decode AND the JAX
    paged engine's transcript on the same weights."""
    mk = lambda cls: [cls(prompt=rand_prompt(10 + i, 5 + 3 * i),  # noqa: E731
                          max_new=6 + 2 * i) for i in range(5)]
    reqs, jreqs = mk(Request), mk(jserving.Request)
    eng = paged()
    jeng = jserving.PagedServingEngine(JPARAMS, JCFG, **ENGINE_KW)
    assert eng.attn_impl == "xla"   # CPU tensors: the gather twin
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.status == overload.STATUS_COMPLETED
        assert r.output == offline(r.prompt, r.max_new)
        assert r.output == jr.output
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-4)
    assert_no_leaks(eng)
    assert eng.stats["completed"] == 5
    assert 0 < eng.lane_efficiency() <= 1


def test_continuous_admission_joins_mid_wave_token_exact():
    first = [Request(prompt=rand_prompt(60 + i, 6), max_new=24)
             for i in range(2)]
    eng = paged()
    for r in first:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert len(eng.running) == 2 and all(not r.done for r in first)
    late = Request(prompt=rand_prompt(70, 5), max_new=8)
    eng.submit(late)
    eng.step()
    assert len(eng.running) == 3
    assert eng.stats["peak_running"] == 3
    eng.run()
    for r in first + [late]:
        assert r.output == offline(r.prompt, r.max_new)
    assert_no_leaks(eng)


def test_pool_exhaustion_defers_admission_not_deadlock():
    eng = paged(n_pages=8, n_lanes=3)   # 7 usable pages, 8 rows each
    reqs = [Request(prompt=rand_prompt(90 + i, 6), max_new=20)
            for i in range(4)]          # each forecasts 4 pages
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert len(eng.running) == 1 and len(eng.queue) == 3   # deferred
    eng.run()
    for r in reqs:
        assert r.status == overload.STATUS_COMPLETED
        assert r.output == offline(r.prompt, r.max_new)
    assert_no_leaks(eng)
    assert eng.stats["page_evictions"] == 0


def test_never_fitting_request_is_shed_terminally():
    eng = paged(n_pages=4, n_lanes=2)   # 3 usable pages = 24 rows
    giant = Request(prompt=rand_prompt(95, 6), max_new=50)  # needs 7 pages
    small = Request(prompt=rand_prompt(96, 5), max_new=6)
    eng.submit(giant)
    eng.submit(small)
    eng.run()
    assert giant.status == consts.STATUS_SHED and giant.output == []
    assert small.status == consts.STATUS_COMPLETED
    assert eng.stats["shed"] == 1
    assert_no_leaks(eng)


def test_overcommit_eviction_quarantines_and_recycles():
    eng = paged(n_pages=10, n_lanes=3, decode_forecast_fraction=0.25)
    reqs = [Request(prompt=rand_prompt(100 + i, 6), max_new=30)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    statuses = [r.status for r in reqs]
    assert statuses.count(overload.STATUS_OOM_QUARANTINED) >= 1
    assert eng.stats["page_evictions"] >= 1
    for r in reqs:
        assert r.status in consts.TERMINAL_STATUSES
        if r.status == overload.STATUS_COMPLETED:
            assert r.output == offline(r.prompt, r.max_new)
    assert_no_leaks(eng)


def test_sampling_and_eos_retire_early():
    probe = Request(prompt=rand_prompt(80, 6), max_new=10)
    eng = paged()
    eng.submit(probe)
    eng.run()
    stop = next(i for i in range(2, len(probe.output))
                if probe.output[i] not in probe.output[:i])
    again = Request(prompt=probe.prompt, max_new=10,
                    eos=probe.output[stop])
    sampled = Request(prompt=rand_prompt(81, 5), max_new=8,
                      temperature=0.8, top_p=0.9)
    e2 = paged()
    e2.submit(again)
    e2.submit(sampled)
    e2.run()
    assert again.output == probe.output[:stop + 1]
    assert sampled.done and len(sampled.output) == 8
    assert all(0 <= t < CFG.vocab for t in sampled.output)
    assert_no_leaks(e2)


def test_explicit_kernel_read_on_cpu_raises():
    from tpushare_torch.workloads.ops.registry import KernelUnavailable
    with pytest.raises(KernelUnavailable):
        paged(attn_impl="paged")


def test_submit_rejects_impossible_requests():
    eng = paged()
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(prompt=rand_prompt(1, 10), max_new=60))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(prompt=[], max_new=3))


def test_payload_serve_runs_paged_and_rejects_the_slot_engine():
    from tpushare_torch.workloads import infer
    args = ["--device", "cpu", "--mode", "serve", "--steps", "6",
            "--requests", "3", "--seq", "40", "--slots", "2"]
    with pytest.raises(SystemExit, match="slot engine is not ported"):
        infer.run(infer.parse_args(args))
    res = infer.run(infer.parse_args(args + ["--paged"]))
    assert all(r.status == consts.STATUS_COMPLETED for r in res["requests"])
    assert res["engine"].alloc.pages_in_use() == 0
    assert len(res["ttft_s"]) == 3 and res["tokens"] > 0


def test_overload_subset_matches_reference():
    from tpushare.workloads import overload as jover
    assert consts.TERMINAL_STATUSES == jover.TERMINAL_STATUSES
    assert overload.kv_cost_mib(16, 4, 128, 300) == \
        jover.kv_cost_mib(16, 4, 128, 300)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert overload.is_resource_exhausted(oom)
    try:
        try:
            raise oom
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError("admission failed") from e
    except RuntimeError as wrapped:
        assert overload.is_resource_exhausted(wrapped)
    assert not overload.is_resource_exhausted(ValueError("shape"))
    assert not overload.is_resource_exhausted(None)


@pytest.mark.parametrize("field,value,match", [
    ("kv_int8", True, "kv codec mismatch"),
    ("attn_window", 16, "ring cache"),
    ("ragged_decode", True, "ragged_decode"),
])
def test_configs_the_pool_cannot_serve_are_rejected(field, value, match):
    cfg = dataclasses.replace(CFG, **{field: value})
    with pytest.raises(ValueError, match=match):
        PagedServingEngine(PARAMS, cfg, **ENGINE_KW)
