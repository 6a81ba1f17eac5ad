"""The port's block-paged serving engine, mirroring the reference's
``tests/test_paged_serving.py`` on the CPU: token identity against the
port's offline ``generate`` and against the JAX ``PagedServingEngine``
(f32, greedy, bridged weights), a request joining mid-wave, pool
exhaustion deferring admission, a never-fitting request shed, and no
leaked pages. The int8 pool (``kv_codec="int8"``) against the reference's
int8 paged engine (teacher-forced logits and gap-aware transcripts,
``torch_int8_replay``), against the port's own offline replay of the
pool's semantics, admitting deeper at equal HBM, and through ``infer
--kv-codec int8``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, overload  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.decode import generate  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request)
import torch_int8_replay as replay  # noqa: E402

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes: one intra-op
    thread keeps these tiny models' many small ops from oversubscribing
    the cores (each op otherwise waits on every pool thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """``--paged`` runs the paged engine and rejects the slot engine's
    flags (ring cache, ragged read) with exit 2, as the reference
    payload does; without ``--paged`` the slot engine serves
    (``tests/test_torch_slot_serving.py``)."""
    from tpushare_torch.workloads import infer
    args = ["--device", "cpu", "--mode", "serve", "--steps", "6",
            "--requests", "3", "--seq", "40", "--slots", "2"]
    with pytest.raises(SystemExit) as rejected:
        infer.run(infer.parse_args(args + ["--paged", "--ring-rows", "64"]))
    assert rejected.value.code == 2
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
    with pytest.raises(ValueError, match=match):
        PagedServingEngine(PARAMS, cfg, kv_codec="int8", **ENGINE_KW)


# ---------------------------------------------------------------------------
# the int8 pool (kv_codec="int8")
# ---------------------------------------------------------------------------

# teacher-forced logits, port vs reference: an int8 element one LSB
# apart (a rounding tie the packages break differently) moves these
# logits by ~1e-4-1e-3 at this size
INT8_LOGIT_TOL = 5e-3
JDEC = replay.JittedDecode(jdec)
REPLAY = dict(buckets=ENGINE_KW["prompt_buckets"],
              max_seq=ENGINE_KW["max_seq"], quantize_prefill=False)


def int8_specs():
    return [dict(prompt=rand_prompt(10 + i, 5 + 3 * i), max_new=6 + 2 * i)
            for i in range(5)]


def test_int8_pool_matches_the_reference_int8_engine():
    """More requests than lanes, pages recycled: the int8 pool against the
    reference's int8 paged engine on the same weights — teacher-forced
    logits within INT8_LOGIT_TOL, transcripts equal up to a reference
    near-tie, logprobs within the tolerance on the steps compared."""
    reqs = [Request(**s) for s in int8_specs()]
    jreqs = [jserving.Request(**s) for s in int8_specs()]
    eng = paged(kv_codec="int8")
    jeng = jserving.PagedServingEngine(JPARAMS, JCFG, kv_codec="int8",
                                       **ENGINE_KW)
    assert eng.kv_codec == "int8" and eng.attn_impl == "xla"
    assert eng.state["k"]["q"].dtype == torch.int8
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    compared = 0
    for r, jr in zip(reqs, jreqs):
        assert r.status == jr.status == overload.STATUS_COMPLETED
        want = replay.replay_logits(
            JDEC, JPARAMS, JCFG, jr.prompt, jr.output,
            to_arr=lambda t: jnp.asarray([t], jnp.int32), **REPLAY)
        got = replay.replay_logits(
            tdec, PARAMS, CFG, jr.prompt, jr.output,
            to_arr=lambda t: torch.tensor([t]), device="cpu", **REPLAY)
        replay.assert_logits_agree(got, want, INT8_LOGIT_TOL)
        n = replay.assert_transcripts_agree(r.output, jr.output, want,
                                            INT8_LOGIT_TOL)
        np.testing.assert_allclose(r.logprobs[:n], jr.logprobs[:n],
                                   atol=INT8_LOGIT_TOL)
        compared += n
    assert compared > 0
    assert_no_leaks(eng)


def test_int8_pool_matches_its_offline_replay():
    """Token for token the port's offline replay of the pool's semantics
    (dense chunked prefill, quantized into the cache, int8 decode): the
    replay's greedy choice along the engine's transcript is the engine's
    token at every step — across lanes, recycled pages and a request
    joining mid-wave."""
    reqs = [Request(**s) for s in int8_specs()]
    eng = paged(kv_codec="int8")
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run()
    for r in reqs:
        want = replay.replay_logits(tdec, PARAMS, CFG, r.prompt, r.output,
                                    to_arr=lambda t: torch.tensor([t]),
                                    device="cpu", **REPLAY)
        assert want.argmax(-1).tolist() == r.output
    assert_no_leaks(eng)


def test_int8_pool_admits_strictly_deeper_at_equal_hbm():
    """The same offered load through two pools bought with the same HBM
    budget: the int8 pool's extra pages (``paging.pages_for_hbm``) admit
    strictly deeper peak concurrency — the reference's claim, on the
    port."""
    from tpushare_torch.workloads import paging
    budget = paging.pool_hbm_mib(7, 8, CFG.n_layers, CFG.kv_heads,
                                 CFG.head_dim)
    peaks = {}
    for codec in consts.KV_CODECS:
        n_pages = paging.pages_for_hbm(budget, 8, CFG.n_layers, CFG.kv_heads,
                                       CFG.head_dim, codec=codec)
        eng = paged(n_lanes=6, n_pages=n_pages, prompt_buckets=(8,),
                    kv_codec=codec)
        assert eng.pool_mib <= budget
        reqs = [Request(prompt=rand_prompt(30 + i, 5), max_new=8)
                for i in range(6)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.status == consts.STATUS_COMPLETED for r in reqs)
        assert_no_leaks(eng)
        peaks[codec] = eng.stats["peak_running"]
    assert peaks["int8"] > peaks["bf16"]


def test_payload_serve_kv_codec_int8(capsys):
    """``infer --mode serve --kv-codec int8`` implies ``--paged``, sizes
    the pool to the same HBM under the int8 codec (more pages than
    bf16) and serves every request; it still excludes the slot engine's
    flags."""
    from tpushare_torch.workloads import infer, paging
    args = ["--device", "cpu", "--mode", "serve", "--steps", "6",
            "--requests", "3", "--seq", "40", "--slots", "2"]
    res = infer.run(infer.parse_args(args + ["--kv-codec", "int8"]))
    eng = res["engine"]
    cfg = eng.cfg
    budget = paging.pool_hbm_mib(paging.pages_for_rows(2 * eng.max_seq, 32),
                                 32, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
    want = paging.pages_for_hbm(budget, 32, cfg.n_layers, cfg.kv_heads,
                                cfg.head_dim, codec="int8")
    assert isinstance(eng, PagedServingEngine) and eng.kv_codec == "int8"
    assert eng.alloc.n_pages == want > paging.pages_for_hbm(
        budget, 32, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
    bpt = paging.kv_bytes_per_token(cfg.n_layers, cfg.kv_heads, cfg.head_dim,
                                    "int8")
    assert (f"paged KV pool: {want} pages x 32 rows (codec int8, "
            f"{bpt:.0f} B/token") in capsys.readouterr().out
    assert all(r.status == consts.STATUS_COMPLETED for r in res["requests"])
    assert_no_leaks(eng)
    with pytest.raises(SystemExit) as rejected:
        infer.run(infer.parse_args(args + ["--kv-codec", "int8",
                                           "--ragged"]))
    assert rejected.value.code == 2
