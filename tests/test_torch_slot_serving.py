"""The port's slot serving engine held against the JAX reference on the
CPU: greedy transcripts of ``ServingEngine`` token-identical to the
reference ``ServingEngine`` (f32, head_dim 128, bridged weights) for the
dense read, the ragged read (its twin on the CPU), the pipelined loop, a
wrapping ring cache, eos, chunked prefill and prefix caching, with
logprobs within 1e-4; ``ring_generate`` against the reference; sampling
checked through counts, lengths and the truncation transforms (torch's
generator is not JAX's threefry); and the ``infer --mode serve`` flags.

The int8 slot caches (``cfg.kv_int8``, einsum and ragged reads) are held
against the reference through teacher-forced logits and gap-aware
transcripts (``torch_int8_replay``: an int8 LSB the two packages round
differently may break a greedy near-tie), and token for token against
the port's own ``chunked_generate`` oracle."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import bridge, infer  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    Request, ServingEngine)
import torch_int8_replay as replay  # noqa: E402

JCFG = jt.TransformerConfig(vocab=256, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=512, max_seq=256,
                            dtype=jnp.float32)


def torch_cfg(jcfg):
    return tt.TransformerConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)},
                                   "dtype": torch.float32})


CFG = torch_cfg(JCFG)
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")
ENGINE_KW = dict(n_slots=3, max_seq=256, prompt_buckets=(16, 32), chunk=4)


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


def rand_prompt(seed, n):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, JCFG.vocab, n)]


def serve_both(specs, jcfg=JCFG, jparams=JPARAMS, params=PARAMS,
               prefixes=(), **kw):
    """The same requests through the port's and the reference's engine;
    ``specs`` are Request keyword dicts. Returns (port, reference)
    requests and the port engine."""
    kw = {**ENGINE_KW, **kw}
    eng = ServingEngine(params, torch_cfg(jcfg), **kw)
    jeng = jserving.ServingEngine(jparams, jcfg, **kw)
    for name, toks in prefixes:
        eng.register_prefix(name, toks)
        jeng.register_prefix(name, toks)
    reqs = [Request(**s) for s in specs]
    jreqs = [jserving.Request(**s) for s in specs]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    return reqs, jreqs, eng


def assert_same_transcripts(reqs, jreqs):
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.status == consts.STATUS_COMPLETED
        assert r.output == jr.output
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-4)


MIXED = [dict(prompt=rand_prompt(10 + i, 5 + 9 * i), max_new=6 + 3 * i)
         for i in range(5)]


@pytest.mark.parametrize("ragged,pipeline", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_engine_matches_reference_engine(ragged, pipeline):
    """More requests than slots, mixed lengths, slots reused: the dense
    read, the ragged read and the pipelined loop each give the
    reference engine's transcripts."""
    jcfg = dataclasses.replace(JCFG, ragged_decode=ragged)
    reqs, jreqs, eng = serve_both(MIXED, jcfg=jcfg, pipeline=pipeline)
    assert eng.attn_impl == ("ragged" if ragged else "xla")
    assert_same_transcripts(reqs, jreqs)
    assert eng.stats["completed"] == len(MIXED)
    assert 0 < eng.lane_efficiency() <= 1


def test_slot_programs_match_offline_decode():
    """The device programs without the engine: ``admit`` two
    bucket-padded prompts into slots 0 and 2, then ``slot_decode_chunk``
    steps every slot together; each active slot's stream is the offline
    ``generate`` of its prompt, and the idle slot 1 stays put."""
    from tpushare_torch.workloads import serving
    slots = serving.init_slots(CFG, 3, 64, torch.device("cpu"))
    prompts = {0: rand_prompt(20, 5), 2: rand_prompt(21, 11)}
    for slot, p in prompts.items():
        padded = torch.zeros((1, 16), dtype=torch.int64)
        padded[0, :len(p)] = torch.tensor(p)
        serving.admit(PARAMS, padded, slots, slot, len(p), CFG)
    firsts = slots["tokens"].clone()
    toks, lps, slots = serving.slot_decode_chunk(PARAMS, slots, CFG, 6)
    assert slots["lengths"].tolist() == [5 + 6, 0, 11 + 6]
    assert toks[1].tolist() == [0] * 6 and bool(torch.isfinite(lps).all())
    for slot, p in prompts.items():
        want = tdec.generate(PARAMS, torch.tensor([p]), CFG, 7)[0].tolist()
        assert [int(firsts[slot])] + toks[slot].tolist()[:6] == want


def test_ring_engine_wraps_and_matches_reference():
    """A windowed model in a ring of window + largest bucket rows:
    requests several times longer than the ring match the reference's
    ring engine and the port's chunked ring oracle."""
    jcfg = dataclasses.replace(JCFG, attn_window=32)
    kw = dict(n_slots=2, max_seq=160, prompt_buckets=(16,), chunk=3,
              ring_rows=48)
    specs = [dict(prompt=rand_prompt(88, 20), max_new=110),
             dict(prompt=rand_prompt(89, 7), max_new=90)]
    reqs, jreqs, eng = serve_both(specs, jcfg=jcfg, **kw)
    assert eng.cache_rows == 48 and eng.slots["k"].shape[2] == 48
    assert_same_transcripts(reqs, jreqs)
    for r in reqs:
        want = tdec.chunked_generate(PARAMS, torch.tensor([r.prompt]),
                                     torch_cfg(jcfg), r.max_new,
                                     buckets=(16,), max_seq=160, rows=48)
        assert r.output == want[0].tolist()


def test_eos_stops_early_like_the_reference():
    probe = [dict(prompt=rand_prompt(30, 9), max_new=12)]
    reqs, _, _ = serve_both(probe)
    out = reqs[0].output
    stop = next(i for i in range(2, len(out)) if out[i] not in out[:i])
    specs = [dict(prompt=probe[0]["prompt"], max_new=12, eos=out[stop]),
             dict(prompt=rand_prompt(31, 6), max_new=8)]
    reqs, jreqs, _ = serve_both(specs)
    assert reqs[0].output == out[:stop + 1]
    assert_same_transcripts(reqs, jreqs)


def test_chunked_prefill_over_several_chunks():
    """Prompts longer than the largest bucket are admitted in bucket
    chunks (3 and 5 chunks here), as the reference and the oracle do."""
    specs = [dict(prompt=rand_prompt(40, 70), max_new=9),
             dict(prompt=rand_prompt(41, 150), max_new=7)]
    reqs, jreqs, eng = serve_both(specs)
    assert eng.stats["prefill_chunks"] == 3 + 5
    assert_same_transcripts(reqs, jreqs)
    for r in reqs:
        want = tdec.chunked_generate(PARAMS, torch.tensor([r.prompt]), CFG,
                                     r.max_new, buckets=(16, 32), max_seq=256)
        assert r.output == want[0].tolist()


def test_prefix_caching_matches_reference():
    prefix = rand_prompt(50, 21)
    specs = [dict(prompt=rand_prompt(51, 5), max_new=8, prefix="sys"),
             dict(prompt=rand_prompt(52, 12), max_new=6, prefix="sys"),
             dict(prompt=rand_prompt(53, 9), max_new=7)]
    reqs, jreqs, eng = serve_both(specs, prefixes=[("sys", prefix)])
    assert_same_transcripts(reqs, jreqs)
    # a prefix request is the same sequence as its full prompt
    full = [Request(prompt=prefix + specs[0]["prompt"], max_new=8)]
    e2 = ServingEngine(PARAMS, CFG, **ENGINE_KW)
    e2.submit(full[0])
    e2.run()
    assert full[0].output == reqs[0].output
    with pytest.raises(ValueError, match="already registered"):
        eng.register_prefix("sys", prefix)
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit(Request(prompt=[1], max_new=2, prefix="nope"))


def test_ring_generate_matches_reference():
    jcfg = dataclasses.replace(JCFG, attn_window=24)
    p = np.random.default_rng(60).integers(0, JCFG.vocab, (2, 30))
    want = np.asarray(jdec.ring_generate(JPARAMS, jnp.asarray(p, jnp.int32),
                                         jcfg, 70, rows=40))
    got = tdec.ring_generate(PARAMS, torch.from_numpy(p), torch_cfg(jcfg),
                             70, rows=40)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="attn_window"):
        tdec.ring_generate(PARAMS, torch.from_numpy(p), CFG, 4)


def test_sample_n_counts_lengths_and_prefix_cleanup():
    eng = ServingEngine(PARAMS, CFG, **ENGINE_KW)
    prompt = rand_prompt(70, 11)
    reqs = eng.sample_n(prompt, n=5, max_new=9, temperature=0.9, top_p=0.8)
    assert len(reqs) == 5 and eng.prefixes == {}
    for r in reqs:
        assert r.status == consts.STATUS_COMPLETED and len(r.output) == 9
        assert all(0 <= t < CFG.vocab for t in r.output)
        assert all(lp <= 0 and np.isfinite(lp) for lp in r.logprobs)
    assert eng.stats["completed"] == 5
    with pytest.raises(ValueError, match="temperature > 0"):
        eng.sample_n(prompt, n=2, max_new=3, temperature=0.0)


def test_sampling_truncated_to_top_1_is_greedy():
    """The engine's sampler through the truncation transforms: top_k=1
    leaves one token per row, so sampled requests reproduce the greedy
    transcripts; a sampled request is seeded by the engine seed."""
    greedy = [Request(prompt=s["prompt"], max_new=s["max_new"])
              for s in MIXED[:3]]
    e1 = ServingEngine(PARAMS, CFG, **ENGINE_KW)
    for r in greedy:
        e1.submit(r)
    e1.run()
    sampled = [Request(prompt=s["prompt"], max_new=s["max_new"],
                       temperature=1.3) for s in MIXED[:3]]
    e2 = ServingEngine(PARAMS, CFG, top_k=1, **ENGINE_KW)
    for r in sampled:
        e2.submit(r)
    e2.run()
    assert [r.output for r in sampled] == [r.output for r in greedy]
    runs = []
    for _ in range(2):
        eng = ServingEngine(PARAMS, CFG, seed=3, **ENGINE_KW)
        r = Request(prompt=MIXED[1]["prompt"], max_new=10, temperature=1.0)
        eng.submit(r)
        eng.run()
        runs.append(r.output)
    assert runs[0] == runs[1] and len(runs[0]) == 10


def test_engine_refuses_what_it_cannot_serve():
    # a serving mesh the model cannot tile (kv_heads 1 over tp 2) is
    # refused with the reference's ERR_SERVING_MESH_HEADS_FMT word for
    # word, and the ragged read under it through the registry's
    # mesh:heads-untiled row; int8 weights (mm=, A.7), the overload knobs
    # (A.2) and a draft (A.6) are ported, and mm= with a draft is the
    # reference's ERR_SPEC_MM, word for word
    from tpushare_torch.workloads.parallel.mesh import make_serving_mesh
    from tpushare_torch.workloads.quant import qmm
    from tpushare_torch.workloads.serving import PagedServingEngine
    assert ServingEngine(PARAMS, CFG, mm=qmm, **ENGINE_KW).mm is qmm
    untiled = make_serving_mesh(tp=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError) as err:
        PagedServingEngine(PARAMS, CFG, n_lanes=2, max_seq=256, n_pages=9,
                           page_size=32, mesh=untiled)
    assert str(err.value) == jconsts.ERR_SERVING_MESH_HEADS_FMT.format(
        tp=2, kv_heads=1, n_heads=2) == \
        consts.ERR_SERVING_MESH_HEADS_FMT.format(tp=2, kv_heads=1, n_heads=2)
    with pytest.raises(registry.KernelUnavailable, match="divide by tp"):
        ServingEngine(PARAMS, dataclasses.replace(CFG, ragged_decode=True),
                      mesh=untiled, **ENGINE_KW)
    assert ServingEngine(PARAMS, CFG, queue_limit=4,
                         **ENGINE_KW).queue_limit == 4
    assert ServingEngine(PARAMS, CFG, queue_limit=4, draft=(PARAMS, CFG, 2),
                         **ENGINE_KW).draft[2] == 2
    with pytest.raises(ValueError) as err:
        ServingEngine(PARAMS, CFG, mm=qmm, draft=(PARAMS, CFG, 2),
                      **ENGINE_KW)
    assert str(err.value) == jconsts.ERR_SPEC_MM == consts.ERR_SPEC_MM
    with pytest.raises(ValueError, match="ring_rows requires"):
        ServingEngine(PARAMS, CFG, ring_rows=64, **ENGINE_KW)
    wcfg = dataclasses.replace(CFG, attn_window=40)
    with pytest.raises(ValueError, match="ring_rows"):
        ServingEngine(PARAMS, wcfg, ring_rows=64, **ENGINE_KW)  # < 40+32
    with pytest.raises(registry.KernelUnavailable, match="window"):
        ServingEngine(PARAMS, dataclasses.replace(wcfg, ragged_decode=True),
                      **ENGINE_KW)
    with pytest.raises(registry.KernelUnavailable, match="not divisible"):
        ServingEngine(PARAMS, dataclasses.replace(CFG, ragged_decode=True),
                      **{**ENGINE_KW, "max_seq": 192})
    eng = ServingEngine(PARAMS, CFG, **ENGINE_KW)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(prompt=rand_prompt(1, 40), max_new=230))
    from tpushare_torch.workloads.serving import PagedServingEngine
    paged = PagedServingEngine(PARAMS, CFG, n_lanes=2, max_seq=64, n_pages=9,
                               page_size=16, prompt_buckets=(16,))
    # shared-prefix pages (A.3) are ported: an unknown name is refused at
    # submit, a registered one served
    with pytest.raises(ValueError, match="unknown prefix 'sys'"):
        paged.submit(Request(prompt=[1, 2], max_new=2, prefix="sys"))
    paged.register_prefix("sys", [3, 4, 5])
    paged.submit(Request(prompt=[1, 2], max_new=2, prefix="sys"))


SERVE = ["--device", "cpu", "--mode", "serve", "--requests", "3",
         "--seq", "40", "--slots", "2", "--hbm-limit-mib", "2000"]


@pytest.mark.parametrize("flags,line", [
    ([], "slot engine: 2 slots x 128 rows (read xla)"),
    (["--ragged"], "--ragged: re-headed preset to 2 heads of 128"),
    (["--window", "32", "--ring-rows", "64"],
     "ring KV cache: 64 rows/slot (window 32, logical max_seq 128)"),
])
def test_payload_serve_runs_the_slot_engine(flags, line, capsys):
    res = infer.run(infer.parse_args(SERVE + ["--steps", "100"] + flags))
    out = capsys.readouterr().out
    assert line in out and "serve throughput" in out
    assert "time to first token" in out
    reqs = res["requests"]
    assert all(r.status == consts.STATUS_COMPLETED
               and len(r.output) == r.max_new for r in reqs)
    assert len(res["ttft_s"]) == 3 and res["decode_steps"] > 0
    eng = res["engine"]
    assert eng.attn_impl == ("ragged" if flags == ["--ragged"] else "xla")
    if flags and flags[0] == "--window":
        # 10-token prompts run to ~110 positions in a 64-row ring
        assert max(len(r.prompt) + len(r.output) for r in reqs) > 64


@pytest.mark.parametrize("flags", [["--paged", "--ragged"],
                                   ["--paged", "--window", "32"]])
def test_payload_rejects_slot_flags_with_paged(flags):
    with pytest.raises(SystemExit) as e:
        infer.run(infer.parse_args(SERVE + ["--steps", "6"] + flags))
    assert e.value.code == 2


def test_payload_ragged_needs_a_reheadable_preset():
    """The 8000 MiB preset (d_model 512) re-heads to 4 heads of 128; a
    d_model that is not a multiple of 128 exits 2."""
    args = infer.parse_args(SERVE + ["--ragged", "--hbm-limit-mib", "8000"])
    cfg, _, max_seq = infer.serve_config(args, infer.pick_config(8000), 8000)
    assert (cfg.n_heads, cfg.head_dim, cfg.ragged_decode) == (4, 128, True)
    assert max_seq % 256 == 0
    odd = dataclasses.replace(infer.pick_config(2000), d_model=320,
                              n_heads=5)
    with pytest.raises(SystemExit) as e:
        infer.serve_config(args, odd, 2000)
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# int8 slot caches (cfg.kv_int8)
# ---------------------------------------------------------------------------

INT8 = dataclasses.replace(JCFG, kv_int8=True)
# teacher-forced logits, port vs reference: an int8 element one LSB
# apart (a rounding tie the packages break differently) moves these
# logits by ~1e-4-1e-3 at this size
INT8_LOGIT_TOL = 5e-3
JDEC = replay.JittedDecode(jdec)


def jarr(toks):
    return jnp.asarray([toks], jnp.int32)


def tarr(toks):
    return torch.tensor([toks])


def assert_int8_agrees(reqs, jreqs, jcfg, prefixes=None):
    """Each port request against the reference's: teacher-forced logits
    along the reference transcript within INT8_LOGIT_TOL, transcripts
    equal up to a reference near-tie, logprobs within the tolerance on
    the steps compared. Returns the steps compared."""
    compared = 0
    for r, jr in zip(reqs, jreqs):
        assert r.status == consts.STATUS_COMPLETED
        kw = dict(prefix=(prefixes or {}).get(jr.prefix, ()))
        want = replay.replay_logits(JDEC, JPARAMS, jcfg, jr.prompt,
                                    jr.output, ENGINE_KW["prompt_buckets"],
                                    ENGINE_KW["max_seq"], to_arr=jarr, **kw)
        got = replay.replay_logits(tdec, PARAMS, torch_cfg(jcfg), jr.prompt,
                                   jr.output, ENGINE_KW["prompt_buckets"],
                                   ENGINE_KW["max_seq"], to_arr=tarr,
                                   device="cpu", **kw)
        replay.assert_logits_agree(got, want, INT8_LOGIT_TOL)
        n = replay.assert_transcripts_agree(r.output, jr.output, want,
                                            INT8_LOGIT_TOL)
        np.testing.assert_allclose(r.logprobs[:n], jr.logprobs[:n],
                                   atol=INT8_LOGIT_TOL)
        compared += n
    return compared


@pytest.mark.parametrize("ragged,pipeline", [(False, False), (True, False),
                                             (True, True)])
def test_int8_engine_matches_reference_engine(ragged, pipeline):
    """The einsum read, the ragged read (its twin on the CPU) and the
    pipelined loop over int8 slot caches against the reference's int8
    slot engine."""
    jcfg = dataclasses.replace(INT8, ragged_decode=ragged)
    reqs, jreqs, eng = serve_both(MIXED, jcfg=jcfg, pipeline=pipeline)
    assert eng.attn_impl == ("ragged" if ragged else "xla")
    assert eng.slots["k"]["q"].dtype == torch.int8
    assert assert_int8_agrees(reqs, jreqs, jcfg) > 0
    assert eng.stats["completed"] == len(MIXED)


@pytest.mark.parametrize("ragged", [False, True])
def test_int8_engine_matches_its_chunked_oracle(ragged):
    """Token for token the port's own ``chunked_generate`` over an int8
    cache (same bucket layout, each chunk reading the cache quantized,
    its own rows included)."""
    cfg = dataclasses.replace(CFG, kv_int8=True, ragged_decode=ragged)
    specs = MIXED + [dict(prompt=rand_prompt(42, 70), max_new=9)]
    eng = ServingEngine(PARAMS, cfg, **ENGINE_KW)
    reqs = [Request(**s) for s in specs]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        want = tdec.chunked_generate(PARAMS, torch.tensor([r.prompt]), cfg,
                                     r.max_new, buckets=(16, 32),
                                     max_seq=256)
        assert r.output == want[0].tolist()


def test_int8_prefix_copies_both_planes_and_matches_reference():
    """A prefix registers quantized and installs by copying its q and s
    planes (never requantized); the transcripts agree with the
    reference's int8 engine."""
    from tpushare_torch.workloads import serving
    prefix = rand_prompt(55, 21)
    specs = [dict(prompt=rand_prompt(56, 5), max_new=8, prefix="sys"),
             dict(prompt=rand_prompt(57, 40), max_new=6, prefix="sys"),
             dict(prompt=rand_prompt(58, 9), max_new=7)]
    reqs, jreqs, eng = serve_both(specs, jcfg=INT8,
                                  prefixes=[("sys", prefix)])
    assert assert_int8_agrees(reqs, jreqs, INT8, {"sys": prefix}) > 0
    _, pkv = eng.prefixes["sys"]
    slots = serving.init_slots(eng.cfg, 2, 64, torch.device("cpu"))
    serving._install_prefix(slots, 1, pkv["k"], pkv["v"])
    for side in ("k", "v"):
        for plane in ("q", "s"):
            assert torch.equal(slots[side][plane][:, 1, :21],
                               pkv[side][plane][:, 0])
    assert (slots["k"]["s"][:, 0] == 1).all()          # slot 0 untouched


def test_ring_generate_int8_matches_reference():
    """A windowed model over an int8 ring cache: teacher-forced logits
    within the int8 tolerance of the reference's ring decode, and the
    greedy streams equal up to a reference near-tie."""
    jcfg = dataclasses.replace(INT8, attn_window=24)
    tcfg = torch_cfg(jcfg)
    p = np.random.default_rng(61).integers(0, JCFG.vocab, (2, 30))
    want = np.asarray(jdec.ring_generate(JPARAMS, jnp.asarray(p, jnp.int32),
                                         jcfg, 50, rows=40))
    got = tdec.ring_generate(PARAMS, torch.from_numpy(p), tcfg, 50,
                             rows=40).numpy()

    def forced(dec, step, params, cfg, arr, **kw):
        cache = dec.init_cache(cfg, 2, 40, **kw)
        lg, cache = dec.prefill(params, arr(p), cfg, cache)
        rows = [np.asarray(lg, np.float32)]
        for t in want.T[:-1]:
            lg, cache = step(params, arr(t), cache, cfg)
            rows.append(np.asarray(lg, np.float32))
        return np.stack(rows, axis=1)                  # (B, steps, vocab)

    jwant = forced(jdec, jax.jit(jdec.ring_decode_step,
                                 static_argnames=("cfg",)),
                   JPARAMS, jcfg, lambda x: jnp.asarray(x, jnp.int32))
    tgot = forced(tdec, tdec.ring_decode_step, PARAMS, tcfg,
                  lambda x: torch.from_numpy(np.array(x)), device="cpu")
    for b in range(2):
        replay.assert_logits_agree(tgot[b], jwant[b], INT8_LOGIT_TOL)
        replay.assert_transcripts_agree(got[b].tolist(), want[b].tolist(),
                                        jwant[b], INT8_LOGIT_TOL)
