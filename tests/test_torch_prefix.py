"""Shared-prefix pages with copy-on-write on the port's paged engine,
held against the reference on the CPU (the reference's
``tests/test_prefix_caching.py``, its engine half):

- the decode helpers of the slice — ``slot_view`` / ``slot_unview``,
  ``gather_pool_pages`` / ``load_pool_pages``, ``copy_pool_page``, the
  install's ``skip_pages`` and ``make_paged_chunk_core`` — against the
  reference's on random pools of both codecs: dense results bitwise,
  int8 ``q`` within one LSB and ``s`` at rtol 1e-6 where the port
  quantizes, byte for byte where it only moves planes;
- subscribers token-exact (f32) against the reference's paged engine,
  the offline recompute of prefix + prompt and the slot engine's copied
  prefix; ``alloc.snapshot()``, ``prefix_hits`` and ``cow_copies``
  equal to the reference engine's after every step of one scripted
  request sequence, on both codecs;
- the CoW fence (pinned pages bitwise unchanged, co-subscribers exact),
  the decode-path guard, a ``torch.cuda.OutOfMemoryError`` inside the
  page copy leaving no half swap, victims ranked by private pages,
  aligned prefixes sharing without a copy, deeper admission at equal
  HBM, drop semantics, one registration preamble for both engines, the
  chaos storm with subscribers and the ``chat`` traffic replayed on the
  paged engine.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare import consts as jconsts  # noqa: E402
from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads import serving as jserving  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
import chip_smoke  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.tpu.fake import (WorkloadFault,  # noqa: E402
                                     WorkloadFaultPlan)
from tpushare_torch.workloads import bridge, overload, traffic  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads import serving  # noqa: E402
from tpushare_torch.workloads.decode import generate  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.serving import (  # noqa: E402
    PagedServingEngine, Request, ServingEngine)

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")
ENGINE_KW = dict(n_lanes=3, max_seq=64, n_pages=25, page_size=8,
                 prompt_buckets=(8, 32), chunk=4)
CODECS = ["bf16", "int8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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
            np.random.default_rng(seed).integers(0, CFG.vocab, n)]


def offline(prompt, steps):
    return generate(PARAMS, torch.tensor([prompt]), CFG, steps)[0].tolist()


def paged(**kw):
    return PagedServingEngine(PARAMS, CFG, **{**ENGINE_KW, **kw})


def jpaged(**kw):
    return jserving.PagedServingEngine(JPARAMS, JCFG,
                                       **{**ENGINE_KW, "attn_impl": "xla",
                                          **kw})


def assert_clean(eng, pinned=0):
    """Only the registrations' pinned pages remain; nothing leaked."""
    assert eng.alloc.pages_in_use() == pinned
    assert eng.alloc.leaked() == 0
    assert eng.alloc.free_pages() == eng.alloc.usable_pages - pinned
    assert eng.alloc.shared_pages() == 0


def planes(leaf):
    """A leaf's planes as numpy arrays, either package, either codec."""
    if isinstance(leaf, dict):
        return [np.asarray(leaf["q"]), np.asarray(leaf["s"])]
    return [np.asarray(leaf)]


def assert_planes(got, want, quantized_here: bool):
    """Dense planes bitwise; int8 planes byte for byte where nothing was
    quantized, else ``q`` within one LSB and ``s`` at rtol 1e-6."""
    for g, w in zip(planes(got), planes(want)):
        if quantized_here and g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        elif quantized_here and len(planes(got)) == 2:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def random_pool(codec, n_pages=9, ps=8, seed=0):
    """One random pool leaf per package, the same values: dense fp32, or
    the port's codec of them carried to the reference byte for byte."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n_pages, ps, 2, 16)).astype(np.float32)
    if codec == "bf16":
        return torch.from_numpy(x.copy()), jnp.asarray(x)
    q = tdec.kv_quantize(torch.from_numpy(x))
    return ({"q": q["q"].clone(), "s": q["s"].clone()},
            {"q": jnp.asarray(q["q"].numpy()),
             "s": jnp.asarray(q["s"].numpy())})


# ---------------------------------------------------------------------------
# the decode helpers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_slot_views_and_pool_page_helpers_match_reference(codec):
    # slot_view / slot_unview on a (L, n_slots, S, Hkv, hd) cache leaf
    tleaf, jleaf = random_pool(codec, n_pages=3, ps=12, seed=1)
    tsub, jsub = random_pool(codec, n_pages=1, ps=5, seed=2)
    assert_planes(tdec.slot_view(tleaf, 2),
                  jax.tree.map(lambda x: jdec.slot_view(x, 2), jleaf),
                  False)
    tdec.slot_unview(tleaf, tsub, 1)
    jleaf = jax.tree.map(lambda x, s: jdec.slot_unview(x, s, 1), jleaf,
                         jsub)
    assert_planes(tleaf, jleaf, False)
    # the prefix gather into a dense scratch (dequantized from int8)
    tk, jk = random_pool(codec, seed=3)
    tv, jv = random_pool(codec, seed=4)
    ids = [5, 2, 7]
    sk, sv = torch.zeros(2, 1, 32, 2, 16), torch.zeros(2, 1, 32, 2, 16)
    tdec.load_pool_pages(sk, sv, tk, tv, torch.tensor(ids))
    jsk, jsv = jdec.load_pool_pages(jnp.zeros((2, 1, 32, 2, 16)),
                                    jnp.zeros((2, 1, 32, 2, 16)), jk, jv,
                                    jnp.asarray(ids, jnp.int32))
    assert_planes(sk, jsk, False)
    assert_planes(sv, jsv, False)
    # the copy-on-write page copy: both planes byte for byte
    tdec.copy_pool_page(tk, tv, 2, 8)
    jk, jv = jdec.copy_pool_page(jk, jv, jnp.int32(2), jnp.int32(8))
    assert_planes(tk, jk, False)
    assert_planes(tv, jv, False)
    # the install past spliced pages (skip_pages): quantized for int8
    scratch = np.random.default_rng(5).standard_normal(
        (2, 1, 32, 2, 16)).astype(np.float32)
    serving._install_pages(tk, tv, torch.from_numpy(scratch),
                           torch.from_numpy(scratch), torch.tensor([1, 4]),
                           skip_pages=2)
    jk, jv = jserving._install_pages(jk, jv, jnp.asarray(scratch),
                                     jnp.asarray(scratch),
                                     jnp.asarray([1, 4], jnp.int32),
                                     skip_pages=2)
    assert_planes(tk, jk, codec == "int8")
    assert_planes(tv, jv, codec == "int8")


@pytest.mark.parametrize("codec", CODECS)
def test_paged_chunk_core_matches_reference(codec):
    """The multi-token paged step (the spec verify and the draft ingest):
    each lane's Q rows land at its own positions through its table and
    attend causally over its pages — against the reference's closure on
    the same pool, tables and lengths."""
    # one layer's pool leaves (n_pages, ps, Hkv, hd), as a layer sees them
    tk, jk = (tdec.kv_view(x, 0) if isinstance(x, dict) else x[0]
              for x in random_pool(codec, seed=6))
    tv, jv = (tdec.kv_view(x, 0) if isinstance(x, dict) else x[0]
              for x in random_pool(codec, seed=7))
    tables = np.array([[3, 1, 6, 0], [2, 5, 8, 4], [0, 0, 0, 0]], np.int32)
    lengths = np.array([5, 11, 0], np.int32)
    cfg = dataclasses.replace(CFG, d_model=64, n_heads=4, n_kv_heads=2)
    jcfg = dataclasses.replace(JCFG, n_heads=4, n_kv_heads=2)
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((3, 4, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    core = tdec.make_paged_chunk_core(tk, tv, torch.from_numpy(tables),
                                      torch.from_numpy(lengths), cfg,
                                      gather_pages_w=4)
    o, _ = core(*map(torch.from_numpy, (q, k, v)))
    jcore = jdec.make_paged_chunk_core(jk, jv, jnp.asarray(tables),
                                       jnp.asarray(lengths), jcfg,
                                       gather_pages_w=4)
    jo, (jk, jv) = jax.jit(jcore)(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    assert_planes(tk, jk, codec == "int8")
    assert_planes(tv, jv, codec == "int8")


# ---------------------------------------------------------------------------
# engine: subscribers against the reference engine, step by step
# ---------------------------------------------------------------------------

SCRIPT = [  # (step index, prompt seed, prompt length, max_new, prefix)
    (0, 10, 4, 5, "sys"), (0, 11, 6, 7, "sys"), (0, 12, 7, 4, None),
    (1, 13, 8, 9, "sys"), (3, 14, 5, 6, "sys"), (3, 15, 7, 5, "aligned")]


def scripted(eng, mk, prefixes):
    """Drive one engine through SCRIPT: register, submit on schedule,
    step to the end; returns (requests, per-step snapshots and
    counters)."""
    for name, toks in prefixes.items():
        eng.register_prefix(name, toks)
    reqs, trail, i = [], [], 0
    while i < 40 and (i <= SCRIPT[-1][0] or eng.queue or eng.running):
        for at, seed, n, new, prefix in SCRIPT:
            if at == i:
                r = mk(prompt=rand_prompt(seed, n), max_new=new,
                       prefix=prefix)
                reqs.append(r)
                eng.submit(r)
        eng.step()
        trail.append((eng.alloc.snapshot(), eng.stats["prefix_hits"],
                      eng.stats["cow_copies"]))
        i += 1
    return reqs, trail


@pytest.mark.parametrize("codec", CODECS)
def test_subscribers_match_the_reference_engine_step_by_step(codec):
    """The same scripted sequence (an unaligned and an aligned prefix,
    a plain request, late joiners) through the port and the reference:
    the allocator snapshot and the prefix counters equal after every
    step, every transcript equal, and equal to the offline recompute of
    prefix + prompt (f32)."""
    prefixes = {"sys": rand_prompt(1, 13), "aligned": rand_prompt(2, 16)}
    reqs, trail = scripted(paged(kv_codec=codec), Request, prefixes)
    jreqs, jtrail = scripted(jpaged(kv_codec=codec), jserving.Request,
                             prefixes)
    assert trail == jtrail
    assert trail[-1][1] == 5 and trail[-1][2] == 4    # 4 unaligned hits
    for r, jr in zip(reqs, jreqs):
        assert r.status == jr.status == overload.STATUS_COMPLETED
        assert r.output == jr.output
        if codec == "bf16":
            full = prefixes.get(r.prefix, []) + r.prompt
            assert r.output == offline(full, r.max_new)
            np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-4)


def test_subscribers_equal_the_slot_engines_copied_prefix():
    sys_toks = rand_prompt(3, 13)             # 1 full page + a 5-row tail
    mk = lambda: [Request(prompt=rand_prompt(20 + i, 4 + 2 * i),  # noqa: E731
                          max_new=5 + 2 * i, prefix="sys")
                  for i in range(4)]
    peng = paged()
    peng.register_prefix("sys", sys_toks)
    slot = ServingEngine(PARAMS, CFG, n_slots=3, max_seq=64,
                         prompt_buckets=(8, 32), chunk=4)
    slot.register_prefix("sys", sys_toks)
    preqs, sreqs = mk(), mk()
    for eng, rs in ((peng, preqs), (slot, sreqs)):
        for r in rs:
            eng.submit(r)
        eng.run()
    for p, s in zip(preqs, sreqs):
        assert p.output == s.output
        np.testing.assert_allclose(p.logprobs, s.logprobs, rtol=1e-5,
                                   atol=1e-6)
    assert peng.stats["prefix_hits"] == peng.stats["cow_copies"] == 4
    assert_clean(peng, pinned=len(peng.prefixes["sys"][1]))
    peng.drop_prefix("sys")
    assert_clean(peng)


@pytest.mark.parametrize("codec", CODECS)
def test_cow_fence_never_mutates_pinned_pages(codec):
    """Two subscribers decode concurrently over the same shared pages:
    the pinned pages' planes are bitwise unchanged and each output is
    what the engine gives the request alone."""
    sys_toks = rand_prompt(4, 13)
    solo = {}
    for seed in (30, 31):
        eng = paged(kv_codec=codec)
        eng.register_prefix("sys", sys_toks)
        r = Request(prompt=rand_prompt(seed, 5), max_new=16, prefix="sys")
        eng.submit(r)
        eng.run()
        solo[seed] = r.output
    eng = paged(kv_codec=codec)
    eng.register_prefix("sys", sys_toks)
    ids = torch.tensor(eng.prefixes["sys"][1])
    before = [p[:, ids].clone() for leaf in (eng.state["k"], eng.state["v"])
              for p in tdec.kv_planes(leaf)]
    a = Request(prompt=rand_prompt(30, 5), max_new=16, prefix="sys")
    b = Request(prompt=rand_prompt(31, 5), max_new=16, prefix="sys")
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert len(eng.running) == 2 and eng.alloc.shared_pages() == 1
    eng.run()
    assert a.output == solo[30] and b.output == solo[31]
    after = [p[:, ids] for leaf in (eng.state["k"], eng.state["v"])
             for p in tdec.kv_planes(leaf)]
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    if codec == "bf16":
        assert a.output == offline(sys_toks + a.prompt, 16)
    assert_clean(eng, pinned=len(ids))


def shared_lane(codec="bf16"):
    """A lane holding both full pages of a 16-row prefix by reference,
    its next write mid page 1 (the white-box CoW setup)."""
    eng = paged(kv_codec=codec)
    eng.register_prefix("sys", rand_prompt(5, 16))
    _, pin_ids = eng.prefixes["sys"]
    lane = 0
    eng.alloc.share(lane, list(pin_ids))
    eng._sync_table(lane)
    eng._lengths[lane] = 13
    eng.running[lane] = Request(prompt=[1], max_new=4)
    return eng, lane, pin_ids


def page_planes(eng, page):
    return [p[:, page].clone() for leaf in (eng.state["k"], eng.state["v"])
            for p in tdec.kv_planes(leaf)]


def release_lane(eng, lane):
    del eng.running[lane]
    eng._lengths.pop(lane)
    eng.alloc.release(lane)


@pytest.mark.parametrize("codec", CODECS)
def test_decode_cow_guard_copies_before_write(codec):
    eng, lane, pin_ids = shared_lane(codec)
    src = pin_ids[1]
    before = page_planes(eng, src)
    assert eng.alloc.refcount(src) == 2
    eng._cow_guard(lane, 4)
    assert eng.stats["cow_copies"] == 1
    tbl = eng.alloc.table(lane)
    assert tbl[0] == pin_ids[0] and tbl[1] not in pin_ids
    assert eng.alloc.refcount(src) == 1
    for x, y, z in zip(before, page_planes(eng, tbl[1]),
                       page_planes(eng, src)):
        assert torch.equal(x, y) and torch.equal(x, z)   # q and s alike
    assert eng.state["tables"][lane, 1].item() == tbl[1]
    eng._cow_guard(lane, 4)                   # nothing left to copy
    assert eng.stats["cow_copies"] == 1
    release_lane(eng, lane)
    assert_clean(eng, pinned=len(pin_ids))


def test_cow_guard_device_failure_leaves_no_half_swap(monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` raised inside the page copy —
    after the K planes landed in the reserved page, before the V planes
    — leaves the host table, the device table, every refcount, the
    shared set and the free pool exactly as before the guard: the page
    the copy half-wrote was never in a table. The retry completes the
    copy with the clone bitwise the source."""
    eng, lane, pin_ids = shared_lane()
    src = pin_ids[1]
    before = page_planes(eng, src)
    free_before = eng.alloc.free_pages()
    real_copy = serving.copy_pool_page

    def k_then_oom(kp, vp, s, d):
        for plane in tdec.kv_planes(kp):
            plane[:, d] = plane[:, s]
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (page copy)")

    monkeypatch.setattr(serving, "copy_pool_page", k_then_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError) as exc:
        eng._cow_guard(lane, 4)
    assert overload.is_resource_exhausted(exc.value)
    assert eng.alloc.table(lane)[1] == src
    assert eng.state["tables"][lane, 1].item() == src
    assert eng.alloc.refcount(src) == 2
    assert src in eng.alloc.shared_pages_of(lane)
    assert eng.alloc.free_pages() == free_before
    assert eng.alloc.leaked() == 0 and eng.stats["cow_copies"] == 0
    monkeypatch.setattr(serving, "copy_pool_page", real_copy)
    eng._cow_guard(lane, 4)
    clone = eng.alloc.table(lane)[1]
    assert eng.stats["cow_copies"] == 1 and clone not in pin_ids
    assert eng.state["tables"][lane, 1].item() == clone
    for x, y in zip(before, page_planes(eng, clone)):
        assert torch.equal(x, y)
    release_lane(eng, lane)
    assert_clean(eng, pinned=len(pin_ids))


def test_victim_is_ranked_by_private_pages():
    eng = paged()
    eng.register_prefix("sys", rand_prompt(6, 24))     # three full pages
    sub = Request(prompt=rand_prompt(40, 4), max_new=30, prefix="sys")
    plain = Request(prompt=rand_prompt(41, 16), max_new=30)
    eng.submit(sub)
    eng.submit(plain)
    eng.step()
    lanes = {id(r): lane for lane, r in eng.running.items()}
    ls, lp = lanes[id(sub)], lanes[id(plain)]
    assert eng._lengths[ls] > eng._lengths[lp]
    assert eng.alloc.private_pages(ls) < eng.alloc.private_pages(lp)
    assert max(eng.running, key=eng._victim_key) == lp
    eng.run()
    eng.drop_prefix("sys")
    assert_clean(eng)


def test_aligned_prefix_shares_without_a_copy_and_admits_deeper():
    sys_toks = rand_prompt(7, 16)             # exactly two pages
    eng = paged()
    eng.register_prefix("sys", sys_toks)
    reqs = [Request(prompt=rand_prompt(50 + i, 5), max_new=6, prefix="sys")
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.alloc.shared_pages() == 2
    eng.run()
    for r in reqs:
        assert r.output == offline(sys_toks + r.prompt, r.max_new)
    assert eng.stats["cow_copies"] == 0 and eng.stats["prefix_hits"] == 3
    assert_clean(eng, pinned=2)
    # at equal pool HBM two subscribers run together where the same
    # requests at full price (the prefix inlined) serialize
    suffixes = [rand_prompt(60 + i, 5) for i in range(2)]
    peaks, outs = {}, {}
    for tag in ("shared", "full"):
        e = paged(n_pages=8, n_lanes=2, prompt_buckets=(8,))
        if tag == "shared":
            e.register_prefix("sys", sys_toks)
            rs = [Request(prompt=s, max_new=8, prefix="sys")
                  for s in suffixes]
        else:
            rs = [Request(prompt=sys_toks + s, max_new=8) for s in suffixes]
        for r in rs:
            e.submit(r)
        e.run()
        peaks[tag], outs[tag] = e.stats["peak_running"], [r.output
                                                           for r in rs]
    assert peaks == {"shared": 2, "full": 1}
    assert outs["shared"] == outs["full"]


def test_registry_guards_and_drop_semantics():
    eng = paged()
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit(Request(prompt=rand_prompt(8, 5), max_new=4,
                           prefix="ghost"))
    eng.register_prefix("sys", rand_prompt(9, 13))
    with pytest.raises(ValueError, match="already registered"):
        eng.register_prefix("sys", rand_prompt(9, 13))
    with pytest.raises(ValueError, match="outside"):
        eng.register_prefix("giant", rand_prompt(10, 64))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(prompt=rand_prompt(11, 5), max_new=60,
                           prefix="sys"))
    # drop: queued subscribers shed terminally, in-flight ones finish on
    # their own references, the pages unpin
    big = paged(n_pages=13, n_lanes=2)
    sys_toks = rand_prompt(9, 13)
    big.register_prefix("sys", sys_toks)
    full_page, tail_page = big.prefixes["sys"][1]
    running = Request(prompt=rand_prompt(12, 5), max_new=20, prefix="sys")
    blocker = Request(prompt=rand_prompt(13, 5), max_new=20)
    big.submit(running)
    big.submit(blocker)
    big.step()
    assert len(big.running) == 2
    waiting = Request(prompt=rand_prompt(14, 5), max_new=4, prefix="sys")
    big.submit(waiting)
    big.drop_prefix("sys")
    assert waiting.status == overload.STATUS_SHED and not big.queue
    # the subscriber keeps the full page alive; the pinned tail recycled
    assert big.alloc.refcount(full_page) == 1
    assert big.alloc.refcount(tail_page) == 0
    with pytest.raises(ValueError, match="unknown prefix"):
        big.drop_prefix("sys")
    big.run()
    assert running.status == blocker.status == overload.STATUS_COMPLETED
    assert running.output == offline(sys_toks + running.prompt, 20)
    assert_clean(big)


def test_one_registration_preamble_for_both_engines():
    """Both engines refuse through ``_EngineCore``'s one preamble, word
    for word the reference's; an int8 pool refuses a ``{q, s}`` scratch
    with the codec contract string."""
    engines = (paged(), ServingEngine(PARAMS, CFG, n_slots=2, max_seq=64,
                                      prompt_buckets=(8, 32)))
    jengines = (jpaged(), jserving.ServingEngine(
        JPARAMS, JCFG, n_slots=2, max_seq=64, prompt_buckets=(8, 32)))
    for eng, jeng in zip(engines, jengines):
        eng.register_prefix("sys", [1, 2, 3])
        jeng.register_prefix("sys", [1, 2, 3])
        for name, toks in (("sys", [1, 2]), ("empty", []),
                           ("long", list(range(64)))):
            with pytest.raises(ValueError) as got:
                eng.register_prefix(name, toks)
            with pytest.raises(ValueError) as want:
                jeng.register_prefix(name, toks)
            assert str(got.value) == str(want.value)
    assert consts.ERR_PREFIX_MOE == jconsts.ERR_PREFIX_MOE
    eng = paged(kv_codec="int8")
    eng.cfg = dataclasses.replace(CFG, kv_int8=True)
    with pytest.raises(ValueError) as got:
        eng.register_prefix("q", [1, 2, 3])
    assert str(got.value) == jconsts.ERR_KV_CODEC_MISMATCH_FMT.format(
        pool="int8", cache="int8 (cfg.kv_int8)")
    assert eng.alloc.pages_in_use() == 0      # the pin was released


def test_storm_with_subscribers_drains_to_the_pinned_pages():
    """The reference's acceptance storm (dispatch OOM x 3, a hung sync
    under the watchdog, a 4-deep queue) with prefix subscribers in the
    mix: exact accounting, degraded then ok, completed subscribers
    exact, only the pinned pages left; after the drop, a new
    registration still serves."""
    plan = WorkloadFaultPlan()
    plan.add("dispatch", WorkloadFault(times=3, kind="oom"))
    plan.add("sync", WorkloadFault(times=1, kind="hang", delay_s=0.6))
    ctl = overload.AdmissionController(3, md_cooldown_s=0.0, ai_step=0.5)
    eng = paged(queue_limit=4, faults=plan, admission=ctl,
                sync_timeout_s=0.1)
    sys_toks = rand_prompt(15, 13)
    eng.register_prefix("sys", sys_toks)
    pinned = len(eng.prefixes["sys"][1])
    reqs = [Request(prompt=rand_prompt(120 + i, 4 + (i % 5)),
                    max_new=6 + (i % 3), prefix="sys" if i % 2 else None)
            for i in range(16)]
    saw_degraded, done = threading.Event(), threading.Event()

    def poll():
        while not done.is_set():
            if not eng.healthz()["ok"]:
                saw_degraded.set()
            time.sleep(0.005)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        done.set()
        poller.join()
    by = {s: sum(1 for r in reqs if r.status == s)
          for s in overload.TERMINAL_STATUSES}
    assert sum(by.values()) == 16
    assert eng.stats["completed"] == by[overload.STATUS_COMPLETED]
    assert eng.stats["shed"] == by[overload.STATUS_SHED]
    assert eng.stats["oom_recoveries"] == 3
    assert saw_degraded.is_set() and eng.healthz()["ok"]
    for r in reqs:
        if r.prefix and r.status == overload.STATUS_COMPLETED:
            assert r.output == offline(sys_toks + r.prompt, r.max_new)
    assert_clean(eng, pinned=pinned)
    eng.drop_prefix("sys")
    assert_clean(eng)
    eng.register_prefix("sys2", sys_toks)
    extra = Request(prompt=rand_prompt(140, 5), max_new=6, prefix="sys2")
    eng.submit(extra)
    eng.run()
    assert extra.output == offline(sys_toks + extra.prompt, 6)


def test_prefix_telemetry_rides_the_snapshot():
    eng = paged()
    eng.register_prefix("sys", rand_prompt(16, 13))
    req = Request(prompt=rand_prompt(17, 5), max_new=8, prefix="sys")
    eng.submit(req)
    eng.step()
    live = eng.telemetry.snapshot()
    assert live[consts.TELEMETRY_PAGES_PINNED] == 2
    assert live[consts.TELEMETRY_PAGES_SHARED] == 1
    assert live[consts.TELEMETRY_PREFIX_HITS] == 1
    assert live[consts.TELEMETRY_COW_COPIES] == 1
    eng.run()
    done = eng.telemetry.snapshot()
    assert done[consts.TELEMETRY_PAGES_SHARED] == 0
    assert done[consts.TELEMETRY_PAGES_PINNED] == 2
    # the engine keeps the most pages shared at once
    assert eng.stats["peak_shared_pages"] == 1
    slot = ServingEngine(PARAMS, CFG, n_slots=1, max_seq=64,
                         prompt_buckets=(8,))
    assert consts.TELEMETRY_PREFIX_HITS not in slot.telemetry.snapshot()


@pytest.mark.parametrize("codec", CODECS)
def test_chat_traffic_replays_on_the_paged_engine(codec):
    """The reference's ``chat`` scenario (sessions behind ``sys0`` /
    ``sys1``) through the paged engine with admission on: every offered
    request ends in one terminal status, every admitted request is a
    prefix hit, and dropping both prefixes leaves the pool empty."""
    eng = PagedServingEngine(PARAMS, CFG, n_lanes=3, max_seq=256,
                             n_pages=40, page_size=16,
                             prompt_buckets=(16, 64), chunk=4,
                             kv_codec=codec,
                             admission=overload.AdmissionController(3))
    events = traffic.generate("chat", seed=0, duration_s=6.0, rate_rps=2.0)
    report = traffic.replay(eng, events, time_scale=0.01, vocab=CFG.vocab,
                            prefix_len=20, max_wall_s=60.0)
    s = eng.stats
    assert report["offered"] == sum(report["statuses"].values()) == (
        s["completed"] + s["shed"] + s["deadline_exceeded"]
        + s["oom_quarantined"]) > 0
    assert s["prefix_hits"] == s["completed"] == report["statuses"].get(
        "completed") and s["cow_copies"] >= s["prefix_hits"]
    assert set(eng.prefixes) == {"sys0", "sys1"}
    for name in ("sys0", "sys1"):
        eng.drop_prefix(name)
    assert_clean(eng)


def test_int8_subscribers_agree_with_inlined_prompts_up_to_the_codec():
    """The smoke's int8 prefix rule, on both packages: with these three
    requests (seed 0) the reference's own int8 subscribers part from the
    same requests with the 13-row prefix inlined, so no token identity
    holds there; each package agrees with its inlined prompts up to a
    near-tie (``chip_smoke.codec_agrees``: at most one request parts, not
    at its first token, every logprob up to the parting step within
    ``INT8_PREFIX_LOGP_TOL``), both part the same requests, and the same
    suffixes behind another prefix fail the rule."""
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, 128, int(rng.integers(3, 20))).tolist(),
              int(rng.integers(4, 24))) for _ in range(3)]
    prefix = rng.integers(0, 128, 13).tolist()
    parted = []
    for make, req_cls in ((jpaged, jserving.Request), (paged, Request)):
        runs = []
        for inlined in (False, True):
            eng = make(kv_codec="int8")
            if not inlined:
                eng.register_prefix("sys", prefix)
            reqs = [req_cls(prompt=prefix + s if inlined else s, max_new=n,
                            prefix=None if inlined else "sys")
                    for s, n in specs]
            for r in reqs:
                eng.submit(r)
            eng.run()
            runs.append(reqs)
        n, first, worst = chip_smoke.agree_up_to_codec(*runs)
        assert chip_smoke.codec_agrees(n, first, worst)
        parted.append(n)
        # the control: the same suffixes behind another prefix fail it
        eng = make(kv_codec="int8")
        eng.register_prefix("other", rng.integers(0, 128, 13).tolist())
        other = [req_cls(prompt=s, max_new=n, prefix="other")
                 for s, n in specs]
        for r in other:
            eng.submit(r)
        eng.run()
        assert not chip_smoke.codec_agrees(
            *chip_smoke.agree_up_to_codec(other, runs[1]))
    assert parted[0] == parted[1] == 1
