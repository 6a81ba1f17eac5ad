"""The port's cross-pool page handoff, held against the reference on the
CPU (the reference's ``tests/test_handoff.py``, every scenario run on
both packages over the same ``bridge``-carried f32 weights):

- ``extract_request`` -> ``install_request`` -> ``detach_request``
  moves every plane byte for byte (an int8 pool's ``q`` and ``s``
  together), the lane's length and live state; the handoff counters,
  allocator snapshots and tokens equal the reference's;
- a layout mismatch raises the reference's contract string; no lane or
  no pages returns None with the destination untouched and the source
  still serving;
- disaggregated fleets (both codecs, prefix subscribers, a spec-armed
  decode engine) give the reference's tokens, router stats and handoff
  counters, and the single engine's;
- prefix replication copies the pins byte for byte, leaves the source
  untouched and serves the source's tokens; its guards refuse as the
  reference's do.

The int8 handoff is held to equal page bytes and to the same request
served unmigrated on an int8 engine — not to the dense offline decode,
which int8 quantization parts from (the reference's own int8 handoff
tests are red for that reason). The port's own readings: the
``install`` fault and a real out-of-memory inside the copy leave the
destination as it was; an install that drops the last page or
requantizes the int8 planes (the controls) fails the byte check; and
where the port parts from the reference — an install gated on the
request's page forecast, so a disaggregated decode pool defers instead
of over-committing. Sampled streams across a handoff are held within the
port in ``tests/test_torch_fleet_cuda.py`` (no JAX there, so its card
test runs on the card's machine).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_fleet_sides as fs  # noqa: E402
from tpushare_torch.workloads import decode, serving  # noqa: E402

CODECS = ("bf16", "int8")


@pytest.fixture(autouse=True)
def _one_thread_and_clean_provider():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    fs.clear_providers()


def both(scenario, *args):
    ref, port = (scenario(side, *args) for side in fs.SIDES)
    assert ref == port
    return port


def live_ids(eng, lane):
    return eng.alloc.table(lane)[:eng._paging.pages_for_rows(
        eng._lengths[lane], eng.alloc.page_size)]


def admitted(side, eng, key, n, max_new, **kw):
    q = fs.req(side, key, n, max_new, **kw)
    eng.submit(q)
    eng._admit_waiting()
    (lane, _), = eng.running.items()
    return q, lane


def one_engine(side, codec, prompt, max_new, **kw):
    e = fs.paged(side, kv_codec=codec)
    q = side.Request(prompt=list(prompt), max_new=max_new, **kw)
    e.submit(q)
    e.run()
    return q


# ---------------------------------------------------------------------------
# extract -> install round trip
# ---------------------------------------------------------------------------

def sc_roundtrip(side, codec):
    src, dst = fs.paged(side, kv_codec=codec), fs.paged(side, kv_codec=codec)
    q, lane = admitted(side, src, 1, 13, 20)
    src_ids = live_ids(src, lane)
    before = side.planes(src, src_ids)
    record = src.extract_request(lane)
    dst_lane = dst.install_request(record)
    dst_ids = dst.alloc.table(dst_lane)
    out = {"bytes_equal": fs.same_bytes(before, side.planes(dst, dst_ids)),
           "n_ids": (len(src_ids), len(dst_ids)),
           "length": dst._lengths[dst_lane], "same_req": dst.running[
               dst_lane] is q, "in": dst.stats["handoffs_in"],
           "dst_alloc": dst.alloc.snapshot()}
    src.detach_request(lane)
    out["out"] = src.stats["handoffs_out"]
    fs.assert_no_leaks(src)
    dst.run()
    fs.assert_no_leaks(dst)
    out["status"] = q.status
    out["tokens"] = q.output
    out["unmigrated"] = one_engine(side, codec, q.prompt, q.max_new).output
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_extract_install_roundtrip_byte_exact(codec):
    got = both(sc_roundtrip, codec)
    assert got["bytes_equal"] and got["same_req"]
    assert got["n_ids"][0] == got["n_ids"][1] and got["length"] == 13
    assert got["in"] == 1 and got["out"] == 1
    assert got["status"] == "completed"
    assert got["tokens"] == got["unmigrated"]
    if codec == "bf16":
        assert got["tokens"] == fs.PORT.offline(fs.prompt(1, 13), 20)


def sc_layout_mismatch(side):
    src = fs.paged(side, kv_codec="int8")
    _, lane = admitted(side, src, 2, 9, 4)
    record = src.extract_request(lane)
    msgs = []
    for dst in (fs.paged(side, kv_codec="bf16"),
                fs.paged(side, page_size=16, kv_codec="int8", n_pages=20)):
        with pytest.raises(ValueError, match="handoff layout mismatch") as e:
            dst.install_request(record)
        msgs.append(str(e.value))
    return msgs


def test_handoff_layout_mismatch_raises():
    both(sc_layout_mismatch)


def sc_install_refused(side):
    src = fs.paged(side)
    dst = fs.paged(side, n_pages=5, n_lanes=1)
    filler = fs.req(side, 3, 8, 8)
    dst.submit(filler)
    dst._admit_waiting()
    q, lane = admitted(side, src, 4, 10, 6)
    record = src.extract_request(lane)
    free_before = dst.alloc.free_pages()
    no_lane = dst.install_request(record)
    free_after = dst.alloc.free_pages()
    dst.run()
    dst2 = fs.paged(side, n_pages=2, n_lanes=2)
    no_pages = dst2.install_request(record)
    src.run()
    return {"no_lane": no_lane, "free": (free_before, free_after),
            "no_pages": no_pages, "dst2_in_use": dst2.alloc.pages_in_use(),
            "status": q.status, "tokens": q.output,
            "snapshots": [e.alloc.snapshot() for e in (src, dst, dst2)]}


def test_install_failure_leaves_destination_clean_and_source_serving():
    got = both(sc_install_refused)
    assert got["no_lane"] is None and got["no_pages"] is None
    assert got["free"][0] == got["free"][1] and got["dst2_in_use"] == 0
    assert got["status"] == "completed"
    assert got["tokens"] == fs.PORT.offline(fs.prompt(4, 10), 6)


# ---------------------------------------------------------------------------
# the port's own readings: faults inside the install, the controls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("how", ["injected", "real"])
def test_install_oom_leaves_destination_exactly_as_before(codec, how,
                                                          monkeypatch):
    src = fs.paged(fs.PORT, kv_codec=codec)
    plan = fs.PORT.Plan()
    dst = fs.paged(fs.PORT, kv_codec=codec, faults=plan)
    other, _ = admitted(fs.PORT, dst, 7, 9, 6)
    q, lane = admitted(fs.PORT, src, 8, 13, 8)
    record = src.extract_request(lane)
    pool = [p.clone() for leaf in (dst.state["k"], dst.state["v"])
            for p in decode.kv_planes(leaf)]
    lanes = {k: v.clone() for k, v in dst.state.items()
             if k not in ("k", "v")}
    snap = dst.alloc.snapshot()
    if how == "injected":
        plan.add("install", fs.PORT.Fault(times=1, kind="oom"))
    else:
        def oom_mid_copy(kp, vp, pk, pv, page_ids):
            kp_planes = decode.kv_planes(kp)
            kp_planes[0][:, page_ids[:1]] = 0        # a first write lands
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        monkeypatch.setattr(serving, "install_request_pages", oom_mid_copy)
    assert dst.install_request(record) is None
    after = dst.alloc.snapshot()
    assert after["install_aborts"] == snap["install_aborts"] + 1
    # every count as before but the abort and the high-water mark the
    # reservation touched
    moved = ("install_aborts", "peak_in_use")
    assert {k: v for k, v in after.items() if k not in moved} == \
        {k: v for k, v in snap.items() if k not in moved}
    for k, v in lanes.items():
        assert torch.equal(dst.state[k], v), k
    if how == "injected":
        planes = [p for leaf in (dst.state["k"], dst.state["v"])
                  for p in decode.kv_planes(leaf)]
        assert all(torch.equal(a, b) for a, b in zip(pool, planes))
    assert dst.stats["handoffs_in"] == 0 and len(dst.running) == 1
    monkeypatch.undo()
    src.run()                                    # the source still owns it
    dst.run()
    assert q.status == other.status == "completed"
    fs.assert_no_leaks(src, dst)


@pytest.mark.parametrize("codec", CODECS)
def test_controls_fail_the_byte_check(codec):
    """Two broken installs the byte check must catch: one that drops the
    request's last page, and (int8) one that installs dense pages
    quantized again instead of copying ``q`` and ``s`` — the pages
    dequantized to bf16 (what a transport of dense pages carries) and
    requantized. (A requantization from f32 is a no-op of the rowwise
    codec: its absmax row element maps to 127 again.)"""
    src, dst = (fs.paged(fs.PORT, kv_codec=codec) for _ in range(2))
    q, lane = admitted(fs.PORT, src, 9, 13, 8)
    src_ids = live_ids(src, lane)
    before = fs.PORT.planes(src, src_ids)
    record = src.extract_request(lane)

    def drop_last(leaf):
        if isinstance(leaf, dict):
            return {p: drop_last(leaf[p]) for p in ("q", "s")}
        out = leaf.clone()
        out[:, -1] = 0
        return out

    broken = {**record, "k": drop_last(record["k"]),
              "v": drop_last(record["v"])}
    lane2 = dst.install_request(broken)
    assert not fs.same_bytes(before,
                             fs.PORT.planes(dst, dst.alloc.table(lane2)))
    dst.cancel_request(lane2)
    if codec == "int8":
        def requantize(leaf):
            dense = decode.kv_dequantize(leaf, torch.bfloat16)
            return decode.kv_quantize(dense.float())
        broken = {**record, "k": requantize(record["k"]),
                  "v": requantize(record["v"])}
        lane3 = dst.install_request(broken)
        assert not fs.same_bytes(
            before, fs.PORT.planes(dst, dst.alloc.table(lane3)))
        dst.cancel_request(lane3)
    lane4 = dst.install_request(record)             # the real one passes
    assert fs.same_bytes(before, fs.PORT.planes(dst, dst.alloc.table(lane4)))
    src.detach_request(lane)
    dst.run()
    fs.assert_no_leaks(src, dst)


# ---------------------------------------------------------------------------
# disaggregated serving
# ---------------------------------------------------------------------------

def sc_disaggregated(side, codec):
    engines = [fs.paged(side, kv_codec=codec) for _ in range(3)]
    r = side.FleetRouter(engines, disaggregate=True)
    reqs = [fs.req(side, 20 + i, 5 + 2 * i, 6 + i) for i in range(6)]
    for q in reqs:
        r.submit(q)
    r.run()
    for e in engines:
        fs.assert_no_leaks(e)
    return {"statuses": fs.statuses(reqs), "tokens": fs.outputs(reqs),
            "oracle": [one_engine(side, codec, q.prompt, q.max_new).output
                       for q in reqs],
            "router": fs.router_view(r)}


@pytest.mark.parametrize("codec", CODECS)
def test_disaggregated_fleet_token_exact(codec):
    got = both(sc_disaggregated, codec)
    assert got["tokens"] == got["oracle"]
    assert all(s == ("completed", True) for s in got["statuses"])
    assert got["router"]["stats"]["handoffs"] >= 6 - 3
    assert got["router"]["handoffs"][0][1] > 0


def sc_disagg_prefix(side):
    sysp = fs.prompt(30, 13)
    oracle = fs.paged(side)
    oracle.register_prefix("sys", sysp)
    oq = side.Request(prompt=fs.prompt(31, 5), max_new=8, prefix="sys")
    oracle.submit(oq)
    oracle.run()
    engines = [fs.paged(side), fs.paged(side)]
    r = side.FleetRouter(engines, disaggregate=True)
    r.register_prefix("sys", sysp)
    qs = [side.Request(prompt=fs.prompt(31, 5), max_new=8, prefix="sys")
          for _ in range(4)]
    for q in qs:
        r.submit(q)
    r.run()
    view = fs.router_view(r)
    r.drop_prefix("sys")
    for e in engines:
        fs.assert_no_leaks(e)
    return {"tokens": fs.outputs(qs), "oracle": oq.output,
            "statuses": fs.statuses(qs), "router": view}


def test_disaggregated_prefix_subscribers_token_exact():
    got = both(sc_disagg_prefix)
    assert all(t == got["oracle"] for t in got["tokens"])
    assert got["router"]["stats"]["handoffs"] == 4


def sc_disagg_spec(side):
    prefill = fs.paged(side)
    dec = fs.paged(side, draft=(side.params, side.cfg, 3))
    r = side.FleetRouter([prefill, dec], disaggregate=True)
    reqs = [fs.req(side, 40 + i, 6, 12) for i in range(3)]
    for q in reqs:
        r.submit(q)
    r.run()
    fs.assert_no_leaks(prefill, dec)
    assert dec._dalloc.pages_in_use() == 0
    return {"tokens": fs.outputs(reqs), "statuses": fs.statuses(reqs),
            "spec_rounds": dec.stats["spec_rounds"],
            "router": fs.router_view(r)}


def test_disaggregated_into_spec_armed_decode_engine():
    got = both(sc_disagg_spec)
    assert got["spec_rounds"] > 0
    assert got["tokens"] == [fs.PORT.offline(fs.prompt(40 + i, 6), 12)
                             for i in range(3)]


# ---------------------------------------------------------------------------
# pinned-prefix replication
# ---------------------------------------------------------------------------

def sc_replication(side, codec):
    sysp = fs.prompt(50, 13)
    src, dst = fs.paged(side, kv_codec=codec), fs.paged(side, kv_codec=codec)
    src.register_prefix("sys", sysp)
    plen, ids = src.prefixes["sys"]
    before = side.planes(src, ids)
    refs = [src.alloc.refcount(p) for p in ids]
    dst.install_prefix_pages("sys", sysp, src.extract_prefix("sys"))
    plen2, ids2 = dst.prefixes["sys"]
    out = {"src_untouched": fs.same_bytes(before, side.planes(src, ids)),
           "refs": refs == [src.alloc.refcount(p) for p in ids],
           "src_reg": src.prefixes["sys"] == (plen, list(ids)),
           "replica": fs.same_bytes(before, side.planes(dst, ids2)),
           "plen": (plen, plen2), "dst_alloc": dst.alloc.snapshot()}
    outs = []
    for eng in (src, dst):
        q = side.Request(prompt=fs.prompt(51, 5), max_new=8, prefix="sys")
        eng.submit(q)
        eng.run()
        outs.append((q.status, q.output))
        eng.drop_prefix("sys")
        fs.assert_no_leaks(eng)
    out["served"] = outs
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_prefix_replication_source_untouched_and_exact(codec):
    got = both(sc_replication, codec)
    assert got["src_untouched"] and got["refs"] and got["src_reg"]
    assert got["replica"] and got["plen"][0] == got["plen"][1]
    assert got["served"][0] == got["served"][1]
    assert got["served"][0][0] == "completed"


def sc_replication_guards(side):
    sysp = fs.prompt(52, 13)
    src = fs.paged(side)
    src.register_prefix("sys", sysp)
    record = src.extract_prefix("sys")
    errs = []
    with pytest.raises(ValueError, match="do not match") as e:
        fs.paged(side).install_prefix_pages("sys", sysp + [1], record)
    errs.append(str(e.value))
    tiny = fs.paged(side, n_pages=2)
    with pytest.raises(side.paging.PagePoolExhausted):
        tiny.install_prefix_pages("sys", sysp, record)
    with pytest.raises(ValueError, match="unknown prefix") as e:
        src.extract_prefix("nope")
    errs.append(str(e.value))
    return {"errs": errs, "tiny": ("sys" in tiny.prefixes,
                                   tiny.alloc.pages_in_use())}


def test_prefix_replication_guards():
    got = both(sc_replication_guards)
    assert got["tiny"] == (False, 0)


# ---------------------------------------------------------------------------
# where the port parts from the reference: a handoff's page forecast
# ---------------------------------------------------------------------------

def sc_overcommit(side):
    prefill = fs.paged(side)
    dec = fs.paged(side, n_pages=12)            # 11 usable pages of 8 rows
    r = side.FleetRouter([prefill, dec], disaggregate=True)
    reqs = [fs.req(side, 200 + i, 10, 30) for i in range(3)]
    for q in reqs:
        r.submit(q)
    r.run()
    fs.assert_no_leaks(prefill, dec)
    return {"statuses": [q.status for q in reqs],
            "evictions": dec.stats["page_evictions"],
            "exact": [q.output == fs.PORT.offline(q.prompt, q.max_new)
                      for q in reqs if q.status == "completed"]}


def test_install_forecast_defers_instead_of_overcommitting():
    """Three 40-row requests (5 pages each at full growth) handed into an
    11-page decode pool: the reference's install reserves only the rows
    a request holds now, over-commits the pool and evicts a lane
    mid-decode (``oom_quarantined``); the port's install gates on the
    request's page forecast net of the growth promised to running lanes
    (the admission rule), so the third request waits on its prefill lane
    and all three complete with the offline tokens."""
    ref, port = sc_overcommit(fs.REF), sc_overcommit(fs.PORT)
    assert "oom_quarantined" in ref["statuses"] and ref["evictions"] > 0
    assert port["statuses"] == ["completed"] * 3
    assert port["evictions"] == 0 and all(port["exact"])
