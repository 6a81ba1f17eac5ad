"""The port's wire codec, held against the reference on the CPU (the
reference's ``tests/test_wirecodec.py``):

- the jax-free layer is the reference's byte for byte: the golden
  frame, ``encode_frame`` / ``encode_value`` / ``encode_request`` /
  ``encode_probe`` give the reference's bytes for the same inputs, and
  each package decodes the other's;
- the port's own plane and generator encoding round-trips byte-stably
  on both pool codecs (bf16 planes as their 16-bit view, int8 ``q`` and
  ``s`` together, the generator as its ``get_state()`` bytes); a decoded
  record installs the same page bytes and finishes with the reference's
  tokens;
- decode is total on the port's own handoff frames: truncation at every
  offset, a bit flip at every offset, length lies, version skew, bad
  magic, streaming cuts, seeded fuzz — a typed ``WireError`` or a
  complete record, never an exception; a corrupt install through
  ``EngineHost`` touches nothing.
"""

import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_sides as fs  # noqa: E402

W = fs.PORT.wirecodec
JW = fs.REF.wirecodec
C = fs.PORT.consts
CODECS = ("bf16", "int8")

_GOLDEN_VALUE = {"op": "probe", "seq": 7, "ok": True, "load": 0.5,
                 "tags": ["a", b"\x00\xff"], "none": None}
# the reference's pinned frame (tests/test_wirecodec.py)
_GOLDEN_FRAME_HEX = (
    "5450535700010003000000600800000006000000046c6f6164043fe000000000"
    "0000000000046e6f6e6500000000026f6b02000000026f70050000000570726f"
    "6265000000037365710300000000000000070000000474616773070000000205"
    "0000000161060000000200ff351e18ab")


@pytest.fixture(autouse=True)
def _one_thread_and_clean_provider():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    fs.clear_providers()


def extract_record(side, codec, seed=1, plen=13, max_new=20):
    src = fs.paged(side, kv_codec=codec)
    q = fs.req(side, seed, plen, max_new)
    src.submit(q)
    src._admit_waiting()
    (lane, _), = src.running.items()
    return src, lane, src.extract_request(lane)


# ---------------------------------------------------------------------------
# the jax-free layer: the reference's bytes
# ---------------------------------------------------------------------------

def test_golden_frame_bytes_pinned():
    frame = W.encode_frame(W.KIND_PROBE, W.encode_value(_GOLDEN_VALUE))
    assert frame.hex() == _GOLDEN_FRAME_HEX
    kind, payload = W.decode_frame(bytes.fromhex(_GOLDEN_FRAME_HEX))
    assert kind == W.KIND_PROBE
    assert W.decode_value(payload) == _GOLDEN_VALUE


VALUES = [None, True, False, 0, -1, 2 ** 62, 0.25, -1e300, "", "fleet",
          "ünï", b"", b"\x00\x01", [], [1, [2, [3]]], {},
          {"z": 1, "a": [None, 2.5], "m": {"k": b"v"}}, _GOLDEN_VALUE]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_value_and_frame_bytes_equal_the_reference(value):
    raw = W.encode_value(value)
    assert raw == JW.encode_value(value)
    assert W.decode_value(JW.encode_value(value)) == value
    for kind in W.FRAME_KINDS:
        assert W.encode_frame(kind, raw) == JW.encode_frame(kind, raw)
    assert W.encode_probe({"v": value}) == JW.encode_probe({"v": value})


def test_value_encoding_is_deterministic():
    a = {"x": 1, "y": [2.5, None, True], "z": {"k": b"b"}}
    b = {"z": {"k": b"b"}, "y": [2.5, None, True], "x": 1}
    assert W.encode_value(a) == W.encode_value(b)
    assert W.decode_value(W.encode_value(a)) == a


@pytest.mark.parametrize("kw", [
    dict(), dict(eos=5, temperature=0.7, top_p=0.9, deadline_s=1.5),
    dict(prefix="sys", output=[4, 9], logprobs=[-0.25, -1.5], done=True,
         status="completed")])
def test_request_bytes_equal_the_reference(kw):
    base = dict(prompt=[1, 2, 3], max_new=8)
    port = fs.PORT.Request(**base, **kw)
    ref = fs.REF.Request(**base, **kw)
    raw = W.encode_request(port)
    assert raw == JW.encode_request(ref)
    got = W.decode_request(JW.encode_request(ref))
    for field in ("prompt", "max_new", "eos", "prefix", "temperature",
                  "top_p", "output", "logprobs", "done", "deadline_s",
                  "status"):
        assert getattr(got, field) == getattr(port, field), field
    assert isinstance(got, fs.PORT.Request)
    assert b"_deadline" not in raw and b"_trace" not in raw


def test_probe_roundtrip():
    snap = {C.TELEMETRY_QUEUE_DEPTH: 3, "nested": {"p50": 0.25}}
    assert W.decode_probe(W.encode_probe(snap)) == snap
    bad = W.decode_probe(W.encode_value([1, 2]))
    assert W.is_wire_error(bad) and bad.kind == C.WIRE_FAULT_GARBAGE


def test_engine_snapshot_travels_as_a_probe():
    """A port engine's live telemetry snapshot and stats encode (the
    host ships both on every healthz)."""
    eng = fs.paged(fs.PORT)
    q = fs.req(fs.PORT, 3, 5, 4)
    eng.submit(q)
    eng.run()
    doc = {"snapshot": eng.telemetry.snapshot(), "stats": eng.stats}
    assert W.decode_probe(W.encode_probe(doc)) == doc


# ---------------------------------------------------------------------------
# the port's planes and generator state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_handoff_roundtrip_byte_stable(codec):
    tokens = []
    for side in fs.SIDES:
        src, lane, record = extract_record(side, codec)
        wire = side.wirecodec.encode_handoff(record)
        assert side.wirecodec.encode_handoff(record) == wire
        got = side.wirecodec.decode_handoff(wire)
        assert not side.wirecodec.is_wire_error(got)
        assert side.wirecodec.encode_handoff(got) == wire
        ids = src.alloc.table(lane)[:src._paging.pages_for_rows(
            src._lengths[lane], src.alloc.page_size)]
        before = side.planes(src, ids)
        dst = fs.paged(side, kv_codec=codec)
        dst_lane = dst.install_request(got)
        assert fs.same_bytes(before,
                             side.planes(dst, dst.alloc.table(dst_lane)))
        src.detach_request(lane)
        dst.run()
        assert got["req"].status == "completed"
        tokens.append(got["req"].output)
        if side is fs.PORT and codec == "int8":
            assert isinstance(got["k"], dict)
            assert got["k"]["q"].dtype == torch.int8
            assert got["k"]["s"].dtype == torch.float32
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "int8", "uint8"])
def test_planes_travel_bit_exact(dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    if dt.is_floating_point:
        t = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(
            np.float32)).to(dt)
        t.view(-1)[0] = float("nan")
    else:
        info = torch.iinfo(dt)
        t = torch.from_numpy(rng.integers(info.min, info.max, (2, 3, 4),
                                          dtype=np.int64)).to(dt)
    out = bytearray()
    W._enc_plane(out, t)
    got = W._dec_plane(W._Reader(bytes(out)))
    assert got.dtype == dt and got.shape == t.shape
    # compared as same-width integers: bit for bit, the NaN included
    raw = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.float32: torch.int32}
    assert torch.equal(got.view(raw.get(dt, dt)), t.view(raw.get(dt, dt)))


def test_generator_state_travels_and_continues_the_stream():
    g = torch.Generator()
    g.manual_seed(11)
    torch.rand(5, generator=g)
    src, lane, record = extract_record(fs.PORT, "bf16")
    record = {**record, "generator": g.get_state()}
    got = W.decode_handoff(W.encode_handoff(record))
    g2 = torch.Generator()
    g2.set_state(got["generator"])
    assert torch.equal(torch.rand(8, generator=g), torch.rand(8,
                                                              generator=g2))
    src.detach_request(lane)


def test_decode_lands_planes_on_the_named_device():
    src, lane, record = extract_record(fs.PORT, "int8")
    got = W.decode_handoff(W.encode_handoff(record), device="cpu")
    assert got["k"]["q"].device.type == "cpu"
    name, tokens, prefix = W.decode_prefix(
        W.encode_prefix("p", [1, 2], {**record, "plen": 2}), device="cpu")
    assert (name, tokens) == ("p", [1, 2])
    assert prefix["v"]["s"].device.type == "cpu"
    src.detach_request(lane)


@pytest.mark.parametrize("codec", CODECS)
def test_prefix_roundtrip_byte_stable(codec):
    src = fs.paged(fs.PORT, kv_codec=codec)
    tokens = fs.prompt(3, 16)
    src.register_prefix("sys", tokens)
    record = src.extract_prefix("sys")
    wire = W.encode_prefix("sys", tokens, record)
    assert W.encode_prefix("sys", tokens, record) == wire
    name, got_tokens, got_record = W.decode_prefix(wire)
    assert (name, got_tokens) == ("sys", tokens)
    assert W.encode_prefix(name, got_tokens, got_record) == wire
    dst = fs.paged(fs.PORT, kv_codec=codec)
    dst.install_prefix_pages(name, got_tokens, got_record)
    assert fs.same_bytes(fs.PORT.planes(src, src.prefixes["sys"][1]),
                         fs.PORT.planes(dst, dst.prefixes["sys"][1]))


# ---------------------------------------------------------------------------
# total decode
# ---------------------------------------------------------------------------

def _assert_typed(err):
    assert W.is_wire_error(err), f"decoded a corrupt frame: {err!r}"
    assert err.kind in C.WIRE_FAULT_KINDS, err


def _handoff_frame(codec):
    src, lane, record = extract_record(fs.PORT, codec, plen=9)
    g = torch.Generator()
    g.manual_seed(3)
    record = {**record, "generator": g.get_state()}
    src.detach_request(lane)
    return W.encode_frame(W.KIND_HANDOFF, W.encode_handoff(record))


@pytest.mark.parametrize("codec", CODECS)
def test_handoff_frame_truncated_at_every_offset(codec):
    frame = _handoff_frame(codec)
    for cut in range(0, len(frame), 7):
        _assert_typed(W.decode_frame(frame[:cut]))


@pytest.mark.parametrize("codec", CODECS)
def test_handoff_frame_bit_flip_at_every_offset_is_typed(codec):
    frame = _handoff_frame(codec)
    rng = np.random.default_rng(20)
    for pos in range(0, len(frame), 3):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(8))
        _assert_typed(W.decode_frame(bytes(bad)))


def test_frame_length_lie_and_version_skew():
    payload = W.encode_value(_GOLDEN_VALUE)
    frame = W.encode_frame(W.KIND_PROBE, payload)
    head = struct.Struct(">4sHHI")
    lie = head.pack(W.MAGIC, W.VERSION, W.KIND_PROBE,
                    C.FLEET_WIRE_MAX_FRAME_MIB * (1 << 20) + 1)
    assert W.decode_frame(lie + frame[head.size:]).kind == \
        C.WIRE_FAULT_OVER_LENGTH
    lie = head.pack(W.MAGIC, W.VERSION, W.KIND_PROBE, len(payload) - 3)
    assert W.decode_frame(lie + frame[head.size:]).kind == \
        C.WIRE_FAULT_TRUNCATED
    skew = head.pack(W.MAGIC, W.VERSION + 1, W.KIND_PROBE, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(skew))
    assert W.decode_frame(skew + payload + struct.pack(">I", crc)).kind \
        == C.WIRE_FAULT_VERSION
    assert W.decode_frame(b"NOPE" + frame[4:]).kind == C.WIRE_FAULT_BAD_MAGIC


def test_read_frame_streaming_faults():
    frame = _handoff_frame("int8")

    def recv_from(buf):
        view = {"data": buf}

        def recv(n):
            chunk = view["data"][:n]
            view["data"] = view["data"][len(chunk):]
            return chunk
        return recv

    kind, _ = W.read_frame(recv_from(frame))
    assert kind == W.KIND_HANDOFF
    assert W.read_frame(recv_from(b"")).kind == C.WIRE_FAULT_CUT
    assert W.read_frame(recv_from(frame[:7])).kind == C.WIRE_FAULT_TRUNCATED
    assert W.read_frame(recv_from(frame[:-5])).kind == \
        C.WIRE_FAULT_TRUNCATED
    head = struct.Struct(">4sHHI").pack(
        W.MAGIC, W.VERSION, W.KIND_HANDOFF,
        C.FLEET_WIRE_MAX_FRAME_MIB * (1 << 20) + 1)
    reads = []

    def counting_recv(n):
        reads.append(n)
        return recv_from(head)(n) if len(reads) == 1 else b""

    assert W.read_frame(counting_recv).kind == C.WIRE_FAULT_OVER_LENGTH
    assert len(reads) == 1


@pytest.mark.parametrize("codec", CODECS)
def test_fuzzed_handoff_payload_is_total(codec):
    src, lane, record = extract_record(fs.PORT, codec)
    g = torch.Generator()
    g.manual_seed(4)
    wire = W.encode_handoff({**record, "generator": g.get_state()})
    keys = {"req", "length", "k", "v", "generator", "kv_codec",
            "page_size", "mesh_tp", "mesh_pp"}
    for cut in range(0, len(wire), 97):
        _assert_typed(W.decode_handoff(wire[:cut]))
    rng = np.random.default_rng(2020)
    for _ in range(96):
        pos = int(rng.integers(len(wire)))
        bad = bytearray(wire)
        bad[pos] ^= 1 << int(rng.integers(8))
        got = W.decode_handoff(bytes(bad))
        if W.is_wire_error(got):
            assert got.kind in C.WIRE_FAULT_KINDS
        else:
            assert set(got) == keys
    src.detach_request(lane)


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_install_leaves_engine_untouched(codec):
    src, lane, record = extract_record(fs.PORT, codec)
    wire = W.encode_handoff(record)
    host = fs.PORT.remote.EngineHost(fs.paged(fs.PORT, kv_codec=codec))
    eng = host.engine
    try:
        length_lie = bytearray(wire)
        length_lie[0] ^= 0x80
        bad_tag = bytearray(wire)
        bad_tag[4] ^= 0xFF
        corruptions = [wire[:len(wire) // 2], b"", b"\x00" * 64,
                       bytes(length_lie), bytes(bad_tag)]
        for n, blob in enumerate(corruptions):
            _assert_typed(W.decode_handoff(blob))
            with pytest.raises(fs.PORT.transport.TransportError) as e:
                host._op_install({"rid": f"r{n}", "handoff": blob})
            assert e.value.kind in C.WIRE_FAULT_KINDS
        assert eng.alloc.pages_in_use() == 0 and eng.alloc.leaked() == 0
        assert eng.stats["handoffs_in"] == 0
        assert not eng.running and not eng.queue
    finally:
        host.close()
    src.detach_request(lane)
