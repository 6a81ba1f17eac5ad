"""Wire codec of the cross-process fleet — the port of
``tpushare/workloads/wirecodec.py``.

One versioned, length-prefixed, CRC-framed binary encoding for every
byte that crosses a fleet process boundary: the handoff record (pages,
lane length, the sampling generator's state, the pool layout), the
pinned-prefix replication record, a compact telemetry probe frame, and
the RPC envelopes the transport speaks. Frames, the value encoding,
requests and probes are the reference's byte for byte (a test holds the
two packages to the same bytes). Planes and generator state are the
port's own: a bf16 plane travels as its 16-bit view under the dtype
name ``bfloat16``, an int8 pool leaf as its ``q`` and ``s`` planes
under one marker (never transcoded), and a ``torch.Generator`` as its
``get_state()`` bytes; decoding lands planes on the device the caller
names (the destination engine's).

Decode is total: a truncated, bit-flipped, over-length or
version-skewed frame returns a typed :class:`WireError` — never a raised
exception, never a partial object. Encoding is deterministic
(struct-packed, dict keys sorted, no pickle, no timestamps).
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import torch

from tpushare_torch import consts

MAGIC = b"TPSW"
VERSION = 1
_HEADER = struct.Struct(">4sHHI")    # magic, version, kind, payload len
_CRC = struct.Struct(">I")
HEADER_BYTES = _HEADER.size
FRAME_OVERHEAD = _HEADER.size + _CRC.size

# Frame kinds — the u16 discriminator in every frame header.
KIND_HANDOFF = 1
KIND_PREFIX = 2
KIND_PROBE = 3
KIND_RPC_REQUEST = 4
KIND_RPC_RESPONSE = 5
FRAME_KINDS = (KIND_HANDOFF, KIND_PREFIX, KIND_PROBE,
               KIND_RPC_REQUEST, KIND_RPC_RESPONSE)

# Generic-value tags (the RPC/probe payload encoding). Dict keys are
# sorted at encode so identical values yield identical bytes.
_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_STR, _T_BYTES, _T_LIST, _T_DICT = 5, 6, 7, 8
_MAX_DEPTH = 16
_MAX_ITEMS = 1 << 20

# Array-plane markers inside handoff/prefix records: a bare array
# (bf16 codec) or the int8 codec's quantized+scale plane pair — the q
# and s planes travel in ONE marker so they can never be transcoded or
# split across frames.
_PLANE_ARRAY = 0
_PLANE_QS = 1


def _max_payload() -> int:
    return consts.FLEET_WIRE_MAX_FRAME_MIB * (1 << 20)


@dataclasses.dataclass(frozen=True)
class WireError:
    """Typed decode failure. NOT an exception — decode returns it, so a
    hostile or damaged frame can never unwind a receiver mid-install.
    ``kind`` is one of consts.WIRE_FAULT_KINDS (the {kind} label on
    tpushare_fleet_wire_faults_total)."""
    kind: str
    detail: str = ""


def is_wire_error(obj: object) -> bool:
    return isinstance(obj, WireError)


# ---------------------------------------------------------------------------
# Framing — the ONE length-prefix + CRC reader/writer pair.
# ---------------------------------------------------------------------------

def encode_frame(kind: int, payload: bytes) -> bytes:
    """Frame ``payload``: header (magic, version, kind, length) +
    payload + CRC32 over header+payload."""
    if len(payload) > _max_payload():
        raise ValueError(
            f"payload {len(payload)} bytes exceeds the "
            f"{consts.FLEET_WIRE_MAX_FRAME_MIB} MiB frame cap")
    head = _HEADER.pack(MAGIC, VERSION, kind, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(head))
    return head + payload + _CRC.pack(crc)


def decode_frame(data: bytes) -> "tuple[int, bytes] | WireError":
    """Total decode of one whole frame buffer -> (kind, payload)."""
    if len(data) < FRAME_OVERHEAD:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         f"frame is {len(data)} bytes, "
                         f"header+crc need {FRAME_OVERHEAD}")
    magic, version, kind, plen = _HEADER.unpack_from(data)
    if magic != MAGIC:
        return WireError(consts.WIRE_FAULT_BAD_MAGIC, repr(magic))
    if version != VERSION:
        return WireError(consts.WIRE_FAULT_VERSION,
                         f"frame v{version}, this codec speaks "
                         f"v{VERSION}")
    if plen > _max_payload():
        return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                         f"length field claims {plen} bytes")
    if len(data) != FRAME_OVERHEAD + plen:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         f"length field claims {plen} payload bytes, "
                         f"buffer carries {len(data) - FRAME_OVERHEAD}")
    payload = data[HEADER_BYTES:HEADER_BYTES + plen]
    (crc,) = _CRC.unpack_from(data, HEADER_BYTES + plen)
    want = zlib.crc32(payload, zlib.crc32(data[:HEADER_BYTES]))
    if crc != want:
        return WireError(consts.WIRE_FAULT_CRC,
                         f"crc {crc:#010x} != computed {want:#010x}")
    if kind not in FRAME_KINDS:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"unknown frame kind {kind}")
    return kind, payload


def read_frame(recv) -> "tuple[int, bytes] | WireError":
    """Streaming half of the pair: pull exactly one frame through
    ``recv(n) -> bytes`` (a socket-style partial read). A peer that
    closes mid-frame yields a typed ``truncated``; an over-length or
    version-skewed header is rejected BEFORE the payload is read, so a
    corrupt length field can never make the receiver buffer garbage.
    I/O exceptions (timeouts, resets) propagate — they are transport
    faults, not frame faults, and the transport classifies them."""
    head = _read_exact(recv, HEADER_BYTES)
    if head is None or len(head) < HEADER_BYTES:
        if head is None or not head:
            return WireError(consts.WIRE_FAULT_CUT,
                            "connection closed before a frame header")
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         f"header cut at {len(head)}/{HEADER_BYTES}")
    magic, version, kind, plen = _HEADER.unpack(head)
    if magic != MAGIC:
        return WireError(consts.WIRE_FAULT_BAD_MAGIC, repr(magic))
    if version != VERSION:
        return WireError(consts.WIRE_FAULT_VERSION,
                         f"frame v{version}, this codec speaks "
                         f"v{VERSION}")
    if plen > _max_payload():
        return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                         f"length field claims {plen} bytes")
    body = _read_exact(recv, plen + _CRC.size)
    if body is None or len(body) < plen + _CRC.size:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         "payload cut mid-frame")
    return decode_frame(head + body)


def write_frame(send, kind: int, payload: bytes) -> int:
    """Streaming write half: frame and push through ``send(bytes)``
    (sendall-style). Returns the frame's total wire bytes."""
    frame = encode_frame(kind, payload)
    send(frame)
    return len(frame)


def _read_exact(recv, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = recv(n - len(buf))
        if not chunk:
            return buf if buf else None
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# Generic value payloads (RPC envelopes + probe frames).
# ---------------------------------------------------------------------------

def encode_value(value) -> bytes:
    """Deterministically encode a JSON-shaped value (None/bool/int/
    float/str/bytes/list/dict-with-str-keys). Dict keys sort at encode,
    so equal values always encode to equal bytes."""
    out = bytearray()
    _enc_value(out, value, 0)
    return bytes(out)


def decode_value(payload: bytes) -> "object | WireError":
    """Total decode of :func:`encode_value` bytes."""
    try:
        r = _Reader(payload)
        value = _dec_value(r, 0)
        if isinstance(value, WireError):
            return value
        if r.pos != len(payload):
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             f"{len(payload) - r.pos} trailing bytes")
        return value
    except _Truncated:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         "value payload ends mid-field")
    except Exception as e:                      # total by construction
        return WireError(consts.WIRE_FAULT_GARBAGE, f"{e!r}")


def _enc_value(out: bytearray, value, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("value nests deeper than the wire allows")
    if value is None:
        out.append(_T_NONE)
    elif value is True:
        out.append(_T_TRUE)
    elif value is False:
        out.append(_T_FALSE)
    elif isinstance(value, int):
        out.append(_T_INT)
        out += struct.pack(">q", value)
    elif isinstance(value, float):
        out.append(_T_FLOAT)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(_T_STR)
        out += struct.pack(">I", len(raw))
        out += raw
    elif isinstance(value, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += struct.pack(">I", len(value))
        out += value
    elif isinstance(value, (list, tuple)):
        out.append(_T_LIST)
        out += struct.pack(">I", len(value))
        for item in value:
            _enc_value(out, item, depth + 1)
    elif isinstance(value, dict):
        out.append(_T_DICT)
        out += struct.pack(">I", len(value))
        for k in sorted(value):
            if not isinstance(k, str):
                raise TypeError(f"wire dict keys must be str, got "
                                f"{type(k).__name__}")
            raw = k.encode("utf-8")
            out += struct.pack(">I", len(raw))
            out += raw
            _enc_value(out, value[k], depth + 1)
    else:
        raise TypeError(f"type {type(value).__name__} does not travel "
                        f"on the wire")


class _Truncated(Exception):
    pass


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise _Truncated()
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))


_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U8 = struct.Struct(">B")


def _dec_value(r: _Reader, depth: int):
    if depth > _MAX_DEPTH:
        return WireError(consts.WIRE_FAULT_GARBAGE, "nesting too deep")
    (tag,) = r.unpack(_U8)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.unpack(_I64)[0]
    if tag == _T_FLOAT:
        return r.unpack(_F64)[0]
    if tag in (_T_STR, _T_BYTES):
        (n,) = r.unpack(_U32)
        if n > _max_payload():
            return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                             f"string field claims {n} bytes")
        raw = r.take(n)
        if tag == _T_BYTES:
            return raw
        return raw.decode("utf-8")
    if tag == _T_LIST:
        (n,) = r.unpack(_U32)
        if n > _MAX_ITEMS:
            return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                             f"list field claims {n} items")
        items = []
        for _ in range(n):
            item = _dec_value(r, depth + 1)
            if isinstance(item, WireError):
                return item
            items.append(item)
        return items
    if tag == _T_DICT:
        (n,) = r.unpack(_U32)
        if n > _MAX_ITEMS:
            return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                             f"dict field claims {n} items")
        d = {}
        for _ in range(n):
            (kn,) = r.unpack(_U32)
            if kn > _max_payload():
                return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                                 f"dict key claims {kn} bytes")
            key = r.take(kn).decode("utf-8")
            item = _dec_value(r, depth + 1)
            if isinstance(item, WireError):
                return item
            d[key] = item
        return d
    return WireError(consts.WIRE_FAULT_GARBAGE, f"unknown tag {tag}")


# ---------------------------------------------------------------------------
# Tensors, KV planes and generator state. A tensor travels as dtype name,
# shape and its raw little-endian bytes (a bf16 tensor through its int16
# view); an int8 pool leaf's q and s planes travel under one marker.
# ---------------------------------------------------------------------------

# the pools' dtypes (a model dtype, an int8 leaf's q and s) and the
# generator state's bytes
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "int8": torch.int8,
                "uint8": torch.uint8}
_DTYPE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}
# a tensor's raw bytes are read through a same-width integer view, so
# bf16 (which no host array library spells) travels as its 16-bit view
_RAW_VIEWS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _enc_array(out: bytearray, t: torch.Tensor) -> None:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"dtype {t.dtype} does not travel on the wire")
    host = t.detach().contiguous().cpu()
    view = host.view(_RAW_VIEWS.get(t.dtype, t.dtype))
    raw = view.numpy().tobytes()                 # C order, deterministic
    nm = name.encode("ascii")
    out += _U8.pack(len(nm))
    out += nm
    out += _U8.pack(host.ndim)
    for dim in host.shape:
        out += _U32.pack(dim)
    out += _U32.pack(len(raw))
    out += raw


def _dec_array(r: _Reader, device="cpu"):
    (nlen,) = r.unpack(_U8)
    name = r.take(nlen).decode("ascii")
    dtype = _WIRE_DTYPES.get(name)
    if dtype is None:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"unknown dtype {name!r}")
    (ndim,) = r.unpack(_U8)
    if ndim > 8:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"array claims {ndim} dims")
    shape = tuple(r.unpack(_U32)[0] for _ in range(ndim))
    (nbytes,) = r.unpack(_U32)
    if nbytes > _max_payload():
        return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                         f"array field claims {nbytes} bytes")
    want = dtype.itemsize
    for dim in shape:
        want *= dim
    if want != nbytes:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"array {name}{shape} needs {want} bytes, "
                         f"frame carries {nbytes}")
    raw = r.take(nbytes)
    if not nbytes:
        return torch.empty(shape, dtype=dtype, device=device)
    flat = torch.frombuffer(bytearray(raw),
                            dtype=_RAW_VIEWS.get(dtype, dtype))
    return flat.view(dtype).reshape(shape).to(device)


def _enc_plane(out: bytearray, plane) -> None:
    if isinstance(plane, dict):
        out += _U8.pack(_PLANE_QS)
        _enc_array(out, plane["q"])
        _enc_array(out, plane["s"])
    else:
        out += _U8.pack(_PLANE_ARRAY)
        _enc_array(out, plane)


def _dec_plane(r: _Reader, device="cpu"):
    (marker,) = r.unpack(_U8)
    if marker == _PLANE_ARRAY:
        return _dec_array(r, device)
    if marker == _PLANE_QS:
        q = _dec_array(r, device)
        if isinstance(q, WireError):
            return q
        s = _dec_array(r, device)
        if isinstance(s, WireError):
            return s
        return {"q": q, "s": s}
    return WireError(consts.WIRE_FAULT_GARBAGE,
                     f"unknown plane marker {marker}")


# a greedy lane carries no generator
_GEN_NONE = 0
_GEN_STATE = 1


def _enc_generator(out: bytearray, state) -> None:
    """A sampling lane's ``torch.Generator.get_state()`` (a CPU uint8
    tensor: the CPU generator's Mersenne state, or a CUDA generator's
    seed and Philox offset), or None."""
    if state is None:
        out += _U8.pack(_GEN_NONE)
        return
    if state.dtype != torch.uint8:
        raise TypeError("a generator travels as its get_state() bytes")
    out += _U8.pack(_GEN_STATE)
    _enc_array(out, state)


def _dec_generator(r: _Reader):
    (marker,) = r.unpack(_U8)
    if marker == _GEN_NONE:
        return None
    if marker != _GEN_STATE:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"unknown generator marker {marker}")
    state = _dec_array(r)                        # set_state takes CPU bytes
    if isinstance(state, WireError):
        return state
    if state.dtype != torch.uint8 or state.ndim != 1:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"generator state {state.dtype}{tuple(state.shape)}")
    return state


# ---------------------------------------------------------------------------
# Request sub-record. `_deadline` (absolute monotonic — meaningless in
# another process) and `_trace` (host-local buffer) do NOT travel: the
# receiver re-stamps the deadline from deadline_s at submit and attaches
# its own trace.
# ---------------------------------------------------------------------------

def encode_request(req) -> bytes:
    """Encode one Request's wire-portable fields (everything except
    ``_deadline``/``_trace``)."""
    return encode_value({
        "prompt": [int(t) for t in req.prompt],
        "max_new": int(req.max_new),
        "eos": None if req.eos is None else int(req.eos),
        "prefix": req.prefix,
        "temperature": float(req.temperature),
        "top_p": float(req.top_p),
        "output": [int(t) for t in req.output],
        "logprobs": [float(v) for v in req.logprobs],
        "done": bool(req.done),
        "deadline_s": (None if req.deadline_s is None
                       else float(req.deadline_s)),
        "status": req.status,
    })


def decode_request(payload: bytes):
    """Total decode of :func:`encode_request` -> Request | WireError."""
    from tpushare_torch.workloads.serving import Request
    body = decode_value(payload)
    if isinstance(body, WireError):
        return body
    if not isinstance(body, dict):
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         "request field is not a record")
    try:
        return Request(
            prompt=[int(t) for t in body["prompt"]],
            max_new=int(body["max_new"]),
            eos=None if body["eos"] is None else int(body["eos"]),
            prefix=body["prefix"],
            temperature=float(body["temperature"]),
            top_p=float(body["top_p"]),
            output=[int(t) for t in body["output"]],
            logprobs=[float(v) for v in body["logprobs"]],
            done=bool(body["done"]),
            deadline_s=(None if body["deadline_s"] is None
                        else float(body["deadline_s"])),
            status=body["status"],
        )
    except (KeyError, TypeError, ValueError) as e:
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         f"request record rejected: {e!r}")


def _enc_request(out: bytearray, req) -> None:
    raw = encode_request(req)
    out += _U32.pack(len(raw))
    out += raw


def _dec_request(r: _Reader):
    (n,) = r.unpack(_U32)
    if n > _max_payload():
        return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                         f"request field claims {n} bytes")
    return decode_request(r.take(n))


# ---------------------------------------------------------------------------
# Record codecs. Each returns payload BYTES (frame with the matching
# KIND_* to put them on a wire) and decodes totally.
# ---------------------------------------------------------------------------

def encode_handoff(record: dict) -> bytes:
    """Encode an ``extract_request`` handoff record (serving.py): req,
    live length, K/V page planes, the sampling generator's state and the
    pool layout."""
    out = bytearray()
    _enc_request(out, record["req"])
    out += _U32.pack(int(record["length"]))
    _enc_plane(out, record["k"])
    _enc_plane(out, record["v"])
    _enc_generator(out, record.get("generator"))
    codec = record["kv_codec"].encode("ascii")
    out += _U8.pack(len(codec))
    out += codec
    out += _U32.pack(int(record["page_size"]))
    out += _U32.pack(int(record.get("mesh_tp", 1)))
    out += _U32.pack(int(record.get("mesh_pp", 1)))
    return bytes(out)


def decode_handoff(payload: bytes,
                   device="cpu") -> "dict | WireError":
    """Total decode of :func:`encode_handoff` -> an install_request-
    shaped record with its planes on ``device`` (or a typed WireError;
    never a partial record)."""
    try:
        r = _Reader(payload)
        req = _dec_request(r)
        if isinstance(req, WireError):
            return req
        (length,) = r.unpack(_U32)
        k = _dec_plane(r, device)
        if isinstance(k, WireError):
            return k
        v = _dec_plane(r, device)
        if isinstance(v, WireError):
            return v
        gen = _dec_generator(r)
        if isinstance(gen, WireError):
            return gen
        (clen,) = r.unpack(_U8)
        kv_codec = r.take(clen).decode("ascii")
        if kv_codec not in consts.KV_CODECS:
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             f"unknown kv codec {kv_codec!r}")
        (page_size,) = r.unpack(_U32)
        (mesh_tp,) = r.unpack(_U32)
        (mesh_pp,) = r.unpack(_U32)
        if r.pos != len(payload):
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             f"{len(payload) - r.pos} trailing bytes")
        return {"req": req, "length": length, "k": k, "v": v,
                "generator": gen, "kv_codec": kv_codec,
                "page_size": page_size,
                "mesh_tp": mesh_tp, "mesh_pp": mesh_pp}
    except _Truncated:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         "handoff payload ends mid-field")
    except Exception as e:
        return WireError(consts.WIRE_FAULT_GARBAGE, f"{e!r}")


def encode_prefix(name: str, tokens: list, record: dict) -> bytes:
    """Encode an ``extract_prefix`` replication record plus the
    registration identity (name + token list) install_prefix_pages
    needs on the far side."""
    out = bytearray()
    head = encode_value({"name": name,
                         "tokens": [int(t) for t in tokens],
                         "plen": int(record["plen"]),
                         "kv_codec": record["kv_codec"],
                         "page_size": int(record["page_size"]),
                         "mesh_tp": int(record.get("mesh_tp", 1)),
                         "mesh_pp": int(record.get("mesh_pp", 1))})
    out += _U32.pack(len(head))
    out += head
    _enc_plane(out, record["k"])
    _enc_plane(out, record["v"])
    return bytes(out)


def decode_prefix(payload: bytes,
                  device="cpu") -> "tuple[str, list, dict] | WireError":
    """Total decode of :func:`encode_prefix` ->
    (name, tokens, install_prefix_pages-shaped record), planes on
    ``device``."""
    try:
        r = _Reader(payload)
        (n,) = r.unpack(_U32)
        if n > _max_payload():
            return WireError(consts.WIRE_FAULT_OVER_LENGTH,
                             f"prefix head claims {n} bytes")
        head = decode_value(r.take(n))
        if isinstance(head, WireError):
            return head
        if not isinstance(head, dict):
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             "prefix head is not a record")
        k = _dec_plane(r, device)
        if isinstance(k, WireError):
            return k
        v = _dec_plane(r, device)
        if isinstance(v, WireError):
            return v
        if r.pos != len(payload):
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             f"{len(payload) - r.pos} trailing bytes")
        kv_codec = head["kv_codec"]
        if kv_codec not in consts.KV_CODECS:
            return WireError(consts.WIRE_FAULT_GARBAGE,
                             f"unknown kv codec {kv_codec!r}")
        record = {"plen": int(head["plen"]), "k": k, "v": v,
                  "kv_codec": kv_codec,
                  "page_size": int(head["page_size"]),
                  "mesh_tp": int(head["mesh_tp"]),
                  "mesh_pp": int(head["mesh_pp"])}
        return (str(head["name"]),
                [int(t) for t in head["tokens"]], record)
    except _Truncated:
        return WireError(consts.WIRE_FAULT_TRUNCATED,
                         "prefix payload ends mid-field")
    except Exception as e:
        return WireError(consts.WIRE_FAULT_GARBAGE, f"{e!r}")


def encode_probe(snapshot: dict) -> bytes:
    """Encode a telemetry/pressure probe frame: the engine's snapshot
    dict (consts.TELEMETRY_* scalars + the dict-valued bucket maps)
    plus whatever health fields the host attaches. Compact — no
    arrays, just the generic value encoding."""
    return encode_value(snapshot)


def decode_probe(payload: bytes) -> "dict | WireError":
    value = decode_value(payload)
    if isinstance(value, WireError):
        return value
    if not isinstance(value, dict):
        return WireError(consts.WIRE_FAULT_GARBAGE,
                         "probe payload is not a record")
    return value
