"""Length-prefixed RPC transport of the cross-process fleet — the port
of ``tpushare/workloads/transport.py``.

Stdlib ``socket`` / ``socketserver`` only. Every byte on the wire is a
``wirecodec`` frame, every request an ``encode_value`` envelope ``{"op",
"args", "token"}``, every response ``{"ok": True, "value": ...}`` or a
typed error record, so the fault plane below has one decoder to corrupt
against.

- **Per-op deadlines**: every round trip is bounded by
  ``consts.FLEET_RPC_OP_DEADLINE_S`` (``FLEET_RPC_CONNECT_DEADLINE_S``
  for the dial, ``FLEET_RPC_STEP_DEADLINE_S`` for compute ops); a hung
  peer surfaces a typed ``timeout`` :class:`TransportError`.
- **Retry with backoff**: connect and call run under ``retry``
  policies (full jitter, attempt and time budgets).
- **Idempotency tokens**: every mutating op carries a client-minted
  token; the server caches the response by token for
  ``consts.FLEET_RPC_IDEMPOTENCY_TTL_S``, so a retried ``install`` whose
  answer was lost replays the recorded verdict instead of installing
  twice.
- **Typed faults**: every failure is a :class:`TransportError` whose
  ``kind`` is one of ``consts.WIRE_FAULT_KINDS``, counted per client in
  ``stats``.

:class:`TransportFaultPlan` injects under the codec: mid-stream cuts,
corrupt frames, slow links, hangs, partitions, dropped answers and
remote death. The server's accept thread and its connection threads are
daemons; ``RpcServer.close`` stops the accept loop, closes the socket
and joins the accept thread.
"""
from __future__ import annotations

import dataclasses
import logging
import socket
import socketserver
import threading
import time
import uuid
from typing import Callable

from tpushare_torch import consts, retry
from tpushare_torch.workloads import overload, wirecodec

log = logging.getLogger("tpushare_torch.transport")

# Dial + per-call retry tails: short, jittered, bounded. Mutating calls
# are safe to retry because every one carries an idempotency token the
# host dedupes on.
CONNECT = retry.RetryPolicy(max_attempts=3, base_delay_s=0.05,
                            max_delay_s=0.5, overall_deadline_s=5.0)
CALL = retry.RetryPolicy(max_attempts=3, base_delay_s=0.05,
                         max_delay_s=0.5, overall_deadline_s=10.0)


class TransportError(OSError):
    """A typed wire/transport fault. Subclasses OSError so
    retry.default_retryable already classifies it transient; ``kind``
    is one of consts.WIRE_FAULT_KINDS."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind


class RemoteOpError(Exception):
    """The remote handler raised: NOT a transport fault, never retried
    by the client (the op executed and failed deterministically).
    ``resource_exhausted`` mirrors overload.is_resource_exhausted on
    the far side so load conditions stay distinguishable from bugs."""

    def __init__(self, op: str, exc_type: str, message: str,
                 resource_exhausted: bool = False) -> None:
        super().__init__(f"remote {op} failed: {exc_type}: {message}")
        self.op = op
        self.exc_type = exc_type
        self.remote_message = message
        self.resource_exhausted = resource_exhausted


# ---------------------------------------------------------------------------
# Network fault plane.
# ---------------------------------------------------------------------------

FAULT_CUT = "cut"              # close the stream mid-frame
FAULT_CORRUPT = "corrupt"      # flip a payload byte under the CRC
FAULT_SLOW = "slow"            # delay the send, then proceed normally
FAULT_HANG = "hang"            # send nothing; the op deadline fires
FAULT_PARTITION = "partition"  # unreachable: fail before dialing
FAULT_ACK_DROP = "ack_drop"    # op executes, the response is dropped
FAULT_DEATH = "death"          # run the hook (kill the host), then cut
TRANSPORT_FAULT_KINDS = (FAULT_CUT, FAULT_CORRUPT, FAULT_SLOW,
                         FAULT_HANG, FAULT_PARTITION, FAULT_ACK_DROP,
                         FAULT_DEATH)


@dataclasses.dataclass
class TransportFault:
    """One scripted network fault: fire ``times`` times on a route,
    then disarm (negative ``times`` never disarms). ``hook`` runs
    before a ``death`` fault cuts (the test kills the host process in
    it)."""
    times: int = 1
    kind: str = FAULT_CUT
    delay_s: float = 0.05
    hook: Callable[[], None] | None = None

    def __post_init__(self) -> None:
        if self.kind not in TRANSPORT_FAULT_KINDS:
            raise ValueError(f"unknown transport fault kind "
                             f"{self.kind!r} (one of "
                             f"{TRANSPORT_FAULT_KINDS})")


class TransportFaultPlan:
    """Scripted network faults keyed by RPC op name (``"*"`` matches
    every op) — the tpu/fake.py WorkloadFaultPlan idiom aimed at the
    wire. The client consults :meth:`take` before each attempt; every
    consumed fault lands in ``triggered`` so storm suites can assert
    the observed fault sequence EXACTLY matches the plan."""

    def __init__(self) -> None:
        self._faults: dict[str, list[TransportFault]] = {}
        self.triggered: list[tuple[str, str]] = []
        self._lock = threading.Lock()

    def add(self, route: str, fault: TransportFault) -> None:
        with self._lock:
            self._faults.setdefault(route, []).append(fault)

    def clear(self, route: str | None = None) -> None:
        with self._lock:
            if route is None:
                self._faults.clear()
            else:
                self._faults.pop(route, None)

    def take(self, route: str) -> TransportFault | None:
        """Consume one armed fault for ``route`` (exact op first, then
        the ``"*"`` wildcard); None when nothing is armed."""
        with self._lock:
            for key in (route, "*"):
                queue = self._faults.get(key)
                if not queue:
                    continue
                fault = queue[0]
                if fault.times > 0:       # negative = never disarms
                    fault.times -= 1
                    if fault.times == 0:
                        queue.pop(0)
                self.triggered.append((route, fault.kind))
                return fault
        return None


# ---------------------------------------------------------------------------
# Server.
# ---------------------------------------------------------------------------

class RpcServer:
    """Threaded length-prefixed RPC server over loopback/TCP.

    ``handler(op, args) -> value`` runs one op (EngineHost provides it);
    anything it raises becomes a typed error response. Mutating
    requests carry an idempotency token: the response payload is cached
    by token for consts.FLEET_RPC_IDEMPOTENCY_TTL_S and a replayed
    token returns the RECORDED bytes without re-invoking the handler —
    the double-install guard."""

    def __init__(self, handler: Callable[[str, dict], object],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._handler = handler
        self._idem: dict[str, tuple[float, bytes]] = {}
        self._idem_lock = threading.Lock()
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._serve_conn(self.request)

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv((host, port), _Conn)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="tpushare-rpc-server",
            daemon=True)
        self._thread.start()

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=consts.FLEET_RPC_CONNECT_DEADLINE_S)

    # -- connection loop -------------------------------------------------

    def _serve_conn(self, sock: socket.socket) -> None:
        while True:
            got = wirecodec.read_frame(sock.recv)
            if isinstance(got, wirecodec.WireError):
                if got.kind in (consts.WIRE_FAULT_CUT,
                                consts.WIRE_FAULT_TRUNCATED):
                    return            # peer went away mid-frame
                # The frame was damaged but the stream may be synced
                # (a CRC failure consumed exactly one frame). Answer
                # with the typed kind; desynced kinds close after.
                self._respond(sock, {"ok": False,
                                     "wire_fault": got.kind,
                                     "error": got.detail})
                if got.kind != consts.WIRE_FAULT_CRC:
                    return
                continue
            kind, payload = got
            if kind != wirecodec.KIND_RPC_REQUEST:
                self._respond(sock, {
                    "ok": False,
                    "wire_fault": consts.WIRE_FAULT_GARBAGE,
                    "error": f"unexpected frame kind {kind}"})
                continue
            raw = self._dispatch(payload)
            try:
                wirecodec.write_frame(
                    sock.sendall, wirecodec.KIND_RPC_RESPONSE, raw)
            except OSError:
                return

    def _respond(self, sock: socket.socket, env: dict) -> None:
        try:
            wirecodec.write_frame(sock.sendall,
                                  wirecodec.KIND_RPC_RESPONSE,
                                  wirecodec.encode_value(env))
        except OSError:
            pass

    def _dispatch(self, payload: bytes) -> bytes:
        env = wirecodec.decode_value(payload)
        if isinstance(env, wirecodec.WireError):
            return wirecodec.encode_value({
                "ok": False, "wire_fault": env.kind,
                "error": env.detail})
        if not isinstance(env, dict) or not isinstance(
                env.get("op"), str):
            return wirecodec.encode_value({
                "ok": False,
                "wire_fault": consts.WIRE_FAULT_GARBAGE,
                "error": "request envelope is not an op record"})
        op = env["op"]
        args = env.get("args") or {}
        token = env.get("token")
        if isinstance(token, str):
            cached = self._idem_get(token)
            if cached is not None:
                return cached
        try:
            value = self._handler(op, args)
            raw = wirecodec.encode_value({"ok": True, "value": value})
        except Exception as e:      # typed error response, never a crash
            raw = wirecodec.encode_value({
                "ok": False, "error": str(e),
                "exc_type": type(e).__name__,
                "resource_exhausted":
                    overload.is_resource_exhausted(e)})
        if isinstance(token, str):
            # record BEFORE the send: an ACK-dropped response must
            # still replay on retry
            self._idem_put(token, raw)
        return raw

    # -- idempotency cache ----------------------------------------------

    def _idem_get(self, token: str) -> bytes | None:
        now = time.monotonic()
        with self._idem_lock:
            hit = self._idem.get(token)
            if hit is None:
                return None
            ts, raw = hit
            if now - ts > consts.FLEET_RPC_IDEMPOTENCY_TTL_S:
                del self._idem[token]
                return None
            return raw

    def _idem_put(self, token: str, raw: bytes) -> None:
        now = time.monotonic()
        with self._idem_lock:
            stale = [t for t, (ts, _) in self._idem.items()
                     if now - ts > consts.FLEET_RPC_IDEMPOTENCY_TTL_S]
            for t in stale:
                del self._idem[t]
            self._idem[token] = (now, raw)


# ---------------------------------------------------------------------------
# Client.
# ---------------------------------------------------------------------------

class RpcClient:
    """One peer's RPC client: persistent connection, per-op deadlines,
    RetryPolicy on connect and call, typed fault accounting.

    Thread-safe: the lock guards only the cached-socket SWAP (never an
    I/O call — concurrent callers dial their own connection and the
    spare closes at check-in), so a slow wire can't serialize the
    router's probe thread against its dispatch loop."""

    def __init__(self, address: tuple[str, int], *,
                 faults: TransportFaultPlan | None = None,
                 connect_policy: retry.RetryPolicy = CONNECT,
                 call_policy: retry.RetryPolicy = CALL) -> None:
        self._address = address
        self.faults = faults
        self._connect_policy = connect_policy
        self._call_policy = call_policy
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._broken = False
        self.stats: dict = {
            "calls": 0, "bytes_sent": 0, "bytes_recv": 0,
            "wire_faults": 0, "reconnects": 0,
            "fault_kinds": {}, "fault_log": []}

    # -- public ----------------------------------------------------------

    def call(self, op: str, args: dict | None = None, *,
             mutating: bool = False,
             deadline_s: float | None = None) -> object:
        """One RPC round trip under the call RetryPolicy. ``mutating``
        mints an idempotency token reused across retries, so the op can
        execute at most once however many times the wire eats the ACK."""
        token = uuid.uuid4().hex if mutating else None
        payload = wirecodec.encode_value(
            {"op": op, "args": args or {}, "token": token})
        deadline = (consts.FLEET_RPC_OP_DEADLINE_S
                    if deadline_s is None else deadline_s)
        return self._call_policy.call(
            lambda: self._attempt(op, payload, deadline),
            describe=f"rpc {op} -> {self._address[0]}:{self._address[1]}",
            retryable=lambda e: isinstance(e, TransportError))

    def close(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            sock.close()

    # -- internals -------------------------------------------------------

    def _fault(self, op: str, kind: str, message: str) -> TransportError:
        self._broken = True
        self.stats["wire_faults"] += 1
        kinds = self.stats["fault_kinds"]
        kinds[kind] = kinds.get(kind, 0) + 1
        self.stats["fault_log"].append((op, kind))
        return TransportError(kind, f"{op}: {message}")

    def _connect(self, deadline: float) -> socket.socket:
        def dial() -> socket.socket:
            return socket.create_connection(
                self._address,
                timeout=consts.FLEET_RPC_CONNECT_DEADLINE_S)
        try:
            sock = self._connect_policy.call(
                dial, describe=f"dial {self._address[0]}:"
                               f"{self._address[1]}")
        except OSError as e:
            raise self._fault("connect", consts.WIRE_FAULT_REFUSED,
                              str(e)) from e
        sock.settimeout(deadline)
        if self._broken:
            self._broken = False
            self.stats["reconnects"] += 1
        return sock

    def _checkout(self, deadline: float) -> socket.socket:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is None:
            return self._connect(deadline)
        sock.settimeout(deadline)
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if self._sock is None:
                self._sock = sock
                return
        sock.close()

    def _attempt(self, op: str, payload: bytes,
                 deadline: float) -> object:
        fault = self.faults.take(op) if self.faults is not None else None
        if fault is not None:
            if fault.kind == FAULT_PARTITION:
                raise self._fault(op, consts.WIRE_FAULT_REFUSED,
                                  "network partitioned (injected)")
            if fault.kind == FAULT_DEATH:
                if fault.hook is not None:
                    fault.hook()
                self.close()
                raise self._fault(op, consts.WIRE_FAULT_CUT,
                                  "remote died (injected)")
            if fault.kind == FAULT_SLOW:
                time.sleep(fault.delay_s)
        frame = wirecodec.encode_frame(wirecodec.KIND_RPC_REQUEST,
                                       payload)
        if fault is not None and fault.kind == FAULT_CORRUPT:
            flip = wirecodec.HEADER_BYTES + max(0, len(payload) // 2)
            frame = (frame[:flip] + bytes([frame[flip] ^ 0xFF])
                     + frame[flip + 1:])
        sock = self._checkout(deadline)
        try:
            if fault is not None and fault.kind == FAULT_CUT:
                sock.sendall(frame[:max(1, len(frame) // 2)])
                sock.close()
                raise self._fault(op, consts.WIRE_FAULT_CUT,
                                  "stream cut mid-frame (injected)")
            if fault is not None and fault.kind == FAULT_HANG:
                # send nothing: the peer never answers, the op
                # deadline converts the hang into a typed timeout
                pass
            else:
                sock.sendall(frame)
                self.stats["bytes_sent"] += len(frame)
            got = wirecodec.read_frame(sock.recv)
        except TransportError:
            raise
        except socket.timeout as e:
            sock.close()
            raise self._fault(op, consts.WIRE_FAULT_TIMEOUT,
                              f"no response within {deadline}s") from e
        except OSError as e:
            sock.close()
            raise self._fault(op, consts.WIRE_FAULT_CUT, str(e)) from e
        if isinstance(got, wirecodec.WireError):
            sock.close()
            raise self._fault(op, got.kind, got.detail)
        kind, resp = got
        self.stats["bytes_recv"] += len(resp) + wirecodec.FRAME_OVERHEAD
        if fault is not None and fault.kind == FAULT_ACK_DROP:
            # the op executed and answered; the network ate the ACK
            sock.close()
            raise self._fault(op, consts.WIRE_FAULT_CUT,
                              "response dropped (injected)")
        self._checkin(sock)
        if kind != wirecodec.KIND_RPC_RESPONSE:
            raise self._fault(op, consts.WIRE_FAULT_GARBAGE,
                              f"unexpected frame kind {kind}")
        env = wirecodec.decode_value(resp)
        if isinstance(env, wirecodec.WireError):
            raise self._fault(op, env.kind, env.detail)
        if not isinstance(env, dict) or "ok" not in env:
            raise self._fault(op, consts.WIRE_FAULT_GARBAGE,
                              "response envelope is not a record")
        self.stats["calls"] += 1
        if env["ok"]:
            return env.get("value")
        if "wire_fault" in env:
            raise self._fault(op, str(env["wire_fault"]),
                              str(env.get("error", "")))
        raise RemoteOpError(op, str(env.get("exc_type", "Exception")),
                            str(env.get("error", "")),
                            bool(env.get("resource_exhausted", False)))
