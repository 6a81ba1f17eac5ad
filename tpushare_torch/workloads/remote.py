"""Cross-process fleet members — the port of
``tpushare/workloads/remote.py``.

Two halves of one seam:

* :class:`EngineHost` wraps a LOCAL ``PagedServingEngine`` behind the
  ``transport.RpcServer`` — every fleet-facing engine op (submit / step
  / extract / install / prefix replication / drain / healthz /
  telemetry) becomes an RPC whose payloads are ``wirecodec`` frames.
* :class:`RemoteMember` is the client-side proxy satisfying the
  ``FleetRouter`` member duck type, so the router composes local and
  remote members UNCHANGED — prefill on one OS process can hand pages
  to decode on another through the same ``extract_request ->
  install_request -> detach_request`` discipline, byte-exact on both KV
  codecs with sampled-stream PRNG continuity.

The proxy keeps a local MIRROR of the authoritative remote state: the
``Request`` objects callers submitted stay the single user-facing
handles (``output``/``status`` fill in as step syncs arrive), and the
``queue``/``running``/``_lengths`` views the router steers by rebuild
from every sync. Terminal statuses apply exactly once under retries:
the host keeps each request's final state until the client ACKs it, and
every mutating RPC rides an idempotency token, so an ACK-lost retry can
never re-submit, double-install, or re-shed.

When the wire dies mid-flight the proxy degrades to its mirror —
``take_queue``/``cancel_request`` release LOCAL state so the router's
evacuation (hedge + shed with typed reasons) still lands exactly one
terminal status per request even when the host is unreachable.
"""
from __future__ import annotations

import logging
import threading
import time
import types
import uuid

from tpushare_torch import consts, metrics
from tpushare_torch.workloads import paging, transport, wirecodec

log = logging.getLogger("tpushare_torch.remote")


def _wire_error_raise(err: wirecodec.WireError) -> None:
    raise transport.TransportError(err.kind, err.detail)


# ---------------------------------------------------------------------------
# Host side.
# ---------------------------------------------------------------------------

class EngineHost:
    """Serve one local ``PagedServingEngine`` to remote fleet routers.

    The host owns the authoritative engine state; requests are keyed by
    the CLIENT-minted ``rid`` so retried submits/installs dedupe
    naturally on top of the transport's idempotency cache. Retired
    requests' final states are kept until the client ACKs them in a
    later ``step`` — the exactly-once terminal-status contract across
    a lossy wire."""

    def __init__(self, engine, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.engine = engine
        self._reqs: dict[str, object] = {}     # rid -> host Request
        self._rids: dict[int, str] = {}        # id(req) -> rid
        self._lock = threading.Lock()
        # The engine is not thread-safe and the RPC server handles each
        # connection on its own thread (dispatch + the router's probe
        # connection), so every op serializes on this lock. The host
        # never self-steps: the joining router is the only pacemaker,
        # which also keeps disaggregated prefill members from being
        # wrong-stepped by a local loop.
        self._engine_lock = threading.RLock()
        self._stop = threading.Event()
        self.server = transport.RpcServer(self._dispatch, host, port)

    @property
    def address(self) -> tuple[str, int]:
        return self.server.address

    def close(self) -> None:
        self._stop.set()
        self.server.close()

    def serve_forever(self, poll_s: float = 0.01) -> None:
        """Block until close(); all engine work arrives via RPC on the
        server's own threads (the remote router drives stepping)."""
        while not self._stop.wait(timeout=max(poll_s, 0.01) * 25):
            pass

    # -- rid bookkeeping -------------------------------------------------

    def _track(self, rid: str, req) -> None:
        with self._lock:
            self._reqs[rid] = req
            self._rids[id(req)] = rid

    def _drop(self, rid: str):
        with self._lock:
            req = self._reqs.pop(rid, None)
            if req is not None:
                self._rids.pop(id(req), None)
        return req

    def _rid_of(self, req) -> str | None:
        with self._lock:
            return self._rids.get(id(req))

    def _req_of(self, rid: str):
        with self._lock:
            return self._reqs.get(rid)

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, op: str, args: dict):
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        with self._engine_lock:
            return fn(args)

    def _op_attach(self, args: dict) -> dict:
        eng = self.engine
        return {
            "pool_layout": eng.pool_layout,
            "max_seq": int(eng.max_seq),
            "buckets": [int(b) for b in eng.buckets],
            "queue_limit": eng.queue_limit,
            "n_lanes": int(eng.n_lanes),
            "page_size": int(eng.alloc.page_size),
            "kv_codec": eng.kv_codec,
            "slo_ttft_s": float(eng.telemetry.slo.ttft_s),
        }

    def _op_submit(self, args: dict) -> dict:
        rid = str(args["rid"])
        if self._req_of(rid) is not None:     # rid-level dedupe
            return {"accepted": True}
        req = wirecodec.decode_request(bytes(args["req"]))
        if isinstance(req, wirecodec.WireError):
            _wire_error_raise(req)
        self._track(rid, req)
        self.engine.submit(req)
        return {"accepted": True}

    def _sync_doc(self, ack: list) -> dict:
        eng = self.engine
        for rid in ack:
            self._drop(str(rid))
        with self._lock:
            tracked = dict(self._reqs)
        updates = {}
        for rid, req in tracked.items():
            updates[rid] = {
                "output": [int(t) for t in req.output],
                "logprobs": [float(v) for v in req.logprobs],
                "done": bool(req.done),
                "status": req.status,
            }
        queue = [self._rid_of(q) for q in eng.queue]
        running = {str(lane): self._rid_of(r)
                   for lane, r in eng.running.items()}
        return {
            "updates": updates,
            "queue": [r for r in queue if r is not None],
            "running": {lane: r for lane, r in running.items()
                        if r is not None},
            "lengths": {str(lane): int(n)
                        for lane, n in eng._lengths.items()},
            # the host's accounting rides every sync so the proxy's
            # stats mirror is exact the moment the last request retires
            # (not one probe interval stale)
            "stats": eng.stats,
        }

    def _op_step(self, args: dict) -> dict:
        eng = self.engine
        if eng.running or eng.queue:
            eng.step()
        return self._sync_doc(args.get("ack") or [])

    def _op_prefill_step(self, args: dict) -> dict:
        eng = self.engine
        if eng.running or eng.queue:
            eng.prefill_step()
        return self._sync_doc(args.get("ack") or [])

    def _op_sync(self, args: dict) -> dict:
        return self._sync_doc(args.get("ack") or [])

    def _op_extract(self, args: dict) -> dict:
        lane = int(args["lane"])
        record = self.engine.extract_request(lane)
        rid = self._rid_of(record["req"])
        return {"rid": rid,
                "handoff": wirecodec.encode_handoff(record)}

    def _op_install(self, args: dict) -> dict:
        record = wirecodec.decode_handoff(bytes(args["handoff"]),
                                          device=self.engine.device)
        if isinstance(record, wirecodec.WireError):
            _wire_error_raise(record)
        rid = str(args["rid"])
        known = self._req_of(rid)
        if known is not None:
            # replayed install that DID commit before its ACK was lost
            lane = next((ln for ln, r in self.engine.running.items()
                         if r is known), None)
            return {"lane": lane}
        lane = self.engine.install_request(record)
        if lane is not None:
            self._track(rid, record["req"])
        return {"lane": lane}

    def _op_detach(self, args: dict) -> dict:
        lane = int(args["lane"])
        req = self.engine.detach_request(lane)
        rid = self._rid_of(req)
        if rid is not None:
            self._drop(rid)
        return {"rid": rid}

    def _op_cancel(self, args: dict) -> dict:
        lane = int(args["lane"])
        req = self.engine.cancel_request(lane)
        rid = self._rid_of(req)
        if rid is not None:
            self._drop(rid)
        return {"rid": rid}

    def _op_retire(self, args: dict) -> dict:
        lane = int(args["lane"])
        req = self.engine.running.get(lane)
        self.engine._retire(lane, status=args["status"])
        rid = self._rid_of(req) if req is not None else None
        final = None
        if rid is not None:
            final = {
                "output": [int(t) for t in req.output],
                "logprobs": [float(v) for v in req.logprobs],
                "done": bool(req.done),
                "status": req.status,
            }
            self._drop(rid)
        return {"rid": rid, "final": final}

    def _op_shed(self, args: dict) -> dict:
        rid = str(args["rid"])
        req = self._req_of(rid)
        if req is None:
            return {"rid": None, "final": None}
        eng = self.engine
        if req in eng.queue:
            eng.queue.remove(req)
        if not req.done:
            eng._shed_request(req)
        self._drop(rid)
        return {"rid": rid,
                "final": {"output": [int(t) for t in req.output],
                          "logprobs": [float(v) for v in req.logprobs],
                          "done": bool(req.done),
                          "status": req.status}}

    def _op_take_queue(self, args: dict) -> dict:
        taken = self.engine.take_queue()
        rids = []
        for req in taken:
            rid = self._rid_of(req)
            if rid is not None:
                rids.append(rid)
                self._drop(rid)
        return {"rids": rids}

    def _op_can_install(self, args: dict) -> bool:
        return bool(self.engine.can_install(int(args["rows"]),
                                            int(args["left"])))

    def _op_register_prefix(self, args: dict) -> dict:
        self.engine.register_prefix(
            str(args["name"]), [int(t) for t in args["tokens"]])
        return {"ok": True}

    def _op_drop_prefix(self, args: dict) -> dict:
        self.engine.drop_prefix(str(args["name"]))
        return {"ok": True}

    def _op_extract_prefix(self, args: dict) -> dict:
        name = str(args["name"])
        record = self.engine.extract_prefix(name)
        return {"prefix": wirecodec.encode_prefix(name, [], record)}

    def _op_install_prefix(self, args: dict) -> dict:
        got = wirecodec.decode_prefix(bytes(args["prefix"]),
                                      device=self.engine.device)
        if isinstance(got, wirecodec.WireError):
            _wire_error_raise(got)
        name, _, record = got
        self.engine.install_prefix_pages(
            name, [int(t) for t in args["tokens"]], record)
        return {"ok": True}

    def _op_request_drain(self, args: dict) -> dict:
        self.engine.request_drain()
        return {"ok": True}

    def _op_cancel_drain(self, args: dict) -> dict:
        self.engine.cancel_drain()
        return {"ok": True}

    def _op_reset_stats(self, args: dict) -> dict:
        self.engine.reset_stats()
        return {"ok": True}

    def _op_set_engine_id(self, args: dict) -> dict:
        self.engine.telemetry.set_fleet_engine_id(int(args["id"]))
        return {"ok": True}

    def _op_healthz(self, args: dict) -> dict:
        eng = self.engine
        degraded, occupancy = eng.telemetry.pressure_view()
        return {
            "healthz": eng.healthz(),
            "watchdog_trips": int(eng.watchdog_trips),
            "stats": eng.stats,
            "snapshot": eng.telemetry.snapshot(),
            "ttft_samples": [float(v) for v in
                             eng.telemetry.ttft.samples_snapshot()],
            "decode_samples": [float(v) for v in
                               eng.telemetry.decode.samples_snapshot()],
            "pressure": [bool(degraded),
                         None if occupancy is None else float(occupancy)],
            "slo_ttft_s": float(eng.telemetry.slo.ttft_s),
            "prefixes": {name: int(plen)
                         for name, (plen, _) in eng.prefixes.items()},
        }


# ---------------------------------------------------------------------------
# Client side.
# ---------------------------------------------------------------------------

class _SamplePool:
    """A histogram-shaped view over the host's shipped sample pool —
    just enough surface (percentile / samples_snapshot) for the
    router's steering reads and telemetry.fleet_snapshot's merged
    tails."""

    def __init__(self) -> None:
        self.samples: list[float] = []

    def samples_snapshot(self) -> list[float]:
        return list(self.samples)

    def percentile(self, q: float) -> float:
        return metrics.Histogram.percentile_of(list(self.samples), q)


class _RemoteTelemetry:
    """The proxy's telemetry facade: serves the router's hot-path reads
    (pressure_view / percentile / snapshot) from the LAST healthz
    probe's shipped document — never an RPC per routing decision — and
    no-ops the per-request lifecycle hooks (those run on the host,
    where the authoritative engine lives). ``waited`` answers None so
    the router's SLO victim search skips remote queues (their wait
    clocks tick in the host process)."""

    def __init__(self) -> None:
        self.ttft = _SamplePool()
        self.decode = _SamplePool()
        self.slo = types.SimpleNamespace(ttft_s=consts.SLO_TTFT_S)
        self._snapshot: dict = {}
        self._pressure: tuple[bool, float | None] = (False, None)
        self._engine_id: int | None = None

    def update(self, doc: dict) -> None:
        snap = doc.get("snapshot")
        if isinstance(snap, dict):
            self._snapshot = snap
            if self._engine_id is not None:
                self._snapshot[consts.TELEMETRY_FLEET_ENGINE_ID] = \
                    self._engine_id
        self.ttft.samples = [float(v)
                             for v in doc.get("ttft_samples") or []]
        self.decode.samples = [float(v)
                               for v in doc.get("decode_samples") or []]
        pressure = doc.get("pressure")
        if isinstance(pressure, list) and len(pressure) == 2:
            occ = pressure[1]
            self._pressure = (bool(pressure[0]),
                              None if occ is None else float(occ))
        if doc.get("slo_ttft_s") is not None:
            self.slo.ttft_s = float(doc["slo_ttft_s"])

    # -- router-facing reads --------------------------------------------

    def snapshot(self) -> dict:
        return dict(self._snapshot)

    def pressure_view(self) -> tuple[bool, float | None]:
        return self._pressure

    def waited(self, key: int) -> float | None:
        return None

    def set_fleet_engine_id(self, engine_id: int | None) -> None:
        self._engine_id = engine_id

    # -- lifecycle no-ops (authoritative copies run on the host) --------

    def requeued(self, key: int) -> None:
        pass

    def cancelled(self, key: int) -> None:
        pass

    def reset(self) -> None:
        self._snapshot = {}
        self.ttft.samples = []
        self.decode.samples = []


class RemoteMember:
    """Client-side proxy for one :class:`EngineHost`, shaped like a
    fleet member. The ``Request`` objects callers hand to
    :meth:`submit` remain the user-facing handles; every sync
    overwrites their ``output``/``logprobs``/``done``/``status`` from
    the host's authoritative copies (full-state, not deltas — a lost
    response heals on the next successful sync)."""

    # the router catches `eng._paging.PagePoolExhausted` around prefix
    # replication; the proxy re-raises the host's verdict as this type
    _paging = paging

    def __init__(self, address: tuple[str, int], *,
                 faults: transport.TransportFaultPlan | None = None,
                 client: transport.RpcClient | None = None) -> None:
        self.address = address
        self.client = client if client is not None else \
            transport.RpcClient(address, faults=faults)
        info = self.client.call("attach")
        self.pool_layout = str(info["pool_layout"])
        self.max_seq = int(info["max_seq"])
        self.buckets = tuple(int(b) for b in info["buckets"])
        self.queue_limit = (None if info["queue_limit"] is None
                            else int(info["queue_limit"]))
        self.n_lanes = int(info["n_lanes"])
        self.kv_codec = str(info["kv_codec"])
        self.telemetry = _RemoteTelemetry()
        # local mirrors of the authoritative remote state (the views
        # the router steers by between syncs)
        self.queue: list = []
        self.running: dict[int, object] = {}
        self._lengths: dict[int, int] = {}
        self._reqs: dict[str, object] = {}     # rid -> local Request
        self._rids: dict[int, str] = {}        # id(req) -> rid
        self._ack: list[str] = []
        self._draining_local = False
        self._draining_remote = False
        self._watchdog_trips = 0
        self._stats: dict = {}
        self._prefixes: dict[str, int] = {}
        if info.get("slo_ttft_s") is not None:
            self.telemetry.slo.ttft_s = float(info["slo_ttft_s"])
        # prime the stats/telemetry caches (also proves the host is
        # really an engine, not just an open port)
        self.healthz()

    # -- wire accounting (fleet snapshot/metrics read these) -------------

    @property
    def wire_stats(self) -> dict:
        return self.client.stats

    def close(self) -> None:
        self.client.close()

    # -- identity / shape ------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining_local or self._draining_remote

    @property
    def watchdog_trips(self) -> int:
        return self._watchdog_trips

    @property
    def stats(self) -> dict:
        return self._stats

    @property
    def prefixes(self) -> dict:
        return dict(self._prefixes)

    # -- request lifecycle ----------------------------------------------

    def submit(self, req) -> None:
        rid = uuid.uuid4().hex
        self._reqs[rid] = req
        self._rids[id(req)] = rid
        try:
            self.client.call(
                "submit",
                {"rid": rid, "req": wirecodec.encode_request(req)},
                mutating=True)
        except BaseException:
            self._reqs.pop(rid, None)
            self._rids.pop(id(req), None)
            raise
        if req.deadline_s is not None:
            req._deadline = time.monotonic() + max(0.0, req.deadline_s)
        self.queue.append(req)

    def _apply_update(self, req, update: dict) -> None:
        req.output[:] = [int(t) for t in update["output"]]
        req.logprobs[:] = [float(v) for v in update["logprobs"]]
        req.done = bool(update["done"])
        req.status = update["status"]

    def _apply_sync(self, doc: dict) -> None:
        self._ack = []
        updates = doc.get("updates") or {}
        for rid, update in updates.items():
            req = self._reqs.get(rid)
            if req is None:
                self._ack.append(rid)     # already released locally
                continue
            self._apply_update(req, update)
            if req.done:
                self._ack.append(rid)
        stats = doc.get("stats")
        if isinstance(stats, dict):
            self._stats = stats
        self.queue = [self._reqs[r] for r in doc.get("queue") or []
                      if r in self._reqs]
        self.running = {int(lane): self._reqs[r]
                        for lane, r in (doc.get("running") or {}).items()
                        if r in self._reqs}
        self._lengths = {int(lane): int(n)
                         for lane, n in (doc.get("lengths") or {}).items()}
        for rid in self._ack:
            req = self._reqs.pop(rid, None)
            if req is not None:
                self._rids.pop(id(req), None)

    def step(self) -> None:
        doc = self.client.call(
            "step", {"ack": self._ack}, mutating=True,
            deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S)
        self._apply_sync(doc)

    def prefill_step(self) -> None:
        doc = self.client.call(
            "prefill_step", {"ack": self._ack}, mutating=True,
            deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S)
        self._apply_sync(doc)

    def _release_local(self, req) -> None:
        rid = self._rids.pop(id(req), None)
        if rid is not None:
            self._reqs.pop(rid, None)
            self._ack.append(rid)

    def take_queue(self) -> list:
        """The evacuation hook: returns the queued requests to the
        router (which owes them a resubmit elsewhere). When the wire is
        already dead the LOCAL mirror is the only reachable copy — it
        is returned as-is, and the abandoned host-side copies retire
        with the host."""
        try:
            doc = self.client.call("take_queue", {}, mutating=True)
            rids = [str(r) for r in doc.get("rids") or []]
        except transport.TransportError:
            rids = [self._rids[id(q)] for q in self.queue
                    if id(q) in self._rids]
        taken = []
        for rid in rids:
            req = self._reqs.pop(rid, None)
            if req is None:
                continue
            self._rids.pop(id(req), None)
            taken.append(req)
        self.queue = [q for q in self.queue if q not in taken]
        return taken

    def extract_request(self, lane: int) -> dict:
        doc = self.client.call(
            "extract", {"lane": lane},
            deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S)
        record = wirecodec.decode_handoff(bytes(doc["handoff"]))
        if isinstance(record, wirecodec.WireError):
            _wire_error_raise(record)
        rid = doc.get("rid")
        local = self._reqs.get(rid) if isinstance(rid, str) else None
        if local is not None:
            # preserve request-object identity across the migration:
            # the wire copy's state folds into the caller's handle
            self._apply_update(local, {
                "output": record["req"].output,
                "logprobs": record["req"].logprobs,
                "done": record["req"].done,
                "status": record["req"].status})
            record["req"] = local
        return record

    def install_request(self, record: dict):
        req = record["req"]
        rid = self._rids.get(id(req)) or uuid.uuid4().hex
        payload = wirecodec.encode_handoff(record)
        try:
            doc = self.client.call(
                "install", {"rid": rid, "handoff": payload},
                mutating=True,
                deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S)
        except transport.RemoteOpError as e:
            if e.resource_exhausted:
                return None
            raise ValueError(e.remote_message) from e
        lane = doc.get("lane")
        if lane is None:
            return None
        lane = int(lane)
        self._reqs[rid] = req
        self._rids[id(req)] = rid
        self.running[lane] = req
        self._lengths[lane] = int(record["length"])
        return lane

    def detach_request(self, lane: int):
        req = self.running.pop(lane, None)
        self._lengths.pop(lane, None)
        self.client.call("detach", {"lane": lane}, mutating=True)
        if req is not None:
            self._release_local(req)
        return req

    def cancel_request(self, lane: int):
        """Release a lane for re-admission elsewhere. Transport
        failures degrade to the local mirror: the router is evacuating
        a dead member and the mirror's copy is the one that re-routes."""
        req = self.running.pop(lane, None)
        self._lengths.pop(lane, None)
        try:
            self.client.call("cancel", {"lane": lane}, mutating=True)
        except transport.TransportError:
            pass
        if req is not None:
            self._release_local(req)
        return req

    def _retire(self, lane: int, status: str) -> None:
        req = self.running.pop(lane, None)
        self._lengths.pop(lane, None)
        doc = self.client.call("retire",
                               {"lane": lane, "status": status},
                               mutating=True)
        if req is not None:
            final = doc.get("final")
            if isinstance(final, dict):
                self._apply_update(req, final)
            else:
                req.done = True
                req.status = status
            self._release_local(req)

    def _shed_request(self, req) -> None:
        rid = self._rids.get(id(req))
        if rid is None:
            return
        doc = self.client.call("shed", {"rid": rid}, mutating=True)
        final = doc.get("final")
        if isinstance(final, dict):
            self._apply_update(req, final)
        if req in self.queue:
            self.queue.remove(req)
        self._release_local(req)

    def can_install(self, rows: int, left: int) -> bool:
        try:
            return bool(self.client.call("can_install",
                                         {"rows": rows, "left": left}))
        except transport.TransportError:
            return False

    # -- prefix replication ---------------------------------------------

    def _translate_pool_exhausted(self, e: transport.RemoteOpError):
        if e.exc_type == "PagePoolExhausted":
            raise paging.PagePoolExhausted(e.remote_message) from e
        raise ValueError(e.remote_message) from e

    def register_prefix(self, name: str, tokens: list) -> None:
        try:
            self.client.call("register_prefix",
                             {"name": name,
                              "tokens": [int(t) for t in tokens]},
                             deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S,
                             mutating=True)
        except transport.RemoteOpError as e:
            self._translate_pool_exhausted(e)
        self._prefixes[name] = len(tokens)

    def drop_prefix(self, name: str) -> None:
        self._prefixes.pop(name, None)
        self.client.call("drop_prefix", {"name": name}, mutating=True)

    def extract_prefix(self, name: str) -> dict:
        doc = self.client.call(
            "extract_prefix", {"name": name},
            deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S)
        got = wirecodec.decode_prefix(bytes(doc["prefix"]))
        if isinstance(got, wirecodec.WireError):
            _wire_error_raise(got)
        return got[2]

    def install_prefix_pages(self, name: str, tokens: list,
                             record: dict) -> None:
        payload = wirecodec.encode_prefix(name, tokens, record)
        try:
            self.client.call("install_prefix",
                             {"prefix": payload,
                              "tokens": [int(t) for t in tokens]},
                             deadline_s=consts.FLEET_RPC_STEP_DEADLINE_S,
                             mutating=True)
        except transport.RemoteOpError as e:
            self._translate_pool_exhausted(e)
        self._prefixes[name] = len(tokens)

    # -- drain / stats / health -----------------------------------------

    def request_drain(self) -> None:
        self._draining_local = True
        try:
            self.client.call("request_drain", {}, mutating=True)
        except transport.TransportError:
            pass                         # dead member is not admitting

    def cancel_drain(self) -> None:
        self._draining_local = False
        self.client.call("cancel_drain", {}, mutating=True)

    def reset_stats(self) -> None:
        self.client.call("reset_stats", {}, mutating=True)
        self.telemetry.reset()
        for key in ("calls", "bytes_sent", "bytes_recv",
                    "wire_faults", "reconnects"):
            self.client.stats[key] = 0
        self.client.stats["fault_kinds"] = {}
        self.client.stats["fault_log"] = []

    def trace_event(self, req, name: str, **attrs) -> None:
        trace = getattr(req, "_trace", None)
        if trace is not None:
            trace.event(name, **attrs)

    def healthz(self) -> dict:
        """One probe round trip refreshing EVERY cached read (telemetry
        snapshot, sample pools, pressure, stats, watchdog, prefixes) —
        the router's probe loop is the proxy's cache clock. Transport
        faults raise: the probe thread ships the exception to the
        breaker, which classifies it FAILURE_TRANSPORT."""
        doc = self.client.call("healthz")
        self.telemetry.update(doc)
        self._watchdog_trips = int(doc.get("watchdog_trips", 0))
        stats = doc.get("stats")
        if isinstance(stats, dict):
            self._stats = stats
        prefixes = doc.get("prefixes")
        if isinstance(prefixes, dict):
            self._prefixes = {str(k): int(v)
                              for k, v in prefixes.items()}
        health = doc.get("healthz")
        if not isinstance(health, dict):
            raise transport.TransportError(
                consts.WIRE_FAULT_GARBAGE,
                "healthz probe returned a non-record document")
        self._draining_remote = bool(health.get("draining", False))
        return health
