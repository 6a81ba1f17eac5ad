"""Serving-engine telemetry of the port — its own copy of
``tpushare/workloads/telemetry.py`` (``EngineTelemetry``, the process
snapshot provider, and ``fleet_snapshot``, the fleet router's merge of
its members' snapshots into one document):

- per-request **TTFT** (submit -> first token, which the engine samples
  at admission) and per-token **decode latency** (harvested chunk wall
  time over its steps) as bounded histograms with exact-percentile
  sample pools;
- **tokens/s** and **goodput** (tokens of requests that completed within
  the SLO, ``workloads/slo.py``) over a sliding window, and the SLO
  verdicts by phase;
- **queue depth**, admissions / retires, prefill-bucket occupancy, the
  overload counters (shed, deadline, OOM recoveries), the admission
  watermark and the watchdog's degraded flag; the paged pool's pages,
  codec and HBM; the drain state;
- **compiles**: the reference counts JAX compile events through
  ``jax.monitoring``; the port has no such source and reports the CUDA
  kernel libraries ``kernels/build.py`` compiled in this process (count
  and nvcc seconds) under the same keys, as a delta from the engine's
  start.

The engines drive the hooks at submit / admit / dispatch / harvest /
retire and install their snapshot as the process provider. Everything
mutable sits behind one lock (the histograms carry their own): the
engine loop and any reporter thread read it concurrently.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from tpushare_torch import consts, metrics
from tpushare_torch.workloads import overload
from tpushare_torch.workloads.kernels import build
from tpushare_torch.workloads.slo import SLOPolicy, phase_reached

__all__ = ["EngineTelemetry", "current_snapshot", "set_snapshot_provider",
           "fleet_snapshot"]

# TTFT spans admission, so the ladder reaches tens of seconds; decode
# per-token latency is sub-ms to tens of ms. percentile() reads the exact
# sample pool either way.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0)
DECODE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 1.0)


def _compile_totals() -> tuple[int, float]:
    """Kernel libraries compiled in this process and their seconds."""
    return build.build_totals()


def _kernel_fallbacks() -> dict[str, int]:
    """Process-wide kernel-registry fallback counters ("impl:reason" ->
    count)."""
    try:
        from tpushare_torch.workloads.ops.registry import (
            fallback_counts_flat)
        return fallback_counts_flat()
    except Exception:  # noqa: BLE001 — telemetry must never raise
        return {}


# ---------------------------------------------------------------------------
# process snapshot provider
# ---------------------------------------------------------------------------

_provider_lock = threading.Lock()
_provider: Callable[[], dict] | None = None


def set_snapshot_provider(fn: Callable[[], dict] | None) -> None:
    """Install (or clear) the process's telemetry source; the last
    engine constructed wins."""
    global _provider
    with _provider_lock:
        _provider = fn


def current_snapshot() -> dict | None:
    """The live snapshot, or None when no engine publishes (or the
    provider throws — observability never fails its reader)."""
    with _provider_lock:
        fn = _provider
    if fn is None:
        return None
    try:
        return fn()
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# the per-engine core
# ---------------------------------------------------------------------------

class EngineTelemetry:
    """Thread-safe telemetry for one serving engine.

    Requests are keyed by ``id(request)`` — the engine retains the object
    from submit through retire, so the key is stable exactly as long as we
    need it and drops out of the table at retire (no unbounded growth; an
    abandoned submit is evicted oldest-first past ``max_pending``).
    """

    def __init__(self, window_s: float = 60.0, max_pending: int = 4096,
                 clock: Callable[[], float] | None = None,
                 slo: SLOPolicy | None = None) -> None:
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else time.monotonic
        self._window_s = window_s
        # the latency contract retired requests are judged against
        # (workloads/slo.py; consts.SLO_* defaults)
        self.slo = slo if slo is not None else SLOPolicy()
        self.ttft = metrics.Histogram(
            "ttft_seconds", "submit -> first token", buckets=TTFT_BUCKETS,
            max_samples=10_000)
        self.decode = metrics.Histogram(
            "decode_step_seconds", "per-token decode latency",
            buckets=DECODE_BUCKETS, max_samples=10_000)
        # submit-time per live request; bounded against abandoned submits
        self._pending: dict[int, float] = {}
        self._max_pending = max_pending
        # lifecycle phase marks per live request (submit/admit/prefill/
        # first timestamps) — same key + eviction discipline as _pending;
        # popped at every terminal to feed SLO phase attribution
        self._marks: dict[int, dict[str, float]] = {}
        # SLO accounting (docs/OBSERVABILITY.md "SLO & goodput"): each
        # terminal request is judged once — good, or violated in exactly
        # ONE phase — so the phase counters sum to the violation total
        self._slo_good = 0
        self._slo_violations: dict[str, int] = {
            p: 0 for p in consts.SLO_PHASES}
        # (monotonic ts, tokens) per SLO-good retirement: the goodput
        # window. Credited whole at retire — a request's tokens count
        # only once its completion proved they were within contract
        self._good_events: deque[tuple[float, int]] = deque()
        self._queue_depth = 0
        self._admitted = 0
        self._retired = 0
        self._bucket_admissions: dict[int, int] = {}
        # overload-defense accounting (docs/ROBUSTNESS.md): terminal
        # shed/deadline/OOM counts, the AIMD admission watermark, and
        # the sync-watchdog degraded flag
        self._shed = 0
        self._deadline_exceeded = 0
        self._oom_recoveries = 0
        self._watermark = -1.0   # -1 = no admission controller installed
        self._degraded = False
        # block-paged KV pool accounting (None until a paged engine
        # publishes — the slot engine's snapshot omits the page keys);
        # the prefix-cache pair rides the same conditionality
        self._pages: tuple[int, int, float, int, int] | None = None
        self._prefix_hits = 0
        self._cow_copies = 0
        # pool storage codec + bytes one cache row costs under it (None
        # until a paged engine publishes; a live property like the pool
        # keys, so reset() leaves it alone)
        self._kv_codec: tuple[str, float] | None = None
        # speculative-serving counters (None until an engine carrying a
        # draft model publishes — undrafted engines omit the keys):
        # (rounds, drafted, accepted, emitted)
        self._spec: tuple[int, int, int, int] | None = None
        # graceful-drain progress (None until a drain is requested —
        # snapshots of a normally-serving engine omit the keys):
        # (draining, drained). The rebalancer reads these off /usage to
        # learn when a migration victim has finished its in-flight work.
        self._drain: tuple[bool, bool] | None = None
        # fleet member id (None outside a fleet — the key is absent)
        self._fleet_engine_id: int | None = None
        # serving-mesh degrees (None for unsharded engines — the keys
        # are OMITTED rather than reported as 1s/zeros) and the pool
        # HBM one chip holds (paging.pool_hbm_mib over tp*pp shards;
        # None until a paged engine publishes). Live properties like
        # kv_codec — reset() leaves them alone.
        self._mesh: tuple[int, int] | None = None
        self._pool_shard_mib: float | None = None
        # (monotonic ts, tokens) per harvested chunk / spec round
        self._token_events: deque[tuple[float, int]] = deque()
        self._compile_base = _compile_totals()

    # ---- engine hooks -------------------------------------------------

    def submitted(self, key: int) -> None:
        now = self._clock()
        with self._lock:
            if key not in self._pending and \
                    len(self._pending) >= self._max_pending:
                evicted = next(iter(self._pending))
                self._pending.pop(evicted)
                self._marks.pop(evicted, None)
            self._pending[key] = now
            self._marks[key] = {"submit": now}
            self._queue_depth += 1

    def admit_start(self, key: int) -> None:
        """The request left the queue for an admission wave — the end of
        its queued phase. Gate checks / prefix splice / scratch init run
        between this mark and ``prefill_start``."""
        with self._lock:
            marks = self._marks.get(key)
            if marks is not None:
                marks.setdefault("admit", self._clock())

    def prefill_start(self, key: int) -> None:
        """Prefill chunks begin for the request — closes the admission
        phase; the prefill phase runs until ``first_token``."""
        with self._lock:
            marks = self._marks.get(key)
            if marks is not None:
                marks.setdefault("prefill", self._clock())

    def admitted(self, key: int) -> None:
        with self._lock:
            self._admitted += 1
            self._queue_depth = max(0, self._queue_depth - 1)

    def prefill_chunk(self, bucket: int) -> None:
        """One admission chunk compiled against ``bucket`` padded rows."""
        with self._lock:
            self._bucket_admissions[int(bucket)] = \
                self._bucket_admissions.get(int(bucket), 0) + 1

    def first_token(self, key: int) -> None:
        """The request's first token reached the host (sampled by the
        admission wave) — close its TTFT."""
        now = self._clock()
        with self._lock:
            t0 = self._pending.pop(key, None)
            marks = self._marks.get(key)
            if marks is not None:
                marks.setdefault("first", now)
        if t0 is not None:
            self.ttft.observe(max(0.0, now - t0))

    def decode_chunk(self, n_steps: int, wall_s: float,
                     tokens: int) -> None:
        """One harvested decode chunk: ``wall_s`` spans dispatch to
        host-side harvest (in the pipelined loop that includes the overlap
        window — documented, still the latency a caller experiences), so
        per-token latency is wall over steps."""
        if n_steps > 0 and wall_s >= 0:
            self.decode.observe(wall_s / n_steps)
        self.tokens(tokens)

    def tokens(self, n: int) -> None:
        """Credit ``n`` kept tokens to the throughput window (harvest and
        speculative rounds both land here)."""
        if n <= 0:
            return
        now = self._clock()
        with self._lock:
            self._token_events.append((now, int(n)))
            self._prune(now)

    def retired(self, key: int, tokens: int = 0,
                status: str | None = None) -> str | None:
        """The request reached a terminal in the engine's running set.
        With ``status`` (the engines always pass it) the request is
        judged against the SLO here — ONCE, in exactly one phase — and
        the violated phase (or None: within contract) is returned so the
        engine can tag the request's trace. Legacy callers that omit
        ``status`` get pure retire accounting, no SLO judgement."""
        now = self._clock()
        with self._lock:
            self._retired += 1
            self._pending.pop(key, None)
            marks = self._marks.pop(key, None)
            if status is None:
                return None
            violated = self._judge(marks, status, now, tokens)
            if violated is not None:
                self._slo_violations[violated] += 1
            else:
                self._slo_good += 1
                if tokens > 0:
                    self._good_events.append((now, int(tokens)))
                    self._prune_good(now)
        return violated

    def _judge(self, marks: dict[str, float] | None, status: str,
               now: float, tokens: int) -> str | None:
        """Judge one terminal request (lock held): the phase charged for
        its violation, or None when it met the SLO. A request that
        terminated without completing violated by definition and is
        charged to the furthest phase it reached; a completed one is
        judged by the policy over its phase durations. Chained-default
        marks make a missing intermediate mark attribute its time to the
        preceding phase rather than invent a negative duration."""
        if status != overload.STATUS_COMPLETED:
            if marks is None:
                return consts.SLO_PHASE_QUEUED
            return phase_reached("admit" in marks, "prefill" in marks,
                                 "first" in marks)
        if marks is None or "submit" not in marks:
            # untracked (evicted past max_pending): no timing evidence
            # against it — count it good, with no goodput credit
            return None
        submit = marks["submit"]
        admit = marks.get("admit", submit)
        prefill = marks.get("prefill", admit)
        first = marks.get("first", prefill)
        return self.slo.attribute(admit - submit, prefill - admit,
                                  first - prefill, max(0.0, now - first),
                                  max(0, int(tokens) - 1))

    def requeued(self, key: int) -> None:
        """A queued request was PULLED for re-routing (the fleet
        router's drain re-route, _EngineCore.take_queue): release its
        queue slot and pending entry with no terminal accounting — the
        router resubmits it elsewhere, where a fresh TTFT clock
        starts."""
        with self._lock:
            self._marks.pop(key, None)
            if self._pending.pop(key, None) is not None:
                self._queue_depth = max(0, self._queue_depth - 1)

    def cancelled(self, key: int) -> None:
        """A RUNNING request was released without a terminal status
        (PagedServingEngine.cancel_request — the fleet's hedged-prefill
        replay cancels the loser before re-admitting it elsewhere):
        drop its pending TTFT entry with no counter movement — the
        replay's clock starts fresh where it re-admits, and the one
        terminal status is owed by whoever ends up owning the request
        (docs/ROBUSTNESS.md "Fleet fault tolerance")."""
        with self._lock:
            self._marks.pop(key, None)
            self._pending.pop(key, None)

    # ---- overload-defense hooks ---------------------------------------

    def _charge_reached(self, key: int | None) -> None:
        """SLO accounting for a terminal that never passes through
        ``retired`` (lock held): queue sheds, queued deadline expiry and
        admit-wave quarantines are violations by definition, charged to
        the furthest phase the request reached. When ``retired`` already
        judged the request its marks are gone and this is a no-op — one
        judgement per request, so phase counters sum to the total."""
        if key is None:
            return
        marks = self._marks.pop(key, None)
        if marks is None:
            return
        self._slo_violations[phase_reached(
            "admit" in marks, "prefill" in marks, "first" in marks)] += 1

    def shed(self, key: int | None = None) -> None:
        """A request was terminally shed (full queue, drain, or an
        unservable HBM forecast) — it never reaches admit/retire, so its
        pending entry (and queued-depth slot, if it held one) is
        released here. A reject-new arrival is shed BEFORE ``submitted``
        ever tracked it (no marks) — still one offered request that died
        waiting, so it charges the queued phase; the exact-accounting
        invariant (every shed is an SLO violation) holds either way."""
        with self._lock:
            self._shed += 1
            if key is None or key not in self._marks:
                self._slo_violations[consts.SLO_PHASE_QUEUED] += 1
            else:
                self._charge_reached(key)
            if key is not None and self._pending.pop(key, None) is not None:
                self._queue_depth = max(0, self._queue_depth - 1)

    def deadline_exceeded(self, key: int | None = None,
                          queued: bool = False) -> None:
        """A request retired with the terminal deadline status; ``queued``
        when it expired before ever being admitted (its queue-depth slot
        is then released here, not by ``admitted``)."""
        with self._lock:
            self._deadline_exceeded += 1
            if queued:
                self._charge_reached(key)
            if key is not None:
                self._pending.pop(key, None)
            if queued:
                self._queue_depth = max(0, self._queue_depth - 1)

    def oom_recovery(self, key: int | None = None,
                     queued: bool = False) -> None:
        """The engine caught a RESOURCE_EXHAUSTED and stayed alive; the
        triggering request (if identified) was quarantined. ``queued``
        quarantines (admit-wave OOM on a request popped straight off the
        queue) never pass through ``retired``, so their SLO violation is
        charged here; running-victim quarantines were judged at
        retire."""
        with self._lock:
            self._oom_recoveries += 1
            if queued:
                self._charge_reached(key)
            if key is not None:
                self._pending.pop(key, None)
            if queued:
                self._queue_depth = max(0, self._queue_depth - 1)

    def set_watermark(self, value: float | None) -> None:
        """The AIMD admission watermark (slots admissible right now);
        None resets to the -1 'no admission controller' sentinel."""
        with self._lock:
            self._watermark = -1.0 if value is None else float(value)

    def set_degraded(self, flag: bool) -> None:
        """Sync-watchdog verdict: a device sync blew its wall-clock
        bound (True) / completed after all (False)."""
        with self._lock:
            self._degraded = bool(flag)

    def set_pages(self, total: int, in_use: int, frag_pct: float,
                  shared: int = 0, pinned: int = 0) -> None:
        """Block-paged KV pool accounting (PagedServingEngine publishes
        after every admit/retire/growth): usable pages, pages currently
        held by live requests, internal fragmentation percent, pages
        physically shared across block tables right now, and pages
        pinned by prefix registrations. The snapshot derives occupancy
        from the pair so the two can never disagree."""
        with self._lock:
            self._pages = (int(total), int(in_use), float(frag_pct),
                           int(shared), int(pinned))

    def set_kv_codec(self, codec: str, bytes_per_token: float) -> None:
        """The page pool's storage codec (consts.KV_CODECS) and the HBM
        bytes one cache row costs under it (paging.kv_bytes_per_token) —
        set once at paged-engine construction; rides every snapshot so
        /usage and `top` can report packing density."""
        with self._lock:
            self._kv_codec = (str(codec), float(bytes_per_token))

    def set_mesh(self, tp: int, pp: int) -> None:
        """Serving-mesh degrees of a SHARDED paged engine (set once at
        construction, only when tp*pp > 1 — unsharded engines omit the
        keys entirely, so `top`'s MESH column can tell "unsharded" from
        "tp1" without a sentinel)."""
        with self._lock:
            self._mesh = (int(tp), int(pp))

    def set_pool_shard_mib(self, mib: float) -> None:
        """Pool HBM ONE chip holds (paging.pool_hbm_mib over the
        engine's tp*pp shard count; the whole pool for an unsharded
        engine) — feeds consts.TELEMETRY_KV_POOL_SHARD_MIB and the
        per-chip tpushare_chip_kv_pool_shard_mib gauge."""
        with self._lock:
            self._pool_shard_mib = float(mib)

    def set_spec_stats(self, rounds: int, drafted: int, accepted: int,
                       emitted: int) -> None:
        """Speculative-serving counters (cumulative; both engines push
        after every draft-and-verify round, and once with zeros at
        construction so a drafted-but-quiet engine is distinguishable
        from an undrafted one). The snapshot derives the accept rate
        from the pair so the two can never disagree."""
        with self._lock:
            self._spec = (int(rounds), int(drafted), int(accepted),
                          int(emitted))

    def set_drain_state(self, draining: bool, drained: bool) -> None:
        """Graceful-drain progress (docs/ROBUSTNESS.md "Pressure-driven
        control loop"): the engine pushes (True, idle?) when a drain is
        requested and on every retirement while draining — `drained`
        flips once nothing is queued or in flight, which is the evidence
        the rebalancer waits on before deleting a migration victim."""
        with self._lock:
            self._drain = (bool(draining), bool(drained))

    def set_fleet_engine_id(self, engine_id: int | None) -> None:
        """Tag this engine's snapshots with its fleet member id
        (conditional key — single-engine payloads never carry it) so a
        per-engine view stays attributable inside a fleet's merged
        telemetry (docs/OBSERVABILITY.md "Fleet serving")."""
        with self._lock:
            self._fleet_engine_id = (None if engine_id is None
                                     else int(engine_id))

    def set_prefix_stats(self, hits: int, cow_copies: int) -> None:
        """Shared-prefix counters (cumulative): admissions served
        through a registered prefix, and copy-on-write page copies the
        write fence performed (docs/OBSERVABILITY.md "Shared-prefix
        pages")."""
        with self._lock:
            self._prefix_hits = int(hits)
            self._cow_copies = int(cow_copies)

    def waited(self, key: int) -> float | None:
        """Seconds a PENDING request has waited since submit (None once
        its first token landed, or if it was never tracked) — the live
        half of the fleet router's SLO shed forecast; reading it costs
        one dict lookup, no percentile sorts."""
        with self._lock:
            t0 = self._pending.get(key)
        return None if t0 is None else max(0.0, self._clock() - t0)

    def pressure_view(self) -> tuple[bool, float | None]:
        """(degraded, page occupancy pct | None) — the two snapshot
        fields routing decisions read, WITHOUT the full snapshot's
        percentile sorts (the fleet router probes this per engine per
        decision; a 10k-sample sort per probe would serialize the
        serving loop behind math nobody reads). Same values the
        published snapshot carries — steering and /usage can't
        disagree."""
        with self._lock:
            degraded = self._degraded
            pages = self._pages
        if pages is None:
            return degraded, None
        total, in_use = pages[0], pages[1]
        return degraded, (100.0 * in_use / total if total else 0.0)

    # ---- snapshot -----------------------------------------------------

    def _prune(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._token_events and self._token_events[0][0] < cutoff:
            self._token_events.popleft()

    def _prune_good(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._good_events and self._good_events[0][0] < cutoff:
            self._good_events.popleft()

    def tokens_per_s(self) -> float:
        """Throughput over the sliding window: tokens since the window's
        first event, over the time they actually spanned (up to now) —
        zero when nothing was emitted recently. The span is floored at
        1 s: a lone burst landing right after an idle stretch would
        otherwise divide by near-zero and report a rate thousands of
        times the real throughput (steady traffic spans the window and
        never feels the floor)."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            if not self._token_events:
                return 0.0
            total = sum(n for _, n in self._token_events)
            elapsed = now - self._token_events[0][0]
        return total / max(elapsed, 1.0)

    def goodput_tokens_per_s(self) -> float:
        """Tokens/s from requests that retired WITHIN the SLO, over the
        same sliding window (and 1 s floor) as ``tokens_per_s`` — the
        headline serving figure (docs/OBSERVABILITY.md "SLO & goodput").
        A request's tokens are credited whole at its retire instant:
        until completion proved them within contract they are throughput,
        not goodput, so goodput <= tokens/s can transiently invert right
        after a big retire but converges over the window."""
        now = self._clock()
        with self._lock:
            self._prune_good(now)
            if not self._good_events:
                return 0.0
            total = sum(n for _, n in self._good_events)
            elapsed = now - self._good_events[0][0]
        return total / max(elapsed, 1.0)

    def snapshot(self) -> dict:
        """JSON-safe snapshot under the consts.TELEMETRY_* schema — the
        exact dict that rides the usage POST and lands in `top`."""
        rate = self.tokens_per_s()
        goodput = self.goodput_tokens_per_s()
        compiles, compile_s = _compile_totals()
        base_n, base_s = self._compile_base
        with self._lock:
            queue_depth = self._queue_depth
            admitted, retired = self._admitted, self._retired
            slo_good = self._slo_good
            slo_viol = dict(self._slo_violations)
            buckets = dict(self._bucket_admissions)
            shed, deadline = self._shed, self._deadline_exceeded
            ooms, degraded = self._oom_recoveries, self._degraded
            watermark = self._watermark
            pages = self._pages
            prefix_hits, cow_copies = self._prefix_hits, self._cow_copies
            kv_codec = self._kv_codec
            spec = self._spec
            drain = self._drain
            engine_id = self._fleet_engine_id
            mesh_deg = self._mesh
            pool_shard = self._pool_shard_mib
        doc = {}
        if engine_id is not None:
            doc[consts.TELEMETRY_FLEET_ENGINE_ID] = engine_id
        if pages is not None:
            total, in_use, frag, shared, pinned = pages
            doc |= {
                consts.TELEMETRY_PAGES_TOTAL: total,
                consts.TELEMETRY_PAGES_IN_USE: in_use,
                consts.TELEMETRY_PAGE_OCCUPANCY_PCT: round(
                    100.0 * in_use / total, 1) if total else 0.0,
                consts.TELEMETRY_PAGE_FRAG_PCT: round(frag, 1),
                consts.TELEMETRY_PAGES_SHARED: shared,
                consts.TELEMETRY_PAGES_PINNED: pinned,
                consts.TELEMETRY_PREFIX_HITS: prefix_hits,
                consts.TELEMETRY_COW_COPIES: cow_copies,
            }
        if kv_codec is not None:
            codec, bpt = kv_codec
            doc[consts.TELEMETRY_KV_CODEC] = codec
            doc[consts.TELEMETRY_KV_BYTES_PER_TOKEN] = round(bpt, 1)
        if pool_shard is not None:
            doc[consts.TELEMETRY_KV_POOL_SHARD_MIB] = round(pool_shard, 1)
        if mesh_deg is not None:
            doc[consts.TELEMETRY_MESH_TP] = mesh_deg[0]
            doc[consts.TELEMETRY_MESH_PP] = mesh_deg[1]
        if drain is not None:
            doc[consts.TELEMETRY_DRAINING] = int(drain[0])
            doc[consts.TELEMETRY_DRAINED] = int(drain[1])
        if spec is not None:
            rounds, drafted, accepted, emitted = spec
            doc[consts.TELEMETRY_SPEC_ROUNDS] = rounds
            doc[consts.TELEMETRY_SPEC_DRAFTED] = drafted
            doc[consts.TELEMETRY_SPEC_ACCEPTED] = accepted
            doc[consts.TELEMETRY_SPEC_EMITTED] = emitted
            doc[consts.TELEMETRY_SPEC_ACCEPT_RATE] = round(
                accepted / max(1, drafted), 4)
        # kernel-registry fallback counters are PROCESS-wide (the registry
        # is the process's one selection point), attached only when any
        # degradation happened — a clean kernel-serving pod's POST stays
        # byte-identical to before
        fallbacks = _kernel_fallbacks()
        if fallbacks:
            doc[consts.TELEMETRY_KERNEL_FALLBACKS] = fallbacks
        return {
            **doc,
            consts.TELEMETRY_ADMISSION_WATERMARK: round(watermark, 2),
            consts.TELEMETRY_SHED: shed,
            consts.TELEMETRY_DEADLINE_EXCEEDED: deadline,
            consts.TELEMETRY_OOM_RECOVERIES: ooms,
            consts.TELEMETRY_DEGRADED: int(degraded),
            consts.TELEMETRY_TTFT_P50_MS: round(
                self.ttft.percentile(50) * 1e3, 3),
            consts.TELEMETRY_TTFT_P99_MS: round(
                self.ttft.percentile(99) * 1e3, 3),
            consts.TELEMETRY_DECODE_P50_MS: round(
                self.decode.percentile(50) * 1e3, 3),
            consts.TELEMETRY_DECODE_P99_MS: round(
                self.decode.percentile(99) * 1e3, 3),
            consts.TELEMETRY_TOKENS_PER_S: round(rate, 1),
            # SLO plane — always present once an engine publishes: a
            # quiet engine reports ZEROS, not absence (the sanitizer and
            # `top` read presence as "this payload judges its SLO")
            consts.TELEMETRY_GOODPUT_TOKENS_PER_S: round(goodput, 1),
            consts.TELEMETRY_SLO_GOOD: slo_good,
            consts.TELEMETRY_SLO_VIOLATIONS_QUEUED:
                slo_viol[consts.SLO_PHASE_QUEUED],
            consts.TELEMETRY_SLO_VIOLATIONS_ADMISSION:
                slo_viol[consts.SLO_PHASE_ADMISSION],
            consts.TELEMETRY_SLO_VIOLATIONS_PREFILL:
                slo_viol[consts.SLO_PHASE_PREFILL],
            consts.TELEMETRY_SLO_VIOLATIONS_DECODE:
                slo_viol[consts.SLO_PHASE_DECODE],
            consts.TELEMETRY_QUEUE_DEPTH: queue_depth,
            consts.TELEMETRY_ADMITTED: admitted,
            consts.TELEMETRY_RETIRED: retired,
            consts.TELEMETRY_PREFILL_BUCKETS: {
                str(b): n for b, n in sorted(buckets.items())},
            consts.TELEMETRY_COMPILES: compiles - base_n,
            consts.TELEMETRY_COMPILE_SECONDS: round(
                compile_s - base_s, 3),
        }

    def reset(self) -> None:
        """Zero everything (in place — the published provider binding
        survives): benchmarks call this after a compile-warmup drain so
        warm-up TTFT doesn't blend into the measured tail."""
        with self._lock:
            self.ttft = metrics.Histogram(
                "ttft_seconds", "submit -> first token",
                buckets=TTFT_BUCKETS, max_samples=10_000)
            self.decode = metrics.Histogram(
                "decode_step_seconds", "per-token decode latency",
                buckets=DECODE_BUCKETS, max_samples=10_000)
            self._pending.clear()
            self._marks.clear()
            self._queue_depth = 0
            self._admitted = 0
            self._retired = 0
            self._bucket_admissions.clear()
            self._shed = 0
            self._deadline_exceeded = 0
            self._oom_recoveries = 0
            self._slo_good = 0
            self._slo_violations = {p: 0 for p in consts.SLO_PHASES}
            self._good_events.clear()
            # watermark/degraded are live state, not counters: a bench
            # reset must not erase the engine's current admission posture
            # (pages stay too — pool occupancy survives a stats reset;
            # the prefix COUNTERS zero with the engine's stats, which
            # re-publish them on the next admit/retire)
            self._prefix_hits = 0
            self._cow_copies = 0
            if self._spec is not None:
                # the spec counters zero with the engine's stats; the
                # keys stay present (drafted-ness is live state)
                self._spec = (0, 0, 0, 0)
            self._token_events.clear()
            self._compile_base = _compile_totals()

    def publish(self) -> "EngineTelemetry":
        """Install this instance as the process snapshot provider (what
        the usage reporter attaches to every POST)."""
        set_snapshot_provider(self.snapshot)
        return self


# ---------------------------------------------------------------------------
# fleet aggregation
# ---------------------------------------------------------------------------

# counters that sum across member engines (the SLO verdicts of every
# member too: a degraded member's violations are real; its goodput is
# not banked — fleet_snapshot sums goodput over healthy members only)
_FLEET_SUM_KEYS = (
    consts.TELEMETRY_TOKENS_PER_S, consts.TELEMETRY_QUEUE_DEPTH,
    consts.TELEMETRY_ADMITTED, consts.TELEMETRY_RETIRED,
    consts.TELEMETRY_SHED, consts.TELEMETRY_DEADLINE_EXCEEDED,
    consts.TELEMETRY_OOM_RECOVERIES,
    consts.TELEMETRY_PAGES_TOTAL, consts.TELEMETRY_PAGES_IN_USE,
    consts.TELEMETRY_PAGES_SHARED, consts.TELEMETRY_PAGES_PINNED,
    consts.TELEMETRY_PREFIX_HITS, consts.TELEMETRY_COW_COPIES,
    consts.TELEMETRY_KV_POOL_SHARD_MIB,
    consts.TELEMETRY_SPEC_ROUNDS, consts.TELEMETRY_SPEC_DRAFTED,
    consts.TELEMETRY_SPEC_ACCEPTED, consts.TELEMETRY_SPEC_EMITTED,
    consts.TELEMETRY_SLO_GOOD,
    consts.TELEMETRY_SLO_VIOLATIONS_QUEUED,
    consts.TELEMETRY_SLO_VIOLATIONS_ADMISSION,
    consts.TELEMETRY_SLO_VIOLATIONS_PREFILL,
    consts.TELEMETRY_SLO_VIOLATIONS_DECODE,
)


def _merged_percentile(hists: list, q: float) -> float:
    """Exact percentile over the union of the histograms' sample pools,
    through ``metrics.Histogram``'s own index rule."""
    samples: list[float] = []
    for h in hists:
        samples.extend(h.samples_snapshot())
    return metrics.Histogram.percentile_of(samples, q)


def fleet_snapshot(telemetries: list, extra: dict | None = None) -> dict:
    """Merge N member engines' telemetry into one snapshot under the
    single engine's schema: counters sum, the TTFT and decode tails are
    exact over the union of the members' sample pools, degraded and
    draining take the worst member, goodput sums over members that are
    not degraded, the admission watermark sums over members that carry
    one, and the compile counters take the largest member's (the kernel
    builds are process-wide: summing would count one build N times).
    ``extra`` (the router's fleet counters) lands last."""
    snaps = [t.snapshot() for t in telemetries]
    out: dict = {}
    for key in _FLEET_SUM_KEYS:
        vals = [s[key] for s in snaps if key in s]
        if vals:
            total = sum(vals)
            out[key] = round(total, 1) if isinstance(total, float) else total
    out[consts.TELEMETRY_GOODPUT_TOKENS_PER_S] = round(sum(
        s.get(consts.TELEMETRY_GOODPUT_TOKENS_PER_S, 0.0) for s in snaps
        if not s.get(consts.TELEMETRY_DEGRADED)), 1)
    total = out.get(consts.TELEMETRY_PAGES_TOTAL)
    if total:
        out[consts.TELEMETRY_PAGE_OCCUPANCY_PCT] = round(
            100.0 * out.get(consts.TELEMETRY_PAGES_IN_USE, 0) / total, 1)
        # weighted by pages in use: an idle member's 0% must not dilute
        # a loaded member's waste
        pairs = [(s.get(consts.TELEMETRY_PAGE_FRAG_PCT, 0.0),
                  s.get(consts.TELEMETRY_PAGES_IN_USE, 0))
                 for s in snaps if consts.TELEMETRY_PAGE_FRAG_PCT in s]
        weight = sum(w for _, w in pairs)
        out[consts.TELEMETRY_PAGE_FRAG_PCT] = round(
            sum(f * w for f, w in pairs) / weight, 1) if weight else 0.0
    if consts.TELEMETRY_SPEC_DRAFTED in out:
        out[consts.TELEMETRY_SPEC_ACCEPT_RATE] = round(
            out.get(consts.TELEMETRY_SPEC_ACCEPTED, 0)
            / max(1, out[consts.TELEMETRY_SPEC_DRAFTED]), 4)
    codecs = {s[consts.TELEMETRY_KV_CODEC] for s in snaps
              if consts.TELEMETRY_KV_CODEC in s}
    if len(codecs) == 1:
        out[consts.TELEMETRY_KV_CODEC] = codecs.pop()
        bpts = [s[consts.TELEMETRY_KV_BYTES_PER_TOKEN] for s in snaps
                if consts.TELEMETRY_KV_BYTES_PER_TOKEN in s]
        if bpts:
            out[consts.TELEMETRY_KV_BYTES_PER_TOKEN] = round(
                sum(bpts) / len(bpts), 1)
    for key, attr, q in (
            (consts.TELEMETRY_TTFT_P50_MS, "ttft", 50),
            (consts.TELEMETRY_TTFT_P99_MS, "ttft", 99),
            (consts.TELEMETRY_DECODE_P50_MS, "decode", 50),
            (consts.TELEMETRY_DECODE_P99_MS, "decode", 99)):
        out[key] = round(_merged_percentile(
            [getattr(t, attr) for t in telemetries], q) * 1e3, 3)
    marks = [s[consts.TELEMETRY_ADMISSION_WATERMARK] for s in snaps
             if s.get(consts.TELEMETRY_ADMISSION_WATERMARK, -1.0) >= 0]
    out[consts.TELEMETRY_ADMISSION_WATERMARK] = round(
        sum(marks), 2) if marks else -1.0
    out[consts.TELEMETRY_DEGRADED] = int(any(
        s.get(consts.TELEMETRY_DEGRADED) for s in snaps))
    draining = [s for s in snaps if consts.TELEMETRY_DRAINING in s]
    if draining:
        out[consts.TELEMETRY_DRAINING] = int(any(
            s[consts.TELEMETRY_DRAINING] for s in draining))
        out[consts.TELEMETRY_DRAINED] = int(all(
            s.get(consts.TELEMETRY_DRAINED) for s in draining))
    buckets: dict[str, int] = {}
    for s in snaps:
        for b, n in (s.get(consts.TELEMETRY_PREFILL_BUCKETS) or {}).items():
            buckets[b] = buckets.get(b, 0) + n
    out[consts.TELEMETRY_PREFILL_BUCKETS] = dict(sorted(buckets.items()))
    out[consts.TELEMETRY_COMPILES] = max(
        (s.get(consts.TELEMETRY_COMPILES, 0) for s in snaps), default=0)
    out[consts.TELEMETRY_COMPILE_SECONDS] = max(
        (s.get(consts.TELEMETRY_COMPILE_SECONDS, 0.0) for s in snaps),
        default=0.0)
    fallbacks = next((s[consts.TELEMETRY_KERNEL_FALLBACKS] for s in snaps
                      if consts.TELEMETRY_KERNEL_FALLBACKS in s), None)
    if fallbacks:
        # process-wide counters: every member reports the same map
        out[consts.TELEMETRY_KERNEL_FALLBACKS] = fallbacks
    out[consts.TELEMETRY_FLEET_ENGINES] = len(telemetries)
    if extra:
        out.update(extra)
    return out
