"""Fleet serving — the port of ``tpushare/workloads/fleet.py``: a
prefix-affinity router over paged engines co-resident on one card.

Everything below this module is one engine; :class:`FleetRouter` puts N
``PagedServingEngine``s (or ``remote.RemoteMember`` proxies of engines
in other processes) behind one front door. It runs no device code:
every decision reads host state (queue depths, the page allocators, the
engines' telemetry), so the policy is the reference's, decision for
decision, and testable on the CPU.

Placement per submit, in priority order, each decision with a typed
reason (``stats["reasons"]``):

- **prefix affinity** (``affinity_hit``): a request naming a registered
  prefix routes to an engine where that prefix is pinned. Past
  ``FLEET_REPLICATE_DEPTH`` queued requests on every pinned engine the
  router replicates the prefix to the least-loaded unpinned engine by
  page handoff (``extract_prefix`` -> ``install_prefix_pages``: the same
  pages, no prefill) and routes there (``affinity_miss``).
- **pressure** (``pressure_spill``): an engine whose telemetry reads
  degraded, draining or page occupancy >= ``consts.PRESSURE_ENGAGE`` is
  skipped while a colder one exists.
- **queue depth** (``depth_spill``): ties go to the shallowest
  queue + running engine.
- **fleet full** (``fleet_full``): every routable queue is at its bound;
  the request is shed with the overload status, counted here. With
  ``slo_aware`` the router first sheds a queued request whose wait
  already blew its TTFT budget (``slo_budget``) and routes the arrival
  into the freed slot.

Disaggregation (``disaggregate=True``): the first ``n_prefill`` engines
only admit and prefill (``prefill_step``); each finished admission's
pages move into a decode engine's pool and lane (``extract_request`` ->
``install_request`` -> ``detach_request``, byte for byte on both KV
codecs, all or nothing), so decode lanes never wait behind a long
prompt. A decode side that cannot take a handoff now leaves the request
on its prefill lane, which defers further admission: the fleet's
backpressure.

Fault tolerance: every member carries a circuit breaker (closed -> open
-> half_open -> closed, ``consts.FLEET_MEMBER_STATES``) driven by healthz
probes under a wall timeout, watchdog-trip and OOM-recovery deltas,
consecutive dispatch faults escaping ``step()`` and, for a remote
member, consecutive wire faults. An opening breaker evacuates the
member: queued requests are admitted again elsewhere under a hedge
budget, in-flight ones are salvaged by page migration (the generator
state of a sampling lane moves with its pages) or shed with the typed
``member_failed`` reason, and prefixes that lost their last pin are
registered again from the remembered tokens. A fatal failure respawns
the member through ``factory``; ``scale_in`` retires one gracefully.

Telemetry: the router installs one merged snapshot
(``telemetry.fleet_snapshot``) with the ``consts.TELEMETRY_FLEET_*``
keys as the process provider, and advances the five fleet series of
``metrics.py``.
"""

from __future__ import annotations

import queue as _queue
import threading
import time

from tpushare_torch import consts, metrics
from tpushare_torch.workloads import overload
from tpushare_torch.workloads.telemetry import (fleet_snapshot,
                                          set_snapshot_provider)
from tpushare_torch.workloads.transport import TransportError

__all__ = ["FleetRouter", "RouteDecision", "ROUTE_REASONS",
           "REASON_AFFINITY_HIT", "REASON_AFFINITY_MISS",
           "REASON_PRESSURE_SPILL", "REASON_DEPTH_SPILL",
           "REASON_FLEET_FULL", "REASON_MEMBER_FAILED",
           "REASON_SLO_BUDGET",
           "FLEET_REPLICATE_DEPTH", "FAILURE_REASONS"]

# typed per-decision reasons — the router's whole decision space, so the
# bench/telemetry reason map is exhaustive by construction
REASON_AFFINITY_HIT = "affinity_hit"
REASON_AFFINITY_MISS = "affinity_miss"
REASON_PRESSURE_SPILL = "pressure_spill"
REASON_DEPTH_SPILL = "depth_spill"
REASON_FLEET_FULL = "fleet_full"
# a shed caused by member failure, not load: the request lost its member
# and could not be hedged or salvaged (consts.FLEET_SHED_MEMBER_FAILED —
# the same string the failover-outcome metric and telemetry key use)
REASON_MEMBER_FAILED = consts.FLEET_SHED_MEMBER_FAILED
# SLO-aware shed: the fleet was full, and instead of rejecting the
# ARRIVAL the router shed the queued request whose wait already blew the
# TTFT budget — the victim was doomed either way, the arrival still has
# its whole budget. The reason types BOTH sides: the victim's
# engine-side shed and the arrival's route.
REASON_SLO_BUDGET = "slo_budget"
ROUTE_REASONS = (REASON_AFFINITY_HIT, REASON_AFFINITY_MISS,
                 REASON_PRESSURE_SPILL, REASON_DEPTH_SPILL,
                 REASON_FLEET_FULL, REASON_MEMBER_FAILED,
                 REASON_SLO_BUDGET)

# queued requests per pinned engine before a hot prefix replicates to a
# second engine (the depth at which waiting out the pinned queue costs
# more than one page-handoff replication)
FLEET_REPLICATE_DEPTH = 4

# typed failure-detection verdicts — why a member's breaker opened
# (healthz()["members"][i]["reason"]; the detection space is closed so
# the chaos suites can assert the router saw the fault they injected)
FAILURE_PROBE_TIMEOUT = "probe_timeout"
FAILURE_WATCHDOG = "watchdog_trips"
FAILURE_OOM_STORM = "oom_storm"
FAILURE_DISPATCH = "dispatch_faults"
# the wire to a REMOTE member keeps faulting: consecutive
# TransportErrors past consts.FLEET_BREAKER_WIRE_FAULTS open the breaker
# NON-fatally — cooldown then half-open reconnect probes close it when
# the host answers again (the member process may be fine; the wire died)
FAILURE_TRANSPORT = "transport_faults"
FAILURE_MANUAL = "manual"
FAILURE_REASONS = (FAILURE_PROBE_TIMEOUT, FAILURE_WATCHDOG,
                   FAILURE_OOM_STORM, FAILURE_DISPATCH,
                   FAILURE_TRANSPORT, FAILURE_MANUAL)


class _MemberHealth:
    """Per-member breaker record: current state, why it last opened,
    whether the failure was fatal (a respawn is owed) or the member was
    retired by scale-in, and the detection baselines the probe loop
    diffs against."""

    __slots__ = ("state", "reason", "fatal", "retired", "opened_at",
                 "consecutive_faults", "consecutive_wire_faults",
                 "half_open_ok", "watchdog_base", "oom_base")

    def __init__(self) -> None:
        self.state = consts.FLEET_MEMBER_CLOSED
        self.reason: str | None = None
        self.fatal = False
        self.retired = False
        self.opened_at = 0.0
        self.consecutive_faults = 0
        self.consecutive_wire_faults = 0
        self.half_open_ok = 0
        self.watchdog_base = 0
        self.oom_base = 0


class RouteDecision:
    """One routing verdict: which engine (None = shed) and why (one of
    ROUTE_REASONS). A plain value object so tests and the bench can
    assert on decisions without reaching into router internals."""

    __slots__ = ("engine", "reason")

    def __init__(self, engine: int | None, reason: str) -> None:
        self.engine = engine
        self.reason = reason

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"RouteDecision(engine={self.engine}, reason={self.reason!r})"


class FleetRouter:
    """Front door over N in-process ``PagedServingEngine``s.

    ``engines`` must share one pool layout (kv_codec + page_size — the
    byte-exact handoff contract) and one ``max_seq``/bucket config (a
    handed-off request must fit any member). ``affinity=False`` turns
    off pin-steering and replication (requests route by pressure/depth
    only — the bench A/B's control arm); prefix-naming requests still
    route to a pinned engine, correctness never degrades.
    """

    def __init__(self, engines: list, *, disaggregate: bool = False,
                 n_prefill: int = 1, affinity: bool = True,
                 replicate_depth: int = FLEET_REPLICATE_DEPTH,
                 publish: bool = True, factory=None,
                 probe_timeout_s: float = consts.FLEET_PROBE_TIMEOUT_S,
                 probe_interval_s: float = consts.FLEET_PROBE_INTERVAL_S,
                 breaker_dispatch_faults: int =
                     consts.FLEET_BREAKER_DISPATCH_FAULTS,
                 breaker_watchdog_trips: int =
                     consts.FLEET_BREAKER_WATCHDOG_TRIPS,
                 breaker_oom_storm: int = consts.FLEET_BREAKER_OOM_STORM,
                 breaker_cooldown_s: float =
                     consts.FLEET_BREAKER_COOLDOWN_S,
                 half_open_probes: int =
                     consts.FLEET_BREAKER_HALF_OPEN_PROBES,
                 hedge_budget: int =
                     consts.FLEET_HEDGE_RETRY_BUDGET,
                 breaker_wire_faults: int =
                     consts.FLEET_BREAKER_WIRE_FAULTS,
                 slo_aware: bool = True) -> None:
        if not engines:
            raise ValueError(consts.ERR_FLEET_EMPTY)
        layouts = {e.pool_layout for e in engines}
        if len(layouts) > 1:
            raise ValueError(consts.ERR_HANDOFF_POOL_FMT.format(
                src=sorted(layouts)[0], dst=sorted(layouts)[1]))
        if len({(e.max_seq, e.buckets) for e in engines}) > 1:
            # a handed-off request must fit ANY member: a shorter
            # destination max_seq (or a different bucket ladder feeding
            # the prefill layout) would turn a mid-run handoff into an
            # uncaught ValueError instead of this constructor-time one
            raise ValueError(consts.ERR_FLEET_SEQ_MISMATCH_FMT.format(
                got=sorted({(e.max_seq, e.buckets) for e in engines})))
        if disaggregate and not 1 <= n_prefill < len(engines):
            raise ValueError(consts.ERR_FLEET_DISAGG_FMT.format(
                n_prefill=n_prefill, engines=len(engines)))
        self.engines = list(engines)
        self.disaggregate = disaggregate
        self.n_prefill = n_prefill if disaggregate else 0
        self.affinity = affinity
        if replicate_depth < 1:
            raise ValueError(consts.ERR_FLEET_REPLICATE_DEPTH_FMT.format(
                depth=replicate_depth))
        self.replicate_depth = replicate_depth
        # fault tolerance: the shared pool layout + shape contract every
        # factory-built replacement must honor, and the breaker knobs
        # (consts-pinned defaults; overridable per fleet for tests)
        self._factory = factory
        self._layout = next(iter(layouts))
        self._shape = (engines[0].max_seq, engines[0].buckets)
        self.probe_timeout_s = probe_timeout_s
        self.probe_interval_s = probe_interval_s
        self.breaker_dispatch_faults = breaker_dispatch_faults
        self.breaker_watchdog_trips = breaker_watchdog_trips
        self.breaker_oom_storm = breaker_oom_storm
        self.breaker_cooldown_s = breaker_cooldown_s
        self.half_open_probes = half_open_probes
        self.hedge_budget = hedge_budget
        self.breaker_wire_faults = breaker_wire_faults
        # SLO-aware admission:
        # when the fleet is full, shed the queued request whose wait
        # forecast already blew the TTFT budget instead of the arrival.
        # False = plain FIFO reject-new (the bench A/B's control arm).
        self.slo_aware = slo_aware
        self._health = [_MemberHealth() for _ in self.engines]
        # hedge ledger: id(req) -> re-admissions so far (Request is a
        # plain dataclass the router must not grow fields on)
        self._hedge_counts: dict[int, int] = {}
        self._last_probe = time.monotonic()
        # router accounting: every SUBMIT lands in exactly one reason
        # (drain re-routes move a request without re-counting — they
        # tally under "rerouted"), sheds are ALSO terminal-status-
        # accounted on the request
        self.stats = {"submitted": 0, "shed": 0, "handoffs": 0,
                      "replications": 0, "affinity_hits": 0,
                      "rerouted": 0, "migrations": 0, "hedged": 0,
                      "breaker_opens": 0, "breaker_recoveries": 0,
                      "dispatch_faults": 0, "respawns": 0,
                      "scale_ins": 0, "slo_sheds": 0,
                      "wire_faults": 0, "remote_migrations": 0,
                      "reasons": {}}
        # prefix registry: name -> tokens (kept for replication) and the
        # member ids currently holding the pin
        self._prefix_tokens: dict[str, list] = {}
        self._prefix_homes: dict[str, set[int]] = {}
        self._draining = False
        for i, e in enumerate(self.engines):
            e.telemetry.set_fleet_engine_id(i)
            self._publish_state(i)
        self._publishing = publish
        if publish:
            self.publish()

    # ---- roles --------------------------------------------------------

    def _routable(self, i: int) -> bool:
        """A member takes new work unless it is draining, its breaker
        is OPEN (half_open members are routable — the trial traffic IS
        the recovery probe), or it was retired by scale-in."""
        h = self._health[i]
        return (not h.retired
                and h.state != consts.FLEET_MEMBER_OPEN
                and not self.engines[i].draining)

    def _submit_targets(self) -> list[int]:
        """Engine ids submits may route to: the prefill set under
        disaggregation (admission runs there; decode engines receive
        work only by page handoff), everyone otherwise."""
        ids = (range(self.n_prefill) if self.disaggregate
               else range(len(self.engines)))
        return [i for i in ids if self._routable(i)]

    def _decode_targets(self) -> list[int]:
        return [i for i in range(self.n_prefill, len(self.engines))
                if self._routable(i)]

    # ---- signals ------------------------------------------------------

    def _pressured(self, i: int) -> bool:
        """Live member pressure off the engine's OWN telemetry — the
        same degraded/occupancy fields its usage POST carries
        (EngineTelemetry.pressure_view: no percentile sorts on the
        routing path), so router steering and the control plane read
        one signal."""
        degraded, occupancy = self.engines[i].telemetry.pressure_view()
        return degraded or (occupancy is not None
                            and occupancy >= 100.0 * consts.PRESSURE_ENGAGE)

    def _depth(self, i: int) -> int:
        e = self.engines[i]
        return len(e.queue) + len(e.running)

    def _has_room(self, i: int) -> bool:
        e = self.engines[i]
        return e.queue_limit is None or len(e.queue) < e.queue_limit

    def _coldest(self, ids: list[int]) -> int | None:
        """Least-loaded routable engine, cold-first: fully-closed
        breakers outrank half-open ones (trial traffic trickles, it
        does not flood a recovering member), unpressured engines
        outrank pressured ones, then queue+running depth, then id (a
        stable tiebreak keeps tests deterministic)."""
        ids = [i for i in ids if self._has_room(i)]
        if not ids:
            return None
        return min(ids, key=lambda i: (
            self._health[i].state != consts.FLEET_MEMBER_CLOSED,
            self._pressured(i), self._depth(i), i))

    # ---- prefix registry ----------------------------------------------

    def register_prefix(self, name: str, tokens: list,
                        engine: int | None = None) -> int:
        """Register a shared prefix on ONE member (the least-loaded
        submit target unless pinned explicitly) and remember the tokens
        — replication needs them for the draft half and the
        registration guards. Returns the home engine id."""
        targets = self._submit_targets()
        if engine is None:
            engine = self._coldest(targets)
            if engine is None:
                engine = targets[0] if targets else 0
        self.engines[engine].register_prefix(name, list(tokens))
        self._prefix_tokens[name] = list(tokens)
        self._prefix_homes[name] = {engine}
        return engine

    def drop_prefix(self, name: str) -> None:
        """Unpin a registration from EVERY member holding it (queued
        subscribers on each are shed by the engines with exact
        accounting, like single-engine drop_prefix)."""
        homes = self._prefix_homes.pop(name, None)
        if homes is None:
            raise ValueError(
                consts.ERR_PREFIX_UNKNOWN_FMT.format(name=name))
        self._prefix_tokens.pop(name, None)
        for i in homes:
            self.engines[i].drop_prefix(name)

    def _replicate_prefix(self, name: str, dst: int) -> bool:
        """Replicate a hot prefix's pinned pages onto member ``dst`` by
        page handoff — byte-identical pins, no target-model prefill,
        and the SOURCE registration (pins, live subscribers) is
        untouched. False when the destination can't pin right now
        (pool room) — the submit then rides the existing pins."""
        src = next(iter(self._prefix_homes[name]))
        eng = self.engines[dst]
        try:
            record = self.engines[src].extract_prefix(name)
            eng.install_prefix_pages(name, self._prefix_tokens[name],
                                     record)
        except eng._paging.PagePoolExhausted:
            return False
        self._prefix_homes[name].add(dst)
        self.stats["replications"] += 1
        self.stats["handoffs"] += 1
        return True

    def _rehome_prefix(self, name: str) -> int | None:
        """Re-establish a registration that lost its LAST pinned home
        to member failure: re-register the remembered tokens on the
        coldest healthy submit target (a real prefill recompute — the
        pinned pages died with the member, there is nothing to hand
        off). None when no member can pin right now; the registration
        stays empty and heals lazily on the next subscriber."""
        targets = self._submit_targets()
        dst = self._coldest(targets) if targets else None
        if dst is None:
            return None
        eng = self.engines[dst]
        try:
            eng.register_prefix(name, list(self._prefix_tokens[name]))
        except eng._paging.PagePoolExhausted:
            return None
        self._prefix_homes[name] = {dst}
        return dst

    # ---- routing ------------------------------------------------------

    def _count(self, reason: str, count: bool = True) -> None:
        if not count:
            return
        reasons = self.stats["reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1

    def _shed(self, req, count: bool = True,
              reason: str = REASON_FLEET_FULL) -> RouteDecision:
        """Terminal shed riding the overload statuses: exactly one
        terminal status, stamped here because no engine ever owned the
        request (or its member released it back). ``fleet_full`` reads
        in the broad sense — NO routable engine could take this
        request; ``member_failed`` means the request lost its member
        and neither hedging nor salvage could place it (shed-by-reason
        accounting the usage payload and ``top`` surface — never a
        silent truncation)."""
        req.done = True
        req.status = overload.STATUS_SHED
        self.stats["shed"] += 1
        # a router-shed request was never owned by an engine at terminal
        # time, so no member telemetry judges it — snapshot() folds
        # stats["shed"] into the queued-phase violation count, and the
        # trace (attached if any engine ever held the request) flushes
        # here: a non-completed terminal is always kept
        if getattr(req, "_trace", None) is not None:
            req._trace.finish(req.status, keep=True)
        # member_failed ALWAYS reason-counts, even on the count=False
        # re-route path: shed-by-reason visibility is the whole point
        # of the typed failure shed
        self._count(reason, count or reason == REASON_MEMBER_FAILED)
        self._hedge_counts.pop(id(req), None)
        if reason == REASON_MEMBER_FAILED:
            metrics.FLEET_FAILOVER_OUTCOMES.labels(
                outcome=consts.FLEET_SHED_MEMBER_FAILED).inc()
        return RouteDecision(None, reason)

    def submit(self, req) -> RouteDecision:
        """Route one request (see the module docstring for the policy);
        the decision's reason is counted in ``stats["reasons"]``."""
        self.stats["submitted"] += 1
        return self._route(req)

    def _route(self, req, count: bool = True,
               shed_reason: str = REASON_FLEET_FULL) -> RouteDecision:
        """The routing body, shared by :meth:`submit`, the drain
        re-route, and the failover hedge — the latter two pass
        ``count=False``: the request was already offered (and
        reason-counted) once, so a re-route moves it without touching
        ``submitted``, the reason map, or the affinity-hit tally (only
        ``shed`` stays live — a re-route that sheds is a real terminal
        outcome the ledger is owed, typed by ``shed_reason``)."""
        targets = self._submit_targets()
        if self._draining or not targets:
            return self._shed(req, count, shed_reason)
        if all(not self._has_room(i) for i in targets):
            if self.slo_aware and shed_reason == REASON_FLEET_FULL:
                decision = self._slo_budget_admit(req, targets, count)
                if decision is not None:
                    return decision
            return self._shed(req, count, shed_reason)
        if req.prefix is not None:
            return self._route_subscriber(req, targets, count,
                                          shed_reason)
        choice = self._coldest(targets)
        if choice is None:
            return self._shed(req, count, shed_reason)
        reason = (REASON_PRESSURE_SPILL
                  if any(self._pressured(i) for i in targets
                         if i != choice) and not self._pressured(choice)
                  else REASON_DEPTH_SPILL)
        if not self._submit_to(choice, req):
            return self._resubmit(req, count)
        self._stamp_route(choice, req, reason)
        self._count(reason, count)
        return RouteDecision(choice, reason)

    def _submit_to(self, i: int, req) -> bool:
        """Submit with the wire inside the fault domain: a remote
        member's submit can die on a cut/hung socket AFTER the retry
        policy gave up. False = the submit did not land — the fault is
        charged to the member's wire breaker and the caller must
        re-route (bounded: each failed offer moves the member toward an
        OPEN breaker, shrinking the target set)."""
        try:
            self.engines[i].submit(req)
            return True
        except TransportError as exc:
            self._wire_fault(i, exc)
            return False

    def _resubmit(self, req, count: bool) -> RouteDecision:
        """Re-route after a wire-failed offer. ``submitted`` and the
        first-choice reason were already (not) counted by the caller's
        path; the re-route moves the request without re-counting, and a
        shed here is a real member_failed terminal."""
        return self._route(req, count=False,
                           shed_reason=REASON_MEMBER_FAILED)

    def _stamp_route(self, i: int, req, reason: str) -> None:
        """Record the route decision on the request's trace (the engine
        attached the RequestTrace during submit) — the typed reason is
        the span attr the reqtrace view surfaces."""
        self.engines[i].trace_event(req, "fleet.route", member=i,
                                    reason=reason)

    def _slo_budget_admit(self, req, targets: list[int],
                          count: bool) -> RouteDecision | None:
        """Full fleet, SLO-aware arm: find the
        queued request whose (waited + forecast head-of-queue wait, the
        member's observed median TTFT) most exceeds the TTFT budget —
        read from each member's OWN SLOPolicy (defaulted to
        consts.SLO_TTFT_S), the SAME bound the engine judges retires
        against, so the shed forecast and the retire verdict cannot
        drift. A request past it is doomed either way: shed IT
        (typed ``slo_budget``, engine-side exact accounting) and route
        the arrival into the freed slot, which still has its whole
        budget ahead of it. None when nobody's forecast blows the
        budget — the caller falls back to FIFO reject-new
        (``fleet_full``), which is also the ``slo_aware=False`` control
        arm's only behavior."""
        if req.prefix is not None:
            # the pin is a correctness constraint: the freed slot must
            # be on a member actually holding the prefix's pages
            targets = [i for i in targets
                       if i in self._prefix_homes.get(req.prefix, ())]
        worst: tuple[int, object] | None = None
        worst_over = 0.0
        for i in targets:
            eng = self.engines[i]
            est = eng.telemetry.ttft.percentile(50)
            for q in eng.queue:
                waited = eng.telemetry.waited(id(q))
                if waited is None:
                    continue
                over = waited + est - eng.telemetry.slo.ttft_s
                if over > worst_over:
                    worst, worst_over = (i, q), over
        if worst is None:
            return None
        i, victim = worst
        eng = self.engines[i]
        eng.queue.remove(victim)
        eng.trace_event(victim, "fleet.slo_shed", member=i,
                        over_budget_s=round(worst_over, 3))
        eng._shed_request(victim)
        self.stats["slo_sheds"] += 1
        self._count(REASON_SLO_BUDGET, count)
        if not self._submit_to(i, req):
            return self._resubmit(req, count)
        self._stamp_route(i, req, REASON_SLO_BUDGET)
        return RouteDecision(i, REASON_SLO_BUDGET)

    def _route_subscriber(self, req, targets: list[int],
                          count: bool = True,
                          shed_reason: str = REASON_FLEET_FULL,
                          ) -> RouteDecision:
        """A prefix-naming request: ride a pin when one is routable;
        replicate the prefix past the depth threshold; shed only when
        nothing pinned (or pinnable) can take it."""
        name = req.prefix
        if name not in self._prefix_homes:
            raise ValueError(
                consts.ERR_PREFIX_UNKNOWN_FMT.format(name=name))
        if not self._prefix_homes[name]:
            # every pinned home died with its member: lazily re-register
            # from the remembered tokens (prefill recompute — the pages
            # are gone) before the subscriber can route
            if self._rehome_prefix(name) is None:
                return self._shed(req, count, shed_reason)
        pinned = [i for i in targets if i in self._prefix_homes[name]]
        pinned = [i for i in pinned if self._has_room(i)]
        best = self._coldest(pinned) if pinned else None
        if best is not None and self.affinity \
                and len(self.engines[best].queue) < self.replicate_depth \
                and not self._pressured(best):
            if not self._submit_to(best, req):
                return self._resubmit(req, count)
            self._stamp_route(best, req, REASON_AFFINITY_HIT)
            self.stats["affinity_hits"] += 1 if count else 0
            self._count(REASON_AFFINITY_HIT, count)
            return RouteDecision(best, REASON_AFFINITY_HIT)
        if self.affinity:
            # every pinned engine is deep or hot: replicate to the
            # coldest unpinned target and route there — the submit pays
            # the replication so its successors get affinity hits
            unpinned = [i for i in targets
                        if i not in self._prefix_homes[name]]
            cold = self._coldest(unpinned) if unpinned else None
            if cold is not None and self._replicate_prefix(name, cold):
                if not self._submit_to(cold, req):
                    return self._resubmit(req, count)
                self._stamp_route(cold, req, REASON_AFFINITY_MISS)
                self._count(REASON_AFFINITY_MISS, count)
                return RouteDecision(cold, REASON_AFFINITY_MISS)
        if best is None:
            return self._shed(req, count, shed_reason)
        # affinity off (or replication impossible): the pin is a
        # correctness constraint, not a preference — route to the best
        # pinned engine whatever its depth
        if not self._submit_to(best, req):
            return self._resubmit(req, count)
        self._stamp_route(best, req,
                          REASON_AFFINITY_HIT if self.affinity
                          else REASON_DEPTH_SPILL)
        if self.affinity:
            self.stats["affinity_hits"] += 1 if count else 0
            self._count(REASON_AFFINITY_HIT, count)
            return RouteDecision(best, REASON_AFFINITY_HIT)
        self._count(REASON_DEPTH_SPILL, count)
        return RouteDecision(best, REASON_DEPTH_SPILL)

    # ---- the serving loop ---------------------------------------------

    def _pump_handoffs(self) -> None:
        """Disaggregation pump: move every finished prefill admission
        into a decode engine's pool and lane (extract -> install ->
        detach, in that order — a failed install leaves the request
        serving where it is). Requests stranded on prefill lanes past
        their deadline retire there with the exact overload status."""
        decode_ids = self._decode_targets()
        now = time.monotonic()
        for i in range(self.n_prefill):
            src = self.engines[i]
            for lane, req in list(src.running.items()):
                if req._deadline is not None and now >= req._deadline:
                    src._retire(
                        lane, status=overload.STATUS_DEADLINE_EXCEEDED)
                    continue
                # no routable decode member right now: keep sweeping —
                # the deadline check above must still visit every
                # stranded lane. Feasibility-probe BEFORE extracting:
                # the device-side KV gather is real HBM traffic, and a
                # saturated decode side must not buy a thrown-away
                # record per stranded lane per step.
                rows = src._lengths[lane]
                left = max(0, req.max_new - len(req.output))
                ready = [d for d in decode_ids
                         if self.engines[d].can_install(rows, left)]
                dst_id = self._coldest(ready) if ready else None
                if dst_id is None:
                    continue
                record = src.extract_request(lane)
                if self.engines[dst_id].install_request(record) is None:
                    continue        # raced below the probe: retry later
                src.detach_request(lane)
                src.trace_event(req, "fleet.handoff", src=i, dst=dst_id)
                self.stats["handoffs"] += 1

    def step(self) -> None:
        """One fleet iteration: a throttled health pass, then prefill
        engines admit (and their finished admissions hand off), then
        decode engines (or everyone, undisaggregated) run one engine
        step. Members with an OPEN breaker are skipped — their work was
        already evacuated — and a non-OOM exception escaping a member's
        step counts toward its dispatch-fault breaker instead of
        killing the fleet loop."""
        now = time.monotonic()
        if now - self._last_probe >= self.probe_interval_s:
            self._last_probe = now
            self.probe()
        for i in range(self.n_prefill):
            if self._health[i].state == consts.FLEET_MEMBER_OPEN:
                continue
            try:
                self.engines[i].prefill_step()
                self._health[i].consecutive_faults = 0
                self._health[i].consecutive_wire_faults = 0
            except Exception as exc:
                self._member_fault(i, exc)
        if self.disaggregate:
            self._pump_handoffs()
        busy = False
        for i in range(self.n_prefill, len(self.engines)):
            if self._health[i].state == consts.FLEET_MEMBER_OPEN:
                continue
            e = self.engines[i]
            if e.running or e.queue:
                busy = True
                try:
                    e.step()
                    self._health[i].consecutive_faults = 0
                    self._health[i].consecutive_wire_faults = 0
                except Exception as exc:
                    self._member_fault(i, exc)
        if not busy and self._backlog():
            # nothing decodable this step (handoffs deferred, every
            # queue waiting on admission): yield like the engines do so
            # run()'s bound spans real time, not a busy spin
            time.sleep(0.01)

    def _backlog(self) -> bool:
        """Live work still owed an answer: queued or running requests
        on any member whose breaker is not OPEN (an open member was
        evacuated — anything somehow left behind is unreachable and
        must not spin run() forever)."""
        return any(self.engines[i].queue or self.engines[i].running
                   for i in range(len(self.engines))
                   if self._health[i].state != consts.FLEET_MEMBER_OPEN)

    def run(self, max_iters: int = 10_000) -> None:
        """Drain every member's queue + running set. Raises the same
        typed DrainTimeout as a single engine, carrying every
        undrained request across the fleet."""
        for _ in range(max_iters):
            if not self._backlog():
                return
            self.step()
        undrained = [r for e in self.engines
                     for r in list(e.running.values()) + list(e.queue)]
        raise overload.DrainTimeout(
            f"fleet did not drain after {max_iters} iterations "
            f"({sum(len(e.running) for e in self.engines)} in flight, "
            f"{sum(len(e.queue) for e in self.engines)} queued)",
            undrained=undrained,
            queue_depth=sum(len(e.queue) for e in self.engines))

    # ---- drain / rebalance --------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def request_drain(self) -> None:
        """Drain the WHOLE fleet (SIGTERM / migration directive): every
        member stops admitting, queued work sheds with exact accounting,
        in-flight work finishes — the fleet flavor of the single-engine
        contract the rebalancer waits on."""
        self._draining = True
        for e in self.engines:
            e.request_drain()

    def cancel_drain(self) -> None:
        self._draining = False
        for e in self.engines:
            e.cancel_drain()

    def drain(self, max_iters: int = 10_000) -> dict:
        self.request_drain()
        self.run(max_iters)
        return self.fleet_stats()

    def drain_engine(self, i: int) -> int:
        """Drain ONE member (chaos / rebalance): its QUEUED requests
        re-route through the normal policy (no terminal status — they
        are owed answers elsewhere), in-flight ones finish or
        quarantine where they run, and the member stops admitting.
        Returns how many requests re-routed."""
        eng = self.engines[i]
        eng.request_drain()
        moved = 0
        for req in eng.take_queue():
            self._route(req, count=False)
            self.stats["rerouted"] += 1
            moved += 1
        return moved

    def scale_in(self, i: int) -> int:
        """Elastic scale-in, reusing :meth:`drain_engine`'s live
        re-route: the member stops admitting, its queued requests move
        through the normal policy, in-flight requests finish where they
        run via step(), and the member is permanently RETIRED from
        routing (``healthz()["members"][i]["retired"]``). Returns how
        many requests re-routed."""
        moved = self.drain_engine(i)
        self._health[i].retired = True
        self.stats["scale_ins"] += 1
        metrics.FLEET_FAILOVER_OUTCOMES.labels(
            outcome=consts.FLEET_SCALED_IN).inc()
        return moved

    # ---- fault tolerance ----------------------------------------------

    def _publish_state(self, i: int) -> None:
        """One-hot the member-state gauge family: exactly one of
        closed/open/half_open reads 1 per member, so a dashboard max()
        over states never shows a member in two states mid-scrape."""
        state = self._health[i].state
        for s in consts.FLEET_MEMBER_STATES:
            metrics.FLEET_MEMBER_STATE.labels(
                member=str(i), state=s).set(1.0 if s == state else 0.0)

    def _set_state(self, i: int, state: str) -> None:
        h = self._health[i]
        if h.state == state:
            return
        h.state = state
        self._publish_state(i)
        metrics.FLEET_BREAKER_TRANSITIONS.labels(
            member=str(i), to=state).inc()

    def _probe_healthz(self, i: int) -> dict | None:
        """One healthz probe under a wall timeout. The engine's own
        SyncWatchdog can't serve here: its call() blocks until the
        wrapped sync RETURNS even after tripping, and a hung member's
        healthz may never return — so the probe runs on a daemon thread
        and the router waits at most ``probe_timeout_s`` (an abandoned
        probe thread parks on the dead member's lock and costs only
        memory). None = the member failed to answer in time."""
        box: _queue.Queue = _queue.Queue(maxsize=1)
        eng = self.engines[i]

        def _ask() -> None:
            # ship the exception itself: a REMOTE member's healthz can
            # RAISE (cut wire) rather than hang, and the breaker must
            # classify that as a wire fault, not a probe timeout
            try:
                box.put(eng.healthz())
            except Exception as exc:
                box.put(exc)

        t = threading.Thread(target=_ask,
                             name=f"fleet-probe-{i}", daemon=True)
        t.start()
        try:
            return box.get(timeout=self.probe_timeout_s)
        except _queue.Empty:
            return None

    def probe(self) -> list[str]:
        """One typed health pass over every member, driving the
        breakers (consts.FLEET_MEMBER_STATES):

        - closed/half_open members get a healthz probe under the wall
          timeout; a hang opens the breaker (``probe_timeout``);
        - sync-watchdog trips and OOM-recovery counters are diffed
          against the last pass — a delta past the consts-pinned
          threshold opens the breaker (``watchdog_trips`` /
          ``oom_storm``);
        - an OPEN non-fatal member whose cooldown elapsed moves to
          half_open; ``half_open_probes`` consecutive clean passes
          close it again (fatal members stay open until respawned).

        Returns the member states after the pass. step() calls this
        every ``probe_interval_s``; tests call it directly."""
        now = time.monotonic()
        for i, eng in enumerate(self.engines):
            h = self._health[i]
            if h.retired:
                continue
            if h.state == consts.FLEET_MEMBER_OPEN:
                if h.fatal \
                        or now - h.opened_at < self.breaker_cooldown_s:
                    continue
                self._set_state(i, consts.FLEET_MEMBER_HALF_OPEN)
                h.half_open_ok = 0
            doc = self._probe_healthz(i)
            if doc is None:
                self._open_member(i, FAILURE_PROBE_TIMEOUT)
                continue
            if isinstance(doc, Exception):
                if isinstance(doc, TransportError):
                    self._wire_fault(i, doc)
                else:
                    # a probe that raised is as gone as one that hung
                    self._open_member(i, FAILURE_PROBE_TIMEOUT)
                continue
            trips = eng.watchdog_trips
            ooms = eng.stats.get("oom_recoveries", 0)
            if trips - h.watchdog_base >= self.breaker_watchdog_trips:
                h.watchdog_base = trips
                self._open_member(i, FAILURE_WATCHDOG)
                continue
            if ooms - h.oom_base >= self.breaker_oom_storm:
                h.oom_base = ooms
                self._open_member(i, FAILURE_OOM_STORM)
                continue
            h.watchdog_base, h.oom_base = trips, ooms
            h.consecutive_wire_faults = 0
            if h.state == consts.FLEET_MEMBER_HALF_OPEN \
                    and doc.get("ok", False):
                h.half_open_ok += 1
                if h.half_open_ok >= self.half_open_probes:
                    self._set_state(i, consts.FLEET_MEMBER_CLOSED)
                    h.reason = None
                    h.consecutive_faults = 0
                    self.stats["breaker_recoveries"] += 1
        self._publish_remote_gauge()
        return [h.state for h in self._health]

    def _member_fault(self, i: int, exc: Exception) -> None:
        """One exception escaped member ``i``'s step (the engine's own
        OOM recovery already swallowed survivable RESOURCE_EXHAUSTED —
        anything reaching here is a dispatch fault). Consecutive faults
        past the threshold trip the breaker FATALLY: a member whose
        step raises repeatedly is gone, not congested. Wire faults are
        the exception: a remote member whose SOCKET died may itself be
        healthy, so they breaker NON-fatally under their own threshold
        and reconnect through half-open probes."""
        if isinstance(exc, TransportError):
            self._wire_fault(i, exc)
            return
        h = self._health[i]
        h.consecutive_faults += 1
        self.stats["dispatch_faults"] += 1
        if h.consecutive_faults >= self.breaker_dispatch_faults:
            self._open_member(i, FAILURE_DISPATCH, fatal=True)

    def _wire_fault(self, i: int, exc: TransportError) -> None:
        """One typed wire fault against member ``i`` AFTER the client's
        own RetryPolicy gave up — counted by kind for the metric family,
        and toward the NON-fatal transport breaker (an open transport
        member evacuates like any other, then reconnects through
        cooldown + half-open probes when the wire heals)."""
        h = self._health[i]
        h.consecutive_wire_faults += 1
        self.stats["wire_faults"] += 1
        metrics.FLEET_WIRE_FAULTS.labels(
            member=str(i),
            kind=getattr(exc, "kind", consts.WIRE_FAULT_CUT)).inc()
        if h.consecutive_wire_faults >= self.breaker_wire_faults \
                and h.state != consts.FLEET_MEMBER_OPEN:
            self._open_member(i, FAILURE_TRANSPORT)

    def open_member(self, i: int, reason: str = FAILURE_MANUAL,
                    fatal: bool = False) -> None:
        """Trip member ``i``'s breaker NOW (operator / chaos hook):
        evacuation, salvage, and — when fatal and a factory exists —
        respawn follow exactly the path automatic detection takes."""
        self._open_member(i, reason, fatal=fatal)

    def _open_member(self, i: int, reason: str,
                     fatal: bool = False) -> None:
        h = self._health[i]
        h.fatal = h.fatal or fatal
        h.reason = reason
        h.opened_at = time.monotonic()
        h.half_open_ok = 0
        if h.state != consts.FLEET_MEMBER_OPEN:
            self.stats["breaker_opens"] += 1
            self._set_state(i, consts.FLEET_MEMBER_OPEN)
        self._evacuate(i)
        if h.fatal and self._factory is not None:
            self.respawn_member(i)

    def _evacuate(self, i: int) -> None:
        """Transactional member evacuation, in dependency order:

        1. the queue is TAKEN (hedging waits — see below);
        2. in-flight requests salvage by page migration
           (:meth:`migrate_running`) or shed typed;
        3. prefix registrations drop this member as a home (pins
           released so the pool reads clean); any that lost their LAST
           pin re-register from the remembered tokens;
        4. the taken queue re-admits under the hedge budget — AFTER the
           heal, so a hedged subscriber routes against live homes
           instead of replicating out of the dead pool.

        After this the member owns no queued, running, or pinned state
        the fleet still answers for."""
        eng = self.engines[i]
        taken = eng.take_queue()
        self.migrate_running(i)
        for name, homes in self._prefix_homes.items():
            if i not in homes:
                continue
            homes.discard(i)
            try:
                # release the pins so the member's pool reads clean
                # (host-side bookkeeping — safe even on a dead member)
                # and a half-open recovery starts from an empty pool;
                # lanes are already empty, so nothing sheds here
                eng.drop_prefix(name)
            except Exception:
                pass
        for name in list(self._prefix_homes):
            if not self._prefix_homes[name]:
                self._rehome_prefix(name)
        for req in taken:
            self._hedge(req)

    def _hedge(self, req) -> RouteDecision:
        """Hedged re-admission for a request that lost its member
        BEFORE producing a token: replay the prefill elsewhere, at most
        ``hedge_budget`` times across its lifetime (a request must not
        ping-pong through a dying fleet forever). Over budget it sheds
        with the typed ``member_failed`` reason. The caller already
        released the loser's lane/pages (cancel_request), so pages are
        never double-billed."""
        key = id(req)
        n = self._hedge_counts.get(key, 0) + 1
        if n > self.hedge_budget:
            return self._shed(req, count=False,
                              reason=REASON_MEMBER_FAILED)
        self._hedge_counts[key] = n
        decision = self._route(req, count=False,
                               shed_reason=REASON_MEMBER_FAILED)
        if decision.engine is not None:
            self.engines[decision.engine].trace_event(
                req, "fleet.hedge", attempt=n, dst=decision.engine)
            self.stats["hedged"] += 1
            metrics.FLEET_FAILOVER_OUTCOMES.labels(
                outcome=consts.FLEET_HEDGED).inc()
        return decision

    def migrate_running(self, i: int) -> int:
        """Salvage every in-flight request off member ``i`` via the
        transactional page-handoff primitives: extract (read-only) ->
        install on the coldest healthy member that can take the rows ->
        detach the source lane only after the install COMMITTED, so a
        failed install leaves the request either still owned by the
        source (non-fatal opens) or cleanly shed — never half-moved.
        Both KV codecs, PRNG continuity, and the spec-mirror ride the
        record; decode resumes byte-exact on the destination. Requests
        without a sampled token yet re-enter through the hedge instead
        (install_request cannot resume them). Returns how many
        migrated."""
        eng = self.engines[i]
        moved = 0
        for lane, req in list(eng.running.items()):
            if not req.output:
                # admitted, no sampled token: release pages and replay
                eng.cancel_request(lane)
                self._hedge(req)
                continue
            rows = eng._lengths.get(lane, 0)
            record = None
            try:
                record = eng.extract_request(lane)
            except Exception:
                record = None   # source too broken to even read
            installed = None
            if record is not None:
                for dst in self._salvage_candidates(
                        i, rows, max(0, req.max_new - len(req.output))):
                    try:
                        installed = \
                            self.engines[dst].install_request(record)
                    except Exception:
                        # a faulting DESTINATION must not kill the
                        # sweep: its own breaker will catch it; try
                        # the next candidate
                        installed = None
                    if installed is not None:
                        break
            if installed is None:
                eng.cancel_request(lane)
                self._shed(req, count=False,
                           reason=REASON_MEMBER_FAILED)
                continue
            eng.detach_request(lane)
            eng.trace_event(req, "fleet.migrate", src=i)
            moved += 1
            self.stats["migrations"] += 1
            self.stats["handoffs"] += 1
            if self._is_remote(i) or self._is_remote(dst):
                # the record crossed (or left) a process boundary — the
                # evacuation rode the wire codec, not a pointer swap
                self.stats["remote_migrations"] += 1
            metrics.FLEET_FAILOVER_OUTCOMES.labels(
                outcome=consts.FLEET_MIGRATED).inc()
        return moved

    def _is_remote(self, i: int) -> bool:
        """A member is remote when it exposes the wire accounting
        surface (RemoteMember.wire_stats) — duck-typed so the router
        never imports the transport stack's client."""
        return getattr(self.engines[i], "wire_stats", None) is not None

    def _salvage_candidates(self, src: int, rows: int,
                            left: int) -> list[int]:
        """Members able to take a salvaged request (``rows`` held,
        ``left`` tokens still to decode) right now, coldest first
        (closed breakers before half-open, unpressured before pressured,
        then depth)."""
        ids = [d for d in self._decode_targets()
               if d != src and self.engines[d].can_install(rows, left)]
        ids.sort(key=lambda d: (
            self._health[d].state != consts.FLEET_MEMBER_CLOSED,
            self._pressured(d), self._depth(d), d))
        return ids

    def respawn_member(self, i: int):
        """Elastic self-healing: replace member ``i`` with a fresh
        engine from the factory (``factory(i)`` -> engine), validated
        against the fleet's pool layout and shape contract, wired into
        slot ``i`` with a clean breaker. Prefix re-registration already
        happened at evacuation (or heals lazily on the next
        subscriber). Returns the replacement engine."""
        h = self._health[i]
        if self._factory is None:
            raise ValueError(consts.ERR_FLEET_NO_FACTORY_FMT.format(
                member=i, reason=h.reason))
        eng = self._factory(i)
        if eng.pool_layout != self._layout:
            raise ValueError(consts.ERR_HANDOFF_POOL_FMT.format(
                src=self._layout, dst=eng.pool_layout))
        if (eng.max_seq, eng.buckets) != self._shape:
            raise ValueError(consts.ERR_FLEET_SEQ_MISMATCH_FMT.format(
                got=sorted({self._shape,
                            (eng.max_seq, eng.buckets)})))
        self.engines[i] = eng
        eng.telemetry.set_fleet_engine_id(i)
        if self._publishing:
            # the factory-built engine's constructor just grabbed the
            # process provider slot (last-engine-wins) — take it back,
            # or every usage POST after a respawn describes the lone
            # replacement instead of the fleet
            self.publish()
        self._health[i] = _MemberHealth()
        self._publish_state(i)
        self.stats["respawns"] += 1
        metrics.FLEET_FAILOVER_OUTCOMES.labels(
            outcome=consts.FLEET_RESPAWNED).inc()
        if self._draining:
            eng.request_drain()
        return eng

    def member_states(self) -> list[str]:
        """The per-member breaker states, in member order."""
        return [h.state for h in self._health]

    def _publish_remote_gauge(self) -> None:
        """One-hot-by-state count of remote members: connected =
        breaker not OPEN (the wire answered its last probe),
        disconnected = OPEN. Zero/zero for all-local fleets, so the
        series reads as the cross-process footprint."""
        remote = [i for i in range(len(self.engines))
                  if self._is_remote(i)]
        down = sum(1 for i in remote
                   if self._health[i].state == consts.FLEET_MEMBER_OPEN)
        metrics.FLEET_REMOTE_MEMBERS.labels(
            state=consts.REMOTE_MEMBER_CONNECTED).set(
                float(len(remote) - down))
        metrics.FLEET_REMOTE_MEMBERS.labels(
            state=consts.REMOTE_MEMBER_DISCONNECTED).set(float(down))

    # ---- health / accounting / telemetry ------------------------------

    def healthz(self) -> dict:
        # an OPEN member's healthz may hang or raise (that can be WHY
        # it opened) — report its breaker verdict instead of touching it
        docs = [{"ok": False, "open": True}
                if self._health[i].state == consts.FLEET_MEMBER_OPEN
                else e.healthz()
                for i, e in enumerate(self.engines)]
        members = [{"state": h.state, "reason": h.reason,
                    "fatal": h.fatal, "retired": h.retired}
                   for h in self._health]
        open_members = sum(
            1 for h in self._health
            if not h.retired and h.state == consts.FLEET_MEMBER_OPEN)
        return {"ok": all(d["ok"] for d in docs)
                and open_members == 0,
                "draining": self._draining,
                "engines": docs,
                "members": members}

    def fleet_stats(self) -> dict:
        """Summed member stats + the router's own counters — the
        accounting block ``infer serve --fleet`` prints per engine and
        in total."""
        out: dict = {}
        for e in self.engines:
            for k, v in e.stats.items():
                if isinstance(v, dict):
                    slot = out.setdefault(k, {})
                    for kk, n in v.items():
                        slot[kk] = slot.get(kk, 0) + n
                else:
                    out[k] = out.get(k, 0) + v
        out["router"] = {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in self.stats.items()}
        return out

    def reset_stats(self) -> None:
        """Zero every member's stats + telemetry and the router's own
        counters (benches call this after the compile-warmup drain)."""
        for e in self.engines:
            e.reset_stats()
        self.stats = {"submitted": 0, "shed": 0, "handoffs": 0,
                      "replications": 0, "affinity_hits": 0,
                      "rerouted": 0, "migrations": 0, "hedged": 0,
                      "breaker_opens": 0, "breaker_recoveries": 0,
                      "dispatch_faults": 0, "respawns": 0,
                      "scale_ins": 0, "slo_sheds": 0,
                      "wire_faults": 0, "remote_migrations": 0,
                      "reasons": {}}

    def snapshot(self) -> dict:
        """The fleet's merged telemetry snapshot (one payload document:
        counters summed, tails over the union of member sample pools)
        plus the TELEMETRY_FLEET_* keys."""
        snap = fleet_snapshot(
            [e.telemetry for e in self.engines],
            extra={
                consts.TELEMETRY_FLEET_HANDOFFS: self.stats["handoffs"],
                consts.TELEMETRY_FLEET_AFFINITY_HITS:
                    self.stats["affinity_hits"],
                consts.TELEMETRY_FLEET_MEMBERS_OPEN: sum(
                    1 for h in self._health
                    if not h.retired
                    and h.state == consts.FLEET_MEMBER_OPEN),
                consts.TELEMETRY_FLEET_MIGRATIONS:
                    self.stats["migrations"],
                consts.TELEMETRY_FLEET_HEDGES: self.stats["hedged"],
                consts.TELEMETRY_FLEET_SHED_MEMBER_FAILED:
                    self.stats["reasons"].get(REASON_MEMBER_FAILED, 0),
                consts.TELEMETRY_FLEET_RESPAWNS:
                    self.stats["respawns"],
                consts.TELEMETRY_FLEET_SHED_SLO:
                    self.stats["slo_sheds"],
                consts.TELEMETRY_FLEET_REMOTE_MEMBERS: sum(
                    1 for i in range(len(self.engines))
                    if self._is_remote(i)),
                # wire counters come from the CLIENTS (they see every
                # fault, including ones the RetryPolicy absorbed), the
                # migration counter from the router (it owns the moves)
                consts.TELEMETRY_FLEET_WIRE_FAULTS: sum(
                    e.wire_stats["wire_faults"] for e in self.engines
                    if getattr(e, "wire_stats", None) is not None),
                consts.TELEMETRY_FLEET_WIRE_RECONNECTS: sum(
                    e.wire_stats["reconnects"] for e in self.engines
                    if getattr(e, "wire_stats", None) is not None),
                consts.TELEMETRY_FLEET_REMOTE_MIGRATIONS:
                    self.stats["remote_migrations"],
            })
        # router-level sheds (fleet_full / member_failed / draining)
        # never reach a member's retire-time judgement: each is one
        # offered request that died before service, charged to the
        # queued phase HERE so the merged document keeps the exact
        # accounting invariant (good + violations == offered)
        snap[consts.TELEMETRY_SLO_VIOLATIONS_QUEUED] = int(
            snap.get(consts.TELEMETRY_SLO_VIOLATIONS_QUEUED, 0)
            + self.stats["shed"])
        return snap

    def publish(self) -> "FleetRouter":
        """Install the merged fleet snapshot as the process telemetry
        provider — every member engine's constructor grabbed the slot
        for itself (last-engine-wins), so the router must take it back
        to make the usage POST describe the fleet, not member N-1.
        Sticky: a respawn's factory-built engine grabs the slot again,
        and ``respawn_member`` re-takes it for any router that ever
        published."""
        self._publishing = True
        set_snapshot_provider(self.snapshot)
        return self
