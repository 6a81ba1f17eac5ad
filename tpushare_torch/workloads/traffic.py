"""Production-shaped traffic — the port's copy of
``tpushare/workloads/traffic.py``: seeded generators, a replayable JSONL
trace and a replay harness.

The SLO plane only matters under traffic that breaks latency budgets:
bursty arrivals, multi-turn chat sessions re-entering with ever-longer
histories behind a shared system prompt, long-document bursts that
monopolize prefill, agentic submit -> idle -> resubmit loops. This
module generates those shapes deterministically (one
``random.Random(seed)``, no global RNG, no clock reads during
generation) — the same (scenario, seed, duration, rate) gives the
reference's JSONL byte for byte — and replays them against a port
engine (anything with ``submit`` / ``step`` / ``drain``), reporting
goodput, the per-phase SLO-violation mix and the terminal statuses.

Generation and trace I/O import nothing of the engines; only
:func:`replay` does, and the engine the caller built brings the device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import time

__all__ = ["TrafficEvent", "generate", "save_trace", "load_trace",
           "replay", "set_slo", "SCENARIOS"]


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One offered request in a traffic trace.

    ``t_s`` is the arrival offset in VIRTUAL seconds from replay start;
    ``replay`` maps virtual to wall time with its ``time_scale``.
    ``depends_on``/``idle_s`` encode agentic and chat-turn causality:
    the event is not offered until request ``depends_on`` reached a
    terminal, plus ``idle_s`` of think time — and is NOT offered at all
    if the dependency terminated without completing (an agent whose
    last call was shed does not make the next call)."""
    t_s: float
    rid: int
    prompt_len: int
    max_new: int
    prefix: str | None = None
    depends_on: int | None = None
    idle_s: float = 0.0
    kind: str = "oneshot"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "TrafficEvent":
        doc = json.loads(line)
        return cls(**{f.name: doc[f.name]
                      for f in dataclasses.fields(cls) if f.name in doc})


def save_trace(events: list[TrafficEvent], path: str) -> str:
    """Write one event per line (JSONL) — the replayable artifact every
    bench serve section records, so any measured run can be re-offered
    bit-for-bit (``load_trace`` + ``replay``)."""
    with open(path, "w", encoding="utf-8") as fh:
        for ev in events:
            fh.write(ev.to_json() + "\n")
    return path


def load_trace(path: str) -> list[TrafficEvent]:
    with open(path, encoding="utf-8") as fh:
        return [TrafficEvent.from_json(line)
                for line in fh if line.strip()]


# ---------------------------------------------------------------------------
# generators — every scenario draws from ONE rng so a seed pins the
# whole trace; rid assignment is dense per trace
# ---------------------------------------------------------------------------


def _poisson_times(rng: random.Random, rate_rps: float, duration_s: float,
                   diurnal: float = 0.0, burst_factor: float = 1.0,
                   burst_frac: float = 0.0) -> list[float]:
    """Arrival instants of a (possibly nonhomogeneous) Poisson process
    by thinning: lam(t) = rate * (1 + diurnal*sin(2pi t/duration)) and a
    ``burst_factor`` multiplier inside the ``burst_frac`` head of each
    duration quarter — the compressed 'diurnal day' + bursty-on-top
    shape of production chat traffic."""
    lam_max = rate_rps * (1.0 + abs(diurnal)) * max(1.0, burst_factor)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(lam_max)
        if t >= duration_s:
            return out
        lam = rate_rps * (1.0 + diurnal * math.sin(
            2.0 * math.pi * t / duration_s))
        if burst_factor > 1.0 and (t / duration_s * 4.0) % 1.0 < burst_frac:
            lam *= burst_factor
        if rng.random() < lam / lam_max:
            out.append(t)


def _steady(rng: random.Random, rid0: int, duration_s: float,
            rate_rps: float) -> list[TrafficEvent]:
    return [TrafficEvent(t_s=round(t, 4), rid=rid0 + i,
                         prompt_len=rng.randint(8, 48),
                         max_new=rng.randint(8, 32), kind="steady")
            for i, t in enumerate(_poisson_times(rng, rate_rps, duration_s))]


def _bursty(rng: random.Random, rid0: int, duration_s: float,
            rate_rps: float) -> list[TrafficEvent]:
    times = _poisson_times(rng, rate_rps, duration_s, diurnal=0.6,
                           burst_factor=6.0, burst_frac=0.15)
    return [TrafficEvent(t_s=round(t, 4), rid=rid0 + i,
                         prompt_len=rng.randint(8, 64),
                         max_new=rng.randint(4, 24), kind="bursty")
            for i, t in enumerate(times)]


def _chat(rng: random.Random, rid0: int, duration_s: float,
          rate_rps: float) -> list[TrafficEvent]:
    """Multi-turn sessions behind a shared system-prompt prefix: each
    turn depends on the previous turn's completion plus think time, and
    its prompt GROWS by the accumulated history — the re-entrant load
    shared-prefix caching exists for."""
    n_sessions = max(1, int(rate_rps * duration_s / 3))
    out, rid = [], rid0
    for s in range(n_sessions):
        start = rng.uniform(0.0, duration_s * 0.5)
        prev, hist = None, rng.randint(8, 24)
        for turn in range(rng.randint(2, 4)):
            out.append(TrafficEvent(
                t_s=round(start, 4), rid=rid, prompt_len=hist,
                max_new=rng.randint(8, 24), prefix=f"sys{s % 2}",
                depends_on=prev,
                idle_s=round(rng.uniform(0.2, 1.5), 3) if turn else 0.0,
                kind="chat"))
            hist += rng.randint(12, 40)   # user turn + model answer
            prev, rid = rid, rid + 1
    return out


def _longdoc(rng: random.Random, rid0: int, duration_s: float,
             rate_rps: float) -> list[TrafficEvent]:
    """Sparse, prefill-heavy: big documents, short answers — the burst
    that monopolizes admission and starves queued interactive work."""
    times = _poisson_times(rng, max(0.2, rate_rps / 4), duration_s)
    return [TrafficEvent(t_s=round(t, 4), rid=rid0 + i,
                         prompt_len=rng.randint(96, 192),
                         max_new=rng.randint(4, 12), kind="longdoc")
            for i, t in enumerate(times)]


def _agentic(rng: random.Random, rid0: int, duration_s: float,
             rate_rps: float) -> list[TrafficEvent]:
    """Tool loops: submit -> idle (the 'tool call runs') -> resubmit
    with the transcript grown, several hops deep."""
    n_agents = max(1, int(rate_rps * duration_s / 4))
    out, rid = [], rid0
    for _a in range(n_agents):
        start = rng.uniform(0.0, duration_s * 0.4)
        prev, plen = None, rng.randint(16, 48)
        for hop in range(rng.randint(2, 5)):
            out.append(TrafficEvent(
                t_s=round(start, 4), rid=rid, prompt_len=plen,
                max_new=rng.randint(8, 20), depends_on=prev,
                idle_s=round(rng.uniform(0.1, 0.8), 3) if hop else 0.0,
                kind="agentic"))
            plen += rng.randint(8, 32)
            prev, rid = rid, rid + 1
    return out


def _adversarial(rng: random.Random, rid0: int, duration_s: float,
                 rate_rps: float) -> list[TrafficEvent]:
    """The mix that actually blows p99: bursty interactive load with
    long-doc prefill bombs and agentic re-entries landing on top."""
    out: list[TrafficEvent] = []
    for gen in (_bursty, _longdoc, _agentic, _chat):
        out.extend(gen(rng, rid0 + len(out), duration_s, rate_rps))
    return out


SCENARIOS = {"steady": _steady, "bursty": _bursty, "chat": _chat,
             "longdoc": _longdoc, "agentic": _agentic,
             "adversarial": _adversarial}


def generate(scenario: str, *, seed: int, duration_s: float = 10.0,
             rate_rps: float = 2.0) -> list[TrafficEvent]:
    """Deterministic trace for one named scenario: same (scenario, seed,
    duration, rate) -> byte-identical JSONL. Events come back sorted by
    arrival time with dense rids from 0."""
    if scenario not in SCENARIOS:
        raise ValueError(f"scenario {scenario!r} not in "
                         f"{sorted(SCENARIOS)}")
    rng = random.Random(seed)
    events = SCENARIOS[scenario](rng, 0, float(duration_s), float(rate_rps))
    events.sort(key=lambda e: (e.t_s, e.rid))
    # re-number densely in arrival order, preserving dependency edges
    remap = {e.rid: i for i, e in enumerate(events)}
    return [dataclasses.replace(
        e, rid=remap[e.rid],
        depends_on=None if e.depends_on is None else remap[e.depends_on])
        for e in events]


# ---------------------------------------------------------------------------
# replay — offer a trace to a REAL engine/router and account every
# request to a terminal
# ---------------------------------------------------------------------------


def set_slo(target, policy) -> None:
    """Point every engine under ``target`` at one SLOPolicy — the bench
    A/B tightens the bounds so a CPU-scale replay actually produces
    violations. Works on a bare engine (``.telemetry``) or a
    FleetRouter (``.engines``); the router's shed forecast reads each
    member's policy, so this is the ONE switch."""
    engines = getattr(target, "engines", None) or [target]
    for eng in engines:
        eng.telemetry.slo = policy


def _snapshot(target) -> dict:
    if hasattr(target, "engines"):
        return target.snapshot()
    return target.telemetry.snapshot()


def replay(target, events: list[TrafficEvent], *, seed: int = 0,
           time_scale: float = 1.0, vocab: int = 256,
           register_prefixes: bool = True, prefix_len: int = 16,
           max_wall_s: float = 60.0) -> dict:
    """Offer ``events`` to ``target`` on its virtual clock and run the
    engine loop until EVERY offered request reached a terminal status
    (the exact-accounting invariant the e2e suite asserts). Wall time =
    ``t_s * time_scale``, so a 60-virtual-second day replays in 0.6 wall
    seconds at ``time_scale=0.01`` — SLO judgement happens in REAL
    seconds inside the engines, which is why the bench pairs a small
    scale with a tightened :func:`set_slo` policy.

    Returns the accounting report: offered/terminal counts by status,
    dependents skipped because their dependency never completed, the
    telemetry DELTA over the replay (slo good/violations by phase —
    counters, so pre-existing engine activity subtracts out), and the
    live goodput/throughput window figures at the end of the run.
    """
    from tpushare_torch import consts
    from tpushare_torch.workloads.serving import Request

    rng = random.Random(seed)
    events = sorted(events, key=lambda e: (e.t_s, e.rid))
    # traces are engine-agnostic (a longdoc event may exceed a tiny CI
    # engine's cache): clamp each event to the smallest member's
    # max_seq so every event stays offerable, never silently dropped
    engines = getattr(target, "engines", None) or [target]
    cap = min(e.max_seq for e in engines)
    clamped = []
    for ev in events:
        room = cap - ev.max_new - (prefix_len if ev.prefix else 0)
        if ev.prompt_len > room:
            ev = dataclasses.replace(ev, prompt_len=max(1, room))
        clamped.append(ev)
    events = clamped
    if register_prefixes and hasattr(target, "register_prefix"):
        for name in sorted({e.prefix for e in events if e.prefix}):
            target.register_prefix(
                name, [rng.randrange(vocab) for _ in range(prefix_len)])
    before = _snapshot(target)
    live: dict[int, Request] = {}
    done_wall: dict[int, float] = {}     # rid -> wall time of terminal
    statuses: dict[int, str] = {}
    pending = list(events)
    skipped = 0
    start = time.monotonic()

    def _offer(ev: TrafficEvent) -> None:
        req = Request(
            prompt=[rng.randrange(vocab) for _ in range(ev.prompt_len)],
            max_new=ev.max_new, prefix=ev.prefix)
        live[ev.rid] = req
        target.submit(req)

    while pending or any(r.status is None for r in live.values()):
        now = time.monotonic() - start
        still: list[TrafficEvent] = []
        for ev in pending:
            if ev.t_s * time_scale > now:
                still.append(ev)
                continue
            if ev.depends_on is not None:
                dep = statuses.get(ev.depends_on)
                if dep is None:
                    if ev.depends_on in live or any(
                            p.rid == ev.depends_on for p in pending):
                        still.append(ev)      # dependency not terminal yet
                    else:
                        skipped += 1          # dependency itself skipped
                    continue
                if dep != "completed":
                    skipped += 1              # agent loop died with it
                    continue
                if done_wall[ev.depends_on] + ev.idle_s * time_scale > now:
                    still.append(ev)          # still thinking
                    continue
            _offer(ev)
        pending = still
        target.step()
        now = time.monotonic() - start
        for rid, req in live.items():
            if req.status is not None and rid not in statuses:
                statuses[rid] = req.status
                done_wall[rid] = now
        if time.monotonic() - start > max_wall_s:
            target.drain()
            skipped += len(pending)
            pending = []
    for rid, req in live.items():             # drain-forced terminals
        if rid not in statuses:
            statuses[rid] = req.status or "?"
    after = _snapshot(target)

    def _delta(key: str) -> int:
        return int(after.get(key, 0)) - int(before.get(key, 0))

    by_status: dict[str, int] = {}
    for st in statuses.values():
        by_status[st] = by_status.get(st, 0) + 1
    violations = {
        phase: _delta("slo_violations_%s_total" % phase)
        for phase in consts.SLO_PHASES}
    return {
        "offered": len(statuses),
        "skipped_dependents": skipped,
        "statuses": by_status,
        "tokens_out": sum(len(r.output) for r in live.values()),
        "slo_good": _delta(consts.TELEMETRY_SLO_GOOD),
        "slo_violations": violations,
        "slo_violations_total": sum(violations.values()),
        "goodput_tokens_per_s": float(
            after.get(consts.TELEMETRY_GOODPUT_TOKENS_PER_S, 0.0)),
        "tokens_per_s": float(
            after.get(consts.TELEMETRY_TOKENS_PER_S, 0.0)),
        "wall_s": round(time.monotonic() - start, 3),
    }
