"""Request traces of the port's serving engines — its own copy of the
parts of ``tpushare/tracing.py`` that ``RequestTrace.finish`` needs:
:class:`Span`, the bounded :class:`TraceRing`, the :class:`Tracer` span
factory and :class:`RequestTrace`.

A span is one timed step (name, wall-clock ns bounds, attrs, parent
link); a trace is every span sharing one ``trace_id``. Wall times are
``time.time_ns()`` so spans from different processes on one host sort
causally. The reference's Prometheus feeds (traces recorded, per-phase
scheduling latency) belong to the daemon's registry and are not
carried: the ring counts what it recorded in ``recorded``.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["Span", "TraceRing", "Tracer", "RequestTrace", "RECORDER",
           "new_trace_id", "new_span_id"]


def new_trace_id() -> str:
    """16 hex chars — long enough to never collide within a ring."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed step. ``process`` names who produced it; ``phase`` is
    not serialized."""

    name: str
    trace_id: str
    span_id: str = field(default_factory=new_span_id)
    parent_id: str | None = None
    process: str = "?"
    start_ns: int = 0
    end_ns: int = 0
    attrs: dict[str, Any] = field(default_factory=dict)
    error: str | None = None
    phase: str | None = None

    @property
    def duration_ms(self) -> float:
        return max(0, self.end_ns - self.start_ns) / 1e6

    def to_dict(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "process": self.process, "start_ns": self.start_ns,
            "end_ns": self.end_ns, "attrs": dict(self.attrs),
        }
        if self.error is not None:
            doc["error"] = self.error
        return doc

    @staticmethod
    def from_dict(doc: dict[str, Any]) -> "Span":
        return Span(
            name=str(doc.get("name", "?")),
            trace_id=str(doc.get("trace_id", "")),
            span_id=str(doc.get("span_id", "")),
            parent_id=doc.get("parent_id"),
            process=str(doc.get("process", "?")),
            start_ns=int(doc.get("start_ns", 0)),
            end_ns=int(doc.get("end_ns", 0)),
            attrs=dict(doc.get("attrs") or {}),
            error=doc.get("error"),
        )


class TraceRing:
    """Bounded in-memory ring of traces, LRU by last-recorded span, with
    the spans per trace capped (oldest dropped, so a lifecycle's tail is
    always kept)."""

    def __init__(self, capacity: int = 256, max_spans_per_trace: int = 512,
                 ) -> None:
        self._capacity = capacity
        self._max_spans = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, list[Span]] = OrderedDict()
        self.recorded = 0      # traces ever opened in this ring

    def record(self, span: Span) -> None:
        if not span.trace_id:
            return
        with self._lock:
            bucket = self._traces.get(span.trace_id)
            if bucket is None:
                bucket = []
                self._traces[span.trace_id] = bucket
                self.recorded += 1
            if len(bucket) >= self._max_spans:
                bucket.pop(0)
            bucket.append(span)
            self._traces.move_to_end(span.trace_id)
            while len(self._traces) > self._capacity:
                self._traces.popitem(last=False)

    def trace(self, trace_id: str) -> list[Span] | None:
        """Spans of one trace in start-time order; None: unknown."""
        with self._lock:
            bucket = self._traces.get(trace_id)
            if bucket is None:
                return None
            spans = list(bucket)
        return sorted(spans, key=lambda s: (s.start_ns, s.end_ns))

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def to_jsonl(self) -> str:
        """One span JSON object per line, traces in insertion order."""
        with self._lock:
            buckets = [list(spans) for spans in self._traces.values()]
        lines = [json.dumps(span.to_dict(), sort_keys=True)
                 for spans in buckets
                 for span in sorted(spans,
                                    key=lambda s: (s.start_ns, s.end_ns))]
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


# the process-wide ring request traces flush into
RECORDER = TraceRing()


class Tracer:
    """Process-labeled span factory bound to a ring."""

    def __init__(self, process: str, ring: TraceRing | None = None) -> None:
        self.process = process
        self.ring = ring if ring is not None else RECORDER

    def begin(self, name: str, trace_id: str,
              parent: Span | str | None = None,
              attrs: dict[str, Any] | None = None,
              phase: str | None = None) -> Span:
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        return Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    process=self.process, start_ns=time.time_ns(),
                    attrs=dict(attrs or {}), phase=phase)

    def finish(self, span: Span) -> Span:
        span.end_ns = time.time_ns()
        self.ring.record(span)
        return span

    @contextmanager
    def span(self, name: str, trace_id: str,
             parent: Span | str | None = None,
             attrs: dict[str, Any] | None = None,
             phase: str | None = None) -> Iterator[Span]:
        sp = self.begin(name, trace_id, parent=parent, attrs=attrs,
                        phase=phase)
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self.finish(sp)

    def event(self, name: str, trace_id: str,
              parent: Span | str | None = None,
              attrs: dict[str, Any] | None = None) -> Span:
        """Zero-duration span for a point-in-time observation."""
        sp = self.begin(name, trace_id, parent=parent, attrs=attrs)
        sp.end_ns = sp.start_ns
        self.ring.record(sp)
        return sp


class RequestTrace:
    """Deferred-flush trace buffer for one serving request.

    The engines instrument every request but keep few: whether a
    request is worth keeping (head-sampled, SLO-violating, or ended
    without ``completed``) is known only at its terminal, so the
    lifecycle buffers here — marks, point events, counters, plain
    appends on the engine thread — and :meth:`finish` writes spans into
    the ring only when told to keep them.

    Phase spans come from the marks the request reached (``queued`` =
    submit->admit, ``admission`` = admit->prefill, ``prefill`` =
    prefill->first token, ``decode`` = first->terminal); the furthest
    phase extends to the terminal. Point events flush as zero-duration
    child spans, counters as root-span attrs.
    """

    _PHASES = (("submit", "queued"), ("admit", "admission"),
               ("prefill", "prefill"), ("first", "decode"))

    def __init__(self, process: str = "payload",
                 attrs: dict[str, Any] | None = None,
                 sampled: bool = False) -> None:
        self.trace_id = new_trace_id()
        self.process = process
        self.sampled = bool(sampled)
        self.attrs: dict[str, Any] = dict(attrs or {})
        self._marks: dict[str, int] = {"submit": time.time_ns()}
        self._events: list[tuple[str, int, dict[str, Any]]] = []
        self._counts: dict[str, int] = {}
        self._flushed = False

    def mark(self, name: str) -> None:
        """Stamp a lifecycle boundary (the first stamp wins)."""
        self._marks.setdefault(name, time.time_ns())

    def annotate(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs: Any) -> None:
        self._events.append((name, time.time_ns(), dict(attrs)))

    def bump(self, counter: str, n: int = 1) -> None:
        self._counts[counter] = self._counts.get(counter, 0) + n

    def finish(self, status: str, violated: str | None = None,
               keep: bool = True, ring: TraceRing | None = None,
               ) -> str | None:
        """Terminal: write the buffered lifecycle into ``ring`` when
        ``keep``, else discard. Returns the trace id when kept, None when
        dropped or already flushed (idempotent)."""
        if self._flushed:
            return None
        self._flushed = True
        if not keep:
            return None
        ring = ring if ring is not None else RECORDER
        end_ns = time.time_ns()
        root = Span(name="request", trace_id=self.trace_id,
                    process=self.process,
                    start_ns=self._marks["submit"], end_ns=end_ns,
                    attrs={**self.attrs, **self._counts,
                           "status": status,
                           **({"slo_violated": violated}
                              if violated is not None else {})})
        ring.record(root)
        stamped = [(m, phase) for m, phase in self._PHASES
                   if m in self._marks]
        for i, (m, phase) in enumerate(stamped):
            start = self._marks[m]
            end = (self._marks[stamped[i + 1][0]]
                   if i + 1 < len(stamped) else end_ns)
            ring.record(Span(
                name=phase, trace_id=self.trace_id,
                parent_id=root.span_id, process=self.process,
                start_ns=start, end_ns=max(start, end)))
        for name, ts, attrs in self._events:
            ring.record(Span(name=name, trace_id=self.trace_id,
                             parent_id=root.span_id, process=self.process,
                             start_ns=ts, end_ns=ts, attrs=attrs))
        return self.trace_id
