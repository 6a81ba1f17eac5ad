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

Step spans (:func:`step_span`) put the same :class:`Span` inside the
port's hot loops: each serving engine step and each train step is one
trace, its admission wave, per-request admissions, prefill chunks, page
installs, first-token read, decode dispatch and harvest (or its
forward-backward and optimizer update) the trace's child spans. They
are off by default, and then a hook costs one read of a module global.
:func:`start_step_spans` turns them on into a ring of their own;
:func:`stop_step_spans` turns them off and returns the export. While on,
a span also enters ``torch.profiler.record_function`` under its name,
so a profile taken meanwhile shows the engine's and the train step's
phases by name, on the clock the spans stamp; a span marked
device-timed on a CUDA device also records a pair of CUDA events on the
current stream, resolved into ``attrs["device_ms"]`` at export.
``start_step_spans(record=False)`` enters the ``record_function``s
alone, with no ring, clock read or event: what a profile needs
(``workloads/profiling.trace`` turns spans on so for its region).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["Span", "TraceRing", "Tracer", "RequestTrace", "RECORDER",
           "new_trace_id", "new_span_id", "StepSpans", "step_span",
           "start_step_spans", "stop_step_spans", "NO_SPAN"]


def new_trace_id() -> str:
    """16 hex chars — long enough to never collide within a ring."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed step. ``process`` names who produced it; ``phase`` and
    ``events`` (a device-timed step span's CUDA event pair until export)
    are not serialized."""

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
    events: tuple | None = None

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


# ---------------------------------------------------------------------------
# step spans
# ---------------------------------------------------------------------------

class StepSpans:
    """One recording of step spans: a ring of their traces (one trace a
    step), each thread's stack of open spans (a span opened inside
    another is its child; a step span opens a new trace), and the count
    of spans finished, against which the export tells whether the ring
    dropped any."""

    # spans a trace may hold: an engine step's wave admits at most its
    # lanes, a handful of spans each
    MAX_SPANS_PER_TRACE = 4096

    def __init__(self, capacity: int) -> None:
        import torch
        self._torch = torch
        self.ring = TraceRing(capacity, self.MAX_SPANS_PER_TRACE)
        self.tracer = Tracer("step", self.ring)
        self.finished = 0
        self._local = threading.local()

    def stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def export(self) -> dict[str, Any]:
        """``{"spans": [Span.to_dict(), ...], "complete": bool}``. The
        caller synchronises the device first: a device-timed span whose
        events have not completed gets no ``device_ms``, and the export
        then reads incomplete, as it does when the ring evicted a trace
        or capped a trace's spans, or a span was still open."""
        docs = []
        complete = not self.stack()
        for tid in self.ring.trace_ids():
            for sp in self.ring.trace(tid) or ():
                doc = sp.to_dict()
                if sp.events is not None:
                    start, end = sp.events
                    if start.query() and end.query():
                        doc["attrs"]["device_ms"] = start.elapsed_time(end)
                    else:
                        complete = False
                docs.append(doc)
        return {"spans": docs,
                "complete": complete and len(docs) == self.finished}


class _StepSpan:
    """The context manager :func:`step_span` returns while spans are on.
    Stamps ``time.time_ns()`` at both edges, next to the entry and the
    exit of the ``record_function`` it holds open, so a profiler's event
    for it lies inside the span, as close to its edges as the host
    allows."""

    __slots__ = ("_on", "_name", "_device", "_root", "_span", "_rf")

    def __init__(self, on: StepSpans, name: str, device, root: bool) -> None:
        self._on, self._name, self._root = on, name, root
        self._device = (device if getattr(device, "type", None) == "cuda"
                        else None)

    def __enter__(self) -> Span:
        on = self._on
        stack = on.stack()
        parent = stack[-1] if stack and not self._root else None
        sp = on.tracer.begin(
            self._name,
            parent.trace_id if parent is not None else new_trace_id(),
            parent=parent)
        rf = self._rf = on._torch.profiler.record_function(self._name)
        if self._device is not None:
            cuda = on._torch.cuda
            sp.events = (cuda.Event(enable_timing=True),
                         cuda.Event(enable_timing=True))
        stack.append(sp)
        self._span = sp
        # the edge the span keeps, taken again next to the profiler's
        sp.start_ns = time.time_ns()
        rf.__enter__()
        if sp.events is not None:
            sp.events[0].record(on._torch.cuda.current_stream(self._device))
        return sp

    def __exit__(self, typ, exc, tb) -> bool:
        on, sp = self._on, self._span
        if sp.events is not None:
            sp.events[1].record(on._torch.cuda.current_stream(self._device))
        self._rf.__exit__(typ, exc, tb)
        on.tracer.finish(sp)
        on.stack().pop()
        if exc is not None:
            sp.error = f"{type(exc).__name__}: {exc}"
        on.finished += 1
        return False


class _Names:
    """Step spans that only name a profile's regions: each span enters
    its ``record_function`` and records nothing."""

    def __init__(self) -> None:
        import torch
        self.record_function = torch.profiler.record_function


class _NamedSpan:
    """The context manager :func:`step_span` returns while spans only
    name a profile's regions: the span's ``record_function``, binding
    None as when spans are off."""

    __slots__ = ("_rf",)

    def __init__(self, rf) -> None:
        self._rf = rf

    def __enter__(self) -> None:
        self._rf.__enter__()

    def __exit__(self, typ, exc, tb) -> bool:
        self._rf.__exit__(typ, exc, tb)
        return False


# where step spans go: a recording, names for a profile only, or None
# while they are off
_STEP_SPANS: StepSpans | _Names | None = None

# what a hook enters while step spans are off (binds None)
NO_SPAN = nullcontext()


def step_span(name: str, device=None, root: bool = False):
    """A context manager over one step or phase, binding its
    :class:`Span` (to set ``attrs`` on) while step spans are on, else
    None at the cost of one global read. ``device``: time the span on
    the device too, where it is a CUDA device. ``root``: start a new
    trace (a step) whatever span is open."""
    on = _STEP_SPANS
    if on is None:
        return NO_SPAN
    if on.__class__ is _Names:
        return _NamedSpan(on.record_function(name))
    return _StepSpan(on, name, device, root)


def start_step_spans(capacity: int = 16384, record: bool = True) -> bool:
    """Turn step spans on, into a ring of ``capacity`` traces (steps);
    with ``record=False`` they only enter their ``record_function``s,
    for a profile. False, and nothing changed, when they are on
    already."""
    global _STEP_SPANS
    if _STEP_SPANS is not None:
        return False
    _STEP_SPANS = StepSpans(capacity) if record else _Names()
    return True


def stop_step_spans() -> dict[str, Any] | None:
    """Turn step spans off and return their export
    (:meth:`StepSpans.export`); None when they were off or recorded
    nothing. Synchronise the device first where spans were
    device-timed."""
    global _STEP_SPANS
    on, _STEP_SPANS = _STEP_SPANS, None
    return on.export() if isinstance(on, StepSpans) else None
