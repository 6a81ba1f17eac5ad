"""Workload-plane fault injection — the port's copy of the workload
fault classes of ``tpushare/tpu/fake.py:27-120``.

A :class:`WorkloadFaultPlan` is a per-verb schedule of faults the
serving engines fire at their own phases: ``admit`` (prefill ingest),
``dispatch`` (the decode-chunk launch), ``sync`` (the harvest's blocking
device read), ``step`` (the top of every paged-engine iteration),
``healthz`` (the health document) and ``install`` (a page-handoff
scatter). An ``oom`` fault raises :class:`FakeResourceExhausted`, a
``torch.cuda.OutOfMemoryError`` — what the card raises — so the
engines' recovery paths take it exactly as a real one.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

__all__ = ["FakeResourceExhausted", "FakeMemberDeath", "WorkloadFault",
           "WorkloadFaultPlan"]


class FakeResourceExhausted(torch.cuda.OutOfMemoryError):
    """Injected out-of-memory: ``overload.is_resource_exhausted``
    classifies it as the card's own, so the recovery path runs without
    a device running out of memory."""

    def __init__(self, message: str = "CUDA out of memory: injected "
                 "out of memory while trying to allocate") -> None:
        super().__init__(message)


class FakeMemberDeath(RuntimeError):
    """Injected non-recoverable failure: not an out-of-memory, so it
    escapes the engine's ``step()`` as a wedged runtime would."""

    def __init__(self, message: str = "injected member death: the "
                 "device runtime is gone") -> None:
        super().__init__(message)


@dataclasses.dataclass
class WorkloadFault:
    """One scheduled fault: ``times`` triggers consume it (-1: every
    time); ``kind`` "oom" raises :class:`FakeResourceExhausted`,
    "fatal" :class:`FakeMemberDeath`, "hang" and "slow" sleep
    ``delay_s`` (a hang is a slow long enough to trip a watchdog);
    ``delay_s`` also runs before an oom / fatal raise."""

    times: int = 1
    kind: str = "oom"            # "oom" | "fatal" | "hang" | "slow"
    delay_s: float = 0.0
    message: str = ("CUDA out of memory: injected out of memory while "
                    "trying to allocate")


class WorkloadFaultPlan:
    """Per-verb fault schedule for a serving engine."""

    ROUTES = frozenset({"admit", "dispatch", "sync",
                        "step", "healthz", "install"})

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._faults: dict[str, list[WorkloadFault]] = {}
        self.triggered: list[tuple[str, str]] = []   # (route, kind) log

    def add(self, route: str, fault: WorkloadFault) -> None:
        if route not in self.ROUTES:
            raise ValueError(f"unknown fault route {route!r}; "
                             f"one of {sorted(self.ROUTES)}")
        with self._lock:
            self._faults.setdefault(route, []).append(fault)

    def clear(self, route: str | None = None) -> None:
        with self._lock:
            if route is None:
                self._faults.clear()
            else:
                self._faults.pop(route, None)

    def take(self, route: str) -> WorkloadFault | None:
        """Consume one use of the first live fault for ``route``."""
        with self._lock:
            pending = self._faults.get(route) or []
            while pending:
                fault = pending[0]
                if fault.times == 0:
                    pending.pop(0)
                    continue
                if fault.times > 0:
                    fault.times -= 1
                self.triggered.append((route, fault.kind))
                return fault
            return None

    def fire(self, route: str) -> None:
        """Apply the next scheduled fault for ``route``: sleep for
        slow / hang, raise for oom / fatal, nothing when none is due."""
        fault = self.take(route)
        if fault is None:
            return
        if fault.delay_s > 0:
            time.sleep(fault.delay_s)
        if fault.kind == "oom":
            raise FakeResourceExhausted(fault.message)
        if fault.kind == "fatal":
            raise FakeMemberDeath()
