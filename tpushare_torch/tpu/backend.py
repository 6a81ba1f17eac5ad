"""The backend protocol the device-plugin server consumes — the port's
copy of ``tpushare/tpu/backend.py``: what the daemon needs from the
hardware (enumerate chips, their topology, a stream of health events,
close). Imports neither ``torch`` nor ``jax``, so a daemon image needs
neither.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@dataclass(frozen=True)
class HealthEvent:
    """A chip transitioned health states; events carry a direction so a
    recovered chip goes back to Healthy. ``code`` is the hardware's
    error code (the XID on a GPU); application-level codes are dropped
    before they reach the plugin."""

    chip_id: str
    healthy: bool
    reason: str = ""
    code: int = 0


@runtime_checkable
class Backend(Protocol):
    """Hardware introspection surface consumed by the plugin server."""

    def devices(self) -> list:
        """Enumerate local chips."""
        ...

    def topology(self):
        """Slice topology, or None when there is none."""
        ...

    def subscribe_health(self) -> "queue.Queue[HealthEvent]":
        """Register a health-event subscriber."""
        ...

    def close(self) -> None:
        ...


class HealthBroadcaster:
    """Fan-out helper shared by backends: one producer, N subscriber
    queues."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: list[queue.Queue[HealthEvent]] = []

    def subscribe(self) -> "queue.Queue[HealthEvent]":
        q: queue.Queue[HealthEvent] = queue.Queue()
        with self._lock:
            self._subs.append(q)
        return q

    def publish(self, ev: HealthEvent) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            q.put(ev)
