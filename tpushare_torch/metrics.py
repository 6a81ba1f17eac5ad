"""The port's own copy of the metric types its workloads use —
the reference's ``metrics.Histogram`` (``tpushare/metrics.py:113``) for
the serving telemetry, and ``LabeledCounter`` / ``LabeledGauge`` for the
five fleet series the router advances (``tpushare/metrics.py:540-563``:
member state, breaker transitions, failover outcomes, wire faults,
remote members) — under the reference's names and labels, kept
unregistered in the payload process."""

from __future__ import annotations

import math
import threading
from bisect import bisect_right

from tpushare_torch import consts

__all__ = ["Histogram", "DEFAULT_BUCKETS", "Counter", "Gauge",
           "LabeledCounter", "LabeledGauge", "FLEET_MEMBER_STATE",
           "FLEET_BREAKER_TRANSITIONS", "FLEET_FAILOVER_OUTCOMES",
           "FLEET_WIRE_FAULTS", "FLEET_REMOTE_MEMBERS"]

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5)

# coprime stride of the bounded reservoir's overwrite walk
_RESERVOIR_STRIDE = 7919


class Histogram:
    """Fixed-bucket histogram that also keeps a bounded pool of raw
    samples for exact percentiles. Once the pool is full, new samples
    overwrite slots along a fixed coprime stride (no ``random``), so
    late samples keep entering the percentile pool."""

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 max_samples: int = 100_000) -> None:
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self.samples: list[float] = []
        self._max_samples = max_samples
        self._slot = 0
        stride = _RESERVOIR_STRIDE % max_samples or 1
        while math.gcd(stride, max_samples) != 1:
            stride += 1
        self._stride = stride

    def observe(self, value: float) -> None:
        with self._lock:
            self.counts[bisect_right(self.buckets, value)] += 1
            self.sum += value
            self.total += 1
            if len(self.samples) < self._max_samples:
                self.samples.append(value)
            else:
                self.samples[self._slot] = value
                self._slot = (self._slot + self._stride) % self._max_samples

    @staticmethod
    def percentile_of(samples: list, q: float) -> float:
        """The exact-percentile index rule over a raw sample pool."""
        if not samples:
            return 0.0
        s = sorted(samples)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    def samples_snapshot(self) -> list:
        with self._lock:
            return list(self.samples)

    def percentile(self, q: float) -> float:
        return self.percentile_of(self.samples_snapshot(), q)


class Counter:
    """A monotonically increasing value."""

    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    """A value that is set."""

    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value


class _LabeledFamily:
    """One child series per label-value tuple, created on first use."""

    _child = Counter

    def __init__(self, name: str, help_: str,
                 label_names: tuple[str, ...]) -> None:
        if not label_names:
            raise ValueError(f"{name}: a labeled family needs label names")
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **kv: object):
        if set(kv) != set(self._label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self._label_names}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self._label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child(self.name,
                                                          self.help)
        return child

    def values(self) -> dict[tuple[str, ...], float]:
        """Every child's value by its label-value tuple."""
        with self._lock:
            return {k: c.value for k, c in self._children.items()}


class LabeledCounter(_LabeledFamily):
    _child = Counter


class LabeledGauge(_LabeledFamily):
    _child = Gauge


FLEET_MEMBER_STATE = LabeledGauge(
    consts.METRIC_FLEET_MEMBER_STATE,
    "One fleet member's circuit-breaker state, one-hot over "
    "closed/open/half_open", ("member", "state"))
FLEET_BREAKER_TRANSITIONS = LabeledCounter(
    consts.METRIC_FLEET_BREAKER_TRANSITIONS,
    "Fleet member circuit-breaker transitions by destination state",
    ("member", "to"))
FLEET_FAILOVER_OUTCOMES = LabeledCounter(
    consts.METRIC_FLEET_FAILOVER_OUTCOMES,
    "Fleet failover actions by typed terminal outcome", ("outcome",))
FLEET_WIRE_FAULTS = LabeledCounter(
    consts.METRIC_FLEET_WIRE_FAULTS,
    "Typed wire faults charged against a remote member after the "
    "transport's retry policy gave up", ("member", "kind"))
FLEET_REMOTE_MEMBERS = LabeledGauge(
    consts.METRIC_FLEET_REMOTE_MEMBERS,
    "Cross-process fleet members by wire state", ("state",))
