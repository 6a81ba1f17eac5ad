"""The port's own copy of the reference's ``metrics.Histogram``
(``tpushare/metrics.py:113``): the one metric type the serving
telemetry uses, kept unregistered in the payload process."""

from __future__ import annotations

import math
import threading
from bisect import bisect_right

__all__ = ["Histogram", "DEFAULT_BUCKETS"]

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
