"""Retry with backoff — the port's own copy of what the fleet transport
uses from ``tpushare/k8s/retry.py``: :class:`RetryPolicy` (exponential
backoff with full jitter, an attempt budget and an overall deadline),
:class:`Backoff` (the never-giving-up form for loops),
:func:`default_retryable` and :class:`RetryAborted`."""

from __future__ import annotations

import http.client
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

log = logging.getLogger("tpushare_torch.retry")

T = TypeVar("T")

# HTTP statuses worth retrying: throttling, timeouts, server-side faults.
RETRYABLE_STATUSES = frozenset({408, 429, 500, 502, 503, 504})


class RetryAborted(Exception):
    """The stop event was set while waiting between attempts."""


def default_retryable(exc: BaseException, *,
                      retry_conflicts: bool = False) -> bool:
    """Transient-fault classification: an exception with an int
    ``status`` is judged by it; anything else is retryable iff it is a
    transport fault (``OSError`` or ``http.client.HTTPException``)."""
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        if status in RETRYABLE_STATUSES:
            return True
        return retry_conflicts and status == 409
    return isinstance(exc, (OSError, http.client.HTTPException))


def retry_after_s(exc: BaseException) -> float | None:
    """Server-requested pause attached to the exception, if any."""
    value = getattr(exc, "retry_after_s", None)
    return value if isinstance(value, (int, float)) else None


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter, bounded in attempts (calls,
    not retries) and in time (``overall_deadline_s`` from the first
    call, backoff included)."""

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    overall_deadline_s: float = 30.0
    retry_conflicts: bool = False

    def backoff_s(self, attempt: int,
                  rng: Callable[[], float] = random.random) -> float:
        """Full-jitter delay before attempt ``attempt + 1`` (0-based);
        the exponent is clamped so a long outage cannot overflow it."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2 ** min(attempt, 60)))
        return rng() * cap

    def call(self, fn: Callable[[], T], *, describe: str = "",
             stop: threading.Event | None = None,
             retryable: Callable[[BaseException], bool] | None = None,
             rng: Callable[[], float] = random.random) -> T:
        """Run ``fn`` under this policy: a non-retryable error propagates
        at once; a spent budget re-raises the last error; ``stop``
        aborts a pending wait with :class:`RetryAborted`."""
        classify = retryable if retryable is not None else (
            lambda exc: default_retryable(
                exc, retry_conflicts=self.retry_conflicts))
        deadline = time.monotonic() + self.overall_deadline_s
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                attempt += 1
                if not classify(e):
                    raise
                delay = self.backoff_s(attempt - 1, rng)
                asked = retry_after_s(e)
                if asked is not None:
                    delay = max(delay, min(asked, self.max_delay_s))
                remaining = deadline - time.monotonic()
                if attempt >= self.max_attempts or delay > remaining:
                    emit = log.debug if self.max_attempts <= 1 \
                        else log.warning
                    emit("%s: giving up after %d attempt(s): %s",
                         describe or "request", attempt, e)
                    raise
                log.warning("%s: attempt %d/%d failed (%s); retrying in "
                            "%.2fs", describe or "request", attempt,
                            self.max_attempts, e, delay)
                if stop is not None:
                    if stop.wait(delay):
                        raise RetryAborted(
                            f"{describe or 'request'} aborted by stop "
                            "during backoff") from e
                else:
                    time.sleep(delay)


class Backoff:
    """Stateful backoff for forever-loops: a jittered, exponentially
    growing delay until :meth:`reset` snaps it back to the base."""

    def __init__(self, policy: RetryPolicy,
                 rng: Callable[[], float] = random.random) -> None:
        self._policy = policy
        self._rng = rng
        self._failures = 0

    def reset(self) -> None:
        self._failures = 0

    def next_delay_s(self) -> float:
        delay = self._policy.backoff_s(self._failures, self._rng)
        self._failures += 1
        return delay
