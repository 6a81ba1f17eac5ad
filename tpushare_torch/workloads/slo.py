"""SLO policy — the port's copy of ``tpushare/workloads/slo.py``: the
one definition of "served well" and the phase-attribution rule every
violation counter uses.

- **TTFT bound** (``ttft_s``): submit -> first token, queue wait
  included. A completed request past it is charged to whichever of the
  queued / admission / prefill phases took the most wall time.
- **Per-token decode bound** (``decode_per_token_s``): (retire - first
  token) / decode tokens, checked only when TTFT held, so each
  violating request is charged to exactly one phase.
- A request that ended without completing (shed / deadline / OOM
  quarantine) violated by definition and is charged to the furthest
  phase it reached (:func:`phase_reached`).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpushare_torch import consts

__all__ = ["SLOPolicy", "phase_reached"]


def phase_reached(admitted: bool, prefilled: bool, first_token: bool) -> str:
    """Furthest lifecycle phase a request reached."""
    if first_token:
        return consts.SLO_PHASE_DECODE
    if prefilled:
        return consts.SLO_PHASE_PREFILL
    if admitted:
        return consts.SLO_PHASE_ADMISSION
    return consts.SLO_PHASE_QUEUED


@dataclass(frozen=True)
class SLOPolicy:
    """The latency contract a completed request is judged against;
    ``attribute`` returns the one phase charged for a violation, or None
    when the request met it."""

    ttft_s: float = consts.SLO_TTFT_S
    decode_per_token_s: float = consts.SLO_DECODE_PER_TOKEN_S

    def ttft_violated(self, ttft_s: float) -> bool:
        return ttft_s > self.ttft_s

    def decode_violated(self, decode_s: float, decode_tokens: int) -> bool:
        if decode_tokens <= 0:
            return False
        return decode_s / decode_tokens > self.decode_per_token_s

    def attribute(self, queued_s: float, admission_s: float,
                  prefill_s: float, decode_s: float,
                  decode_tokens: int) -> str | None:
        """Phase charged for a completed request's violation (None: it
        met the SLO). TTFT first, charged to its dominant component;
        then the per-token decode bound."""
        ttft = queued_s + admission_s + prefill_s
        if self.ttft_violated(ttft):
            parts = ((queued_s, consts.SLO_PHASE_QUEUED),
                     (admission_s, consts.SLO_PHASE_ADMISSION),
                     (prefill_s, consts.SLO_PHASE_PREFILL))
            return max(parts, key=lambda p: p[0])[1]
        if self.decode_violated(decode_s, decode_tokens):
            return consts.SLO_PHASE_DECODE
        return None
