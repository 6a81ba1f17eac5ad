"""Readings shared by the metric readers (``metrics/<name>.py``): each
reader takes the run's record and returns its number, or None where the
run holds nothing for it to read. Device numbers are read only from a
run on the card."""

from __future__ import annotations

from benchmark.harness import percentile
from benchmark.roofline import PEAK_FLOPS, bound_s, share_pct
from benchmark.trace import kernel_time


def on_card(rec: dict) -> bool:
    return rec.get("device") == "cuda"


def traced(rec: dict) -> dict | None:
    """The device trace of a run on the card, else None."""
    return rec.get("trace") if on_card(rec) else None


def waited_s(rec: dict, r: dict, key: str) -> float:
    """A request's wait from due until ``key``; one that never got there
    waited at least until the run stopped waiting for it."""
    v = r.get(key)
    return v if v is not None else rec["span_s"] - r["due_s"]


def request_p90_ms(rec: dict, key: str) -> float | None:
    if rec.get("kind") != "serve" or not rec["requests"]:
        return None
    return 1e3 * percentile([waited_s(rec, r, key)
                             for r in rec["requests"]], 90)


def device_idle_pct(rec: dict, kind: str) -> float | None:
    t = traced(rec)
    if rec.get("kind") != kind or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_share_pct(rec: dict, flops: float, seconds: float,
                   dtype: str = "bfloat16") -> float | None:
    if not on_card(rec) or seconds <= 0:
        return None
    return share_pct(flops / PEAK_FLOPS[dtype], seconds)


def trace_complete(rec: dict, counter: str, patterns) -> bool:
    """Did the profile see every launch the port's counter made while it
    ran? A trace that dropped launches would overstate a share."""
    t = traced(rec)
    counted = (rec.get("trace_launches") or {}).get(counter, 0)
    return t is not None and kernel_time(t, *patterns)[1] >= counted


def roofline_pct(rec: dict, parts) -> float | None:
    """``parts``: (the port's launch counter, kernel name patterns, ops
    a launch, bytes a launch). The least time every traced launch could
    take over their traced time; None where none of them ran or the
    trace missed launches."""
    t = traced(rec)
    if t is None:
        return None
    least, spent = 0.0, 0.0
    for counter, patterns, ops, n_bytes in parts:
        if not trace_complete(rec, counter, patterns):
            return None
        secs, n = kernel_time(t, *patterns)
        if n:
            least += n * bound_s(ops, n_bytes)[0]
            spent += secs
    return share_pct(least, spent)
