"""The allocator's peak over set-up and window: the HBM a pod must be
granted. Read on the card only."""

from benchmark.records import on_card


def read(rec):
    if not on_card(rec) or rec.get("peak_bytes") is None:
        return None
    return rec["peak_bytes"] / 2 ** 30
