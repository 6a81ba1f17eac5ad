"""Share of the traced window in which no operation ran on the card."""

from benchmark.records import device_idle_pct


def read(rec):
    return device_idle_pct(rec, "serve")
