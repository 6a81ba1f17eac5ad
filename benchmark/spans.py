"""Readings over the port's own step spans (``tpushare_torch.tracing``
``step_span``), as a traced run's record would hold them under
``program_spans``: the export of ``tracing.stop_step_spans()``, a dict
``{"spans": [span documents], "complete": bool}``, taken after the
run's last synchronise. A span document has ``name``, ``trace_id``,
``span_id``, ``parent_id``, ``start_ns``, ``end_ns`` (host clock,
``time.time_ns()``) and ``attrs``; a device-timed span on the card has
``attrs["device_ms"]``.

Every reading is None where the record holds no export (a run of a
port without step spans, or of a run that never switched them on)
or where the export is incomplete (the ring dropped spans): a partial
export would read low."""

from __future__ import annotations

import statistics

from benchmark.records import on_card


def spans(rec: dict, kind: str) -> list[dict] | None:
    """The complete export's span documents of a ``kind`` run, else
    None."""
    if rec.get("kind") != kind:
        return None
    export = rec.get("program_spans")
    if not export or not export.get("complete"):
        return None
    return export["spans"]


def named(docs: list[dict], name: str) -> list[dict]:
    return [d for d in docs if d["name"] == name]


def host_ms(doc: dict) -> float:
    return (doc["end_ns"] - doc["start_ns"]) / 1e6


def median_step_device_ms(rec: dict, name: str) -> float | None:
    """Over the train steps of the export (each ``train.step`` trace),
    the median of the summed ``device_ms`` of a step's ``name`` spans
    (a step's microbatches under ``accum_steps`` add up). On the card
    only; None where a step has no such span or one lacks its time."""
    docs = spans(rec, "train")
    if docs is None or not on_card(rec):
        return None
    steps = {d["trace_id"]: [] for d in named(docs, "train.step")}
    for d in named(docs, name):
        if d["trace_id"] in steps:
            steps[d["trace_id"]].append(d["attrs"].get("device_ms"))
    if not steps or any(not ms or None in ms for ms in steps.values()):
        return None
    return statistics.median(sum(ms) for ms in steps.values())
