"""What every cell's run shares: finding a cell's files by name, the
per-layer and end-to-end metric readers, percentiles, the check that
the JAX package never loaded, and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the port's runs must never load (compared
# whole: ``tpushare_torch`` is the port and is not ``tpushare``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpushare")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    path = HERE / "cells" / f"{name}.json"
    with open(path) as f:
        cell = json.load(f)
    if cell.get("name") != name:
        raise ValueError(f"{path} names itself {cell.get('name')!r}")
    return cell


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    without tracing, its per-layer metrics with. A metric without a
    ``workloads`` list belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(bench: dict, cell: str, trace: bool, record: dict,
                 strict: bool = True) -> dict[str, dict]:
    """Every metric of the run that its reader found something to read
    for. With ``strict`` (a run on the card) an end-to-end metric must
    always be read; off the card the device's numbers stay unread."""
    out = {}
    for m in cell_metrics(bench, cell, trace):
        value = metric_reader(m["name"])(record)
        if value is None:
            if strict and not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile over every value (q in (0, 100]): the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)


def format_checks(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if c['ok'] else 'FAILED'})"
            for name, c in checks.items()]


def judge(numbers: dict[str, float], limits: dict[str, float]) -> dict:
    """Each number compared beside its limit; a number above its limit
    (or not a number) fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
