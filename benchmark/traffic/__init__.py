"""Traffic mixes: ``<mix>.json`` holds a mix's parameters and names the
generator module beside it that reads them (``"generator"``). A new mix
of an existing kind is a new data file."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself "
                         f"{mix.get('name')!r}")
    return mix


def generator(mix: dict):
    """The generator module a mix names."""
    return importlib.import_module(f"benchmark.traffic.{mix['generator']}")
