"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from benchmark import harness, model, traffic
from benchmark.harness import ROOT

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|experts_per_tok|expansion)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert NAME.match(cfg["name"])
    data = model.load_config(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    m = model.dims(data)
    assert model.param_count(m) == data["parameters"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(wl):
    assert NAME.match(wl["name"]) and wl["chips"] in (1, 4)
    assert len(wl["why"]) <= 200
    cell = harness.load_cell(wl["name"])
    assert (cell["config"], cell["traffic"]) == (wl["config"], wl["traffic"])
    assert (ROOT / "benchmark" / "drivers" / f"{cell['driver']}.py").exists()
    mix = traffic.load_mix(cell["traffic"])
    gen = traffic.generator(mix)
    assert callable(getattr(gen, "make_batch", None)
                    or getattr(gen, "make_requests", None))
    assert cell["limits"]
    e2e = harness.cell_metrics(BENCH, wl["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, wl["name"], trace=True)


def test_one_pair_per_cell():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.metric_reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]
            assert m["unit"] == "%"


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
