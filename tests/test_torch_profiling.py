"""The port's env-gated profiler (``workloads/profiling.py``) against the
reference's ``tpushare/workloads/profiling.py``: the same gate and the
same no-op, and a trace file written on the CPU through
``torch.profiler``; the training payload runs its loop under it."""

from __future__ import annotations

import json
import os

import pytest

torch = pytest.importorskip("torch")

from tpushare.workloads import profiling as jprofiling  # noqa: E402
from tpushare_torch import consts  # noqa: E402
from tpushare_torch.workloads import profiling, train_payload  # noqa: E402


def test_gate_is_the_references(monkeypatch):
    assert profiling.ENV_TRACE_DIR == jprofiling.ENV_TRACE_DIR == \
        consts.ENV_TRACE_DIR
    monkeypatch.delenv(consts.ENV_TRACE_DIR, raising=False)
    assert profiling.env_trace_dir() is None is jprofiling.env_trace_dir()
    monkeypatch.setenv(consts.ENV_TRACE_DIR, "   ")
    assert profiling.env_trace_dir() is None is jprofiling.env_trace_dir()
    monkeypatch.setenv(consts.ENV_TRACE_DIR, " /tmp/tb ")
    assert profiling.env_trace_dir() == jprofiling.env_trace_dir() == \
        "/tmp/tb"


def test_no_directory_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv(consts.ENV_TRACE_DIR, raising=False)
    with profiling.trace() as d:
        torch.ones(4).sum()
    assert d is None
    with profiling.trace(None) as d:
        pass
    assert d is None


def test_env_gated_trace_writes_a_chrome_trace_on_the_cpu(monkeypatch,
                                                          tmp_path):
    out = tmp_path / "tb"
    monkeypatch.setenv(consts.ENV_TRACE_DIR, str(out))
    with profiling.trace() as d:
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    assert d == str(out)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    doc = json.loads((out / files[0]).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in (n or "") for n in names)
    # an explicit directory wins over the env
    other = tmp_path / "explicit"
    with profiling.trace(str(other), block=False):
        torch.ones(2).add_(1)
    assert len(os.listdir(other)) == 1


def test_train_payload_traces_its_loop(monkeypatch, tmp_path):
    out = tmp_path / "train-tb"
    monkeypatch.setenv(consts.ENV_TRACE_DIR, str(out))
    assert train_payload.main(["--device", "cpu", "--steps", "2",
                               "--batch", "2", "--seq", "16"]) == 0
    assert len(os.listdir(out)) == 1
