"""Checkpoint / resume of the training payload — the counterpart of
``tpushare/workloads/checkpoint.py``'s ``TrainCheckpointer``.

Checkpointing belongs to the workload: a training pod that the binpacker
evicts and replaces must resume from its last save. The interface is the
reference's (``save``, ``latest_step``, ``restore``, ``close``, the last
``max_to_keep`` saves kept), except that ``restore`` always loads the
newest save. The format is the port's own: one
``torch.save`` file per step, ``step_<n>.pt``, holding
``{"params", "opt", "step"}``, written to a temporary name and moved into
place with ``os.replace`` so a pod killed mid-save never leaves a torn
checkpoint behind. It does not read the reference's orbax directories.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         param_shapes)
from tpushare_torch.workloads.train import tree_map

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    """Save/restore the train state, keeping the last ``max_to_keep``."""

    def __init__(self, directory: str | os.PathLike,
                 max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: dict) -> int:
        """Write ``state`` as its step's checkpoint (synchronously), then
        drop all but the newest ``max_to_keep``."""
        step = int(state["step"])
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save({"params": state["params"], "opt": state["opt"],
                    "step": step}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)
        return step

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, cfg: TransformerConfig,
                device: str | torch.device = "cuda") -> dict:
        """Load the newest saved state onto ``device`` and check it
        against ``cfg``: every parameter and moment must have the
        config's shape and dtype."""
        dev = resolve_device(device)
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location=dev,
                           weights_only=True)
        shapes = param_shapes(cfg)
        for name in ("params", "mu", "nu"):
            tree = state["params"] if name == "params" else state["opt"][name]
            got = tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
            want = tree_map(lambda s: (tuple(s), cfg.dtype), shapes)
            if got != want:
                raise ValueError(f"checkpoint step {step}: {name} do not "
                                 f"match the config {cfg}")
        return state

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""
