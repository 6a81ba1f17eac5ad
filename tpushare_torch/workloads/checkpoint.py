"""Checkpoint / resume of the training payload — the counterpart of
``tpushare/workloads/checkpoint.py``'s ``TrainCheckpointer`` and
``LoraCheckpointer``.

Checkpointing belongs to the workload: a training pod that the binpacker
evicts and replaces must resume from its last save. The interface is the
reference's (``save``, ``latest_step``, ``restore``, ``close``, the last
``max_to_keep`` saves kept). A state trained over a mesh is saved as
whole tensors, gathered from its shards, and ``restore`` places a save
onto the device or mesh it is given — so a checkpoint saved on one mesh
restores onto another, as the reference's orbax target does. A state
over a mesh that spans processes (a pod group) is refused both ways:
every member would write the whole state to its own disk, as the
reference's payload refuses ``--checkpoint-dir`` under a group. The
format is the port's own: one
``torch.save`` file per step, ``step_<n>.pt``, holding
``{"params", "opt", "step"}``, written to a temporary name and moved into
place with ``os.replace`` so a pod killed mid-save never leaves a torn
checkpoint behind. It does not read the reference's orbax directories.

``LoraCheckpointer`` keeps the adapter train state
(``lora.init_lora_state``: ``{"adapters", "opt", "step"}``) in the same
format — never the frozen base, which is the published weights or
derived from them (``quant.quantize_params`` for QLoRA).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         param_shapes)
from tpushare_torch.workloads.parallel.mesh import Mesh
from tpushare_torch.workloads.train import (gather_state, place_state,
                                            sharded_leaves, tree_map)

_NAME = re.compile(r"^step_(\d+)\.pt$")


class _StepFiles:
    """One ``step_<n>.pt`` file per save in ``directory``, the last
    ``max_to_keep`` kept, each written to a temporary name and moved into
    place."""

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

    def _write(self, payload: dict) -> int:
        """Write ``payload`` as its step's checkpoint (synchronously),
        then drop all but the newest ``max_to_keep``."""
        step = int(payload["step"])
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)
        return step

    def _load(self, step: int | None, device) -> tuple[int, dict]:
        """The state saved at ``step`` (default the newest) on
        ``device``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step, torch.load(self._path(step),
                                map_location=resolve_device(device),
                                weights_only=True)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""


def _check_layout(step: int, name: str, tree, shapes, dtype, what) -> None:
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
    want = tree_map(lambda s: (tuple(s), dtype), shapes)
    if got != want:
        raise ValueError(f"checkpoint step {step}: {name} do not match "
                         f"{what}")


def _state_mesh(state: dict) -> Mesh | None:
    leaf = next(sharded_leaves(state["params"]), None)
    return leaf.mesh if leaf is not None else None


def _single_host(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.multiprocess:
        raise ValueError("checkpoints are single-host only: a state over "
                         "a mesh of several processes would need a shared "
                         "filesystem and per-process shards")


class TrainCheckpointer(_StepFiles):
    """Save/restore the train state, keeping the last ``max_to_keep``."""

    def save(self, state: dict) -> int:
        """Save ``state`` — on one device, or placed on a mesh, whose
        shards are gathered into whole tensors first."""
        _single_host(_state_mesh(state))
        state = gather_state(state)
        return self._write({"params": state["params"], "opt": state["opt"],
                            "step": int(state["step"])})

    def restore(self, cfg: TransformerConfig,
                where: str | torch.device | Mesh = "cuda",
                step: int | None = None) -> dict:
        """Load the state saved at ``step`` (default the newest), check
        it against ``cfg`` — every parameter and moment must have the
        config's shape and dtype — and put it on ``where``: a device,
        or a :class:`Mesh`, whose shards it is placed into
        (``train.place_state``)."""
        mesh = where if isinstance(where, Mesh) else None
        _single_host(mesh)
        step, state = self._load(step, "cpu" if mesh else where)
        shapes = param_shapes(cfg)
        for name in ("params", "mu", "nu"):
            tree = state["params"] if name == "params" else state["opt"][name]
            _check_layout(step, name, tree, shapes, cfg.dtype,
                          f"the config {cfg}")
        if mesh is not None:
            state = place_state(state, mesh)
        return state


class LoraCheckpointer(_StepFiles):
    """Save/restore the adapter train state — adapters, their moments and
    the step, never the frozen base — keeping the last ``max_to_keep``."""

    def save(self, state: dict) -> int:
        return self._write({"adapters": state["adapters"],
                            "opt": state["opt"], "step": int(state["step"])})

    def restore(self, cfg: TransformerConfig, optimizer, rank: int,
                targets: tuple[str, ...] | None = None,
                step: int | None = None,
                device: str | torch.device = "cuda") -> dict:
        """Load the adapter state saved at ``step`` (default the newest)
        onto ``device`` and check it against the structure that
        ``init_lora_state(init_lora(cfg, rank, targets), optimizer)``
        builds: adapters and moments of the config's shapes and dtype
        (``targets`` default ``lora.DEFAULT_TARGETS``)."""
        from tpushare_torch.workloads.lora import DEFAULT_TARGETS, lora_shapes
        tgt = targets if targets is not None else DEFAULT_TARGETS
        step, state = self._load(step, device)
        shapes = lora_shapes(cfg, rank, tgt)
        want_opt = set(optimizer.init({}).keys())
        if set(state["opt"]) != want_opt:
            raise ValueError(f"checkpoint step {step}: optimizer state keys "
                             f"{sorted(state['opt'])} != {sorted(want_opt)}")
        what = f"rank {rank} adapters on {tuple(tgt)} of {cfg}"
        for name in ("adapters", "mu", "nu"):
            tree = (state["adapters"] if name == "adapters"
                    else state["opt"][name])
            _check_layout(step, name, tree, shapes, cfg.dtype, what)
        return state
