"""Device resolution shared by the port's entry points, and the unit
math of the Allocate env contract (the reference's
``tpushare/tpu/device.py:138-152``)."""

from __future__ import annotations

import torch

from tpushare_torch import consts


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; a
    host without CUDA raises instead of carrying on quietly on the CPU —
    a caller that wants the plain-PyTorch CPU path asks for it with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain-PyTorch path on the CPU")
    return dev


def chunk_mib_for(memory_unit: str = consts.MIB, chunk_mib: int | None = None
                  ) -> int:
    """MiB one resource unit of the Allocate env contract stands for."""
    if chunk_mib is not None:
        if chunk_mib <= 0:
            raise ValueError(f"chunk_mib must be positive, got {chunk_mib}")
        return chunk_mib
    if memory_unit == consts.GIB:
        return 1024
    if memory_unit == consts.MIB:
        return 1
    raise ValueError(f"unknown memory unit {memory_unit!r}")


def units_to_mib(units: int, memory_unit: str = consts.MIB,
                 chunk_mib: int | None = None) -> int:
    """A unit-scaled HBM figure of the env contract in MiB."""
    return units * chunk_mib_for(memory_unit, chunk_mib)
