"""The chip record of the CUDA backend — the port's counterpart of
``tpushare/tpu/device.py``'s ``TpuChip``: the same fields, so the
unchanged daemon advertises, allocates and mounts a GPU as it does a
TPU chip.

- ``index``: the NVML index, in PCI bus order (what a payload's
  ``CUDA_VISIBLE_DEVICES`` names under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``);
- ``chip_id``: the GPU UUID, as upstream gpushare keys its fake device
  ids (``<UUID>-_-<j>``);
- ``hbm_mib``: NVML's total memory // 2^20;
- ``generation``: the NVML name;
- ``dev_paths``: ``/dev/nvidia<minor>`` and the control nodes
  (``/dev/nvidiactl``, ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``)
  that exist — what Allocate hands the container runtime;
- ``pci_bdf``, and ``coords`` None: a GPU node has no slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from tpushare_torch import consts


@dataclass(frozen=True)
class GpuChip:
    """One GPU of this host, as the daemon sees a chip."""

    index: int
    chip_id: str
    hbm_mib: int
    generation: str = ""
    dev_paths: tuple[str, ...] = ()
    pci_bdf: str | None = None
    coords: tuple[int, int, int] | None = None
    minor: int | None = None
    extra: dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def default_dev_paths(self) -> tuple[str, ...]:
        node = self.minor if self.minor is not None else self.index
        return self.dev_paths or (f"/dev/nvidia{node}",)


def fake_device_ids(chip: GpuChip) -> list[str]:
    """The kubelet device ids the daemon advertises for ``chip`` at its
    default MiB unit: one per MiB, ``<chipID>-_-<j>``."""
    return [f"{chip.chip_id}{consts.FAKE_ID_SEP}{j}"
            for j in range(chip.hbm_mib)]
