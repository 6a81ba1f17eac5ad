"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


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
