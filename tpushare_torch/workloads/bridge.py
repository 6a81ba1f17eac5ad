"""Carry reference state across: numpy trees -> the port's tensors.

The reference's parameters are a pytree of ``jax.Array`` leaves; the
caller converts each leaf with ``np.asarray`` and hands the resulting
numpy tree here, so this module never imports JAX. Leaf layout and
names are the same on both sides (``models/transformer.init_params``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpushare_torch.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a numpy / JAX dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} not in {tuple(_DTYPES)}") from None


def tensor_from_numpy(arr: np.ndarray,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """One leaf. A bf16 array (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects) goes through float32, which holds every
    bf16 value exactly, and back to bf16."""
    dev = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32, order="C"))
        return t.to(device=dev, dtype=torch.bfloat16)
    # a copy: a leaf converted from a device array is read-only, and the
    # port writes some buffers in place
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(dev)


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """Map a (nested dict) numpy tree onto tensors, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def adamw_state_from_numpy(mu, nu, count,
                           device: str | torch.device = "cuda") -> dict:
    """An optax AdamW state — its ``ScaleByAdamState`` moments ``mu`` and
    ``nu`` (numpy trees shaped like the params) and its update ``count``
    — as the port's optimizer state (``train.AdamW.init``'s layout)."""
    return {"mu": params_from_numpy(mu, device),
            "nu": params_from_numpy(nu, device), "count": int(count)}
