"""Seeded weights in the port's parameter layout, made on the device.

Each stacked leaf is drawn by one ``torch.randn`` call in the served
dtype from a generator of its own, seeded from the run's seed and the
leaf's name, so any leaf can be drawn again alone and comes out the
same: the reference re-derives the weights it checks against instead
of reading the program's. Matrices are ``normal(0, 1) * fan_in**-0.5``
(fan-in = the model width for the embedding table, the leaf's
second-to-last axis otherwise), RMSNorm scales are ones:
the port's ``init_params`` rule. This module imports nothing of the
port.
"""

from __future__ import annotations

import hashlib

import torch


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Flat leaf name -> shape, in the port's layout (layers stacked on
    a leading axis). ``m`` is :func:`benchmark.model.dims`' dict."""
    L, D, F, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]
    KD = m["kv_heads"] * m["head_dim"]
    return {"embed": (V, D),
            "layers.wq": (L, D, D), "layers.wk": (L, D, KD),
            "layers.wv": (L, D, KD), "layers.wo": (L, D, D),
            "layers.w1": (L, D, F), "layers.w3": (L, D, F),
            "layers.w2": (L, F, D), "layers.ln1": (L, D),
            "layers.ln2": (L, D), "norm_f": (D,), "out": (D, V)}


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a
    leaf or stream name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(leaf_seed(seed, name))
    return g


def make_leaf(seed: int, name: str, shape: tuple[int, ...],
              dtype: torch.dtype, device) -> torch.Tensor:
    """One leaf, drawn in one call on ``device`` in ``dtype``."""
    if name.rsplit(".", 1)[-1] in ("ln1", "ln2", "norm_f"):
        return torch.ones(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator(seed, name, device),
                    dtype=dtype, device=device)
    fan_in = shape[-1] if name == "embed" else shape[-2]
    return w.mul_(fan_in ** -0.5)


def make_params(seed: int, m: dict, dtype: torch.dtype, device) -> dict:
    """The port's nested parameter dict (``embed``, ``layers`` of
    stacked leaves, ``norm_f``, ``out``)."""
    params: dict = {"layers": {}}
    for name, shape in param_shapes(m).items():
        leaf = make_leaf(seed, name, shape, dtype, device)
        if name.startswith("layers."):
            params["layers"][name.split(".", 1)[1]] = leaf
        else:
            params[name] = leaf
    return params

