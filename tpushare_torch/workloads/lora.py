"""LoRA: low-rank adapters over frozen base weights — the port of
``tpushare/workloads/lora.py``.

A targeted weight becomes a ``{"w": base, "a": (.., D, r), "b": (.., r,
N)}`` leaf, and :func:`lora_mm`, plugged into the ``mm`` hook every
projection of ``transformer.layer_block`` goes through, computes ``x @ w
+ (x @ a) @ b`` (the alpha/r scale is folded into ``b`` by
:func:`apply_lora`). The base may itself be an int8 ``{"q", "s"}`` leaf:
its product then runs through ``quant.qmm`` — QLoRA — whose autograd
saves the int8 leaf, not a bf16 copy.

Training optimizes only the adapters: :func:`make_lora_train_step`
takes the gradient of the loss with respect to the adapter tree, the
base never requires a gradient and has no optimizer moments, and the
port's AdamW updates the adapters and their moments in place. ``b``
starts at zero, so step 0 is exactly the base model.
"""

from __future__ import annotations

import torch

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         loss_fn)
from tpushare_torch.workloads.quant import qmm
from tpushare_torch.workloads.train import AdamW, tree_leaves, tree_map

__all__ = ["init_lora", "apply_lora", "lora_mm", "merge_lora",
           "init_lora_state", "make_lora_train_step", "lora_param_count",
           "lora_shapes", "DEFAULT_TARGETS"]

DEFAULT_TARGETS = ("wq", "wv")

_SHAPES = {
    "wq": lambda c: (c.d_model, c.d_model),
    "wk": lambda c: (c.d_model, c.kv_dim),
    "wv": lambda c: (c.d_model, c.kv_dim),
    "wo": lambda c: (c.d_model, c.d_model),
    "w1": lambda c: (c.d_model, c.d_ff),
    "w3": lambda c: (c.d_model, c.d_ff),
    "w2": lambda c: (c.d_ff, c.d_model),
}


def _validate_targets(targets) -> None:
    bad = [t for t in targets if t not in _SHAPES]
    if bad:
        raise ValueError(f"unknown LoRA targets {bad}; pick from "
                         f"{sorted(_SHAPES)}")


def lora_shapes(cfg: TransformerConfig, rank: int,
                targets: tuple[str, ...] = DEFAULT_TARGETS) -> dict:
    """The adapter tree's shapes, without allocating: per target a
    (L, in, rank) ``a`` and a (L, rank, out) ``b``."""
    _validate_targets(targets)
    L = cfg.n_layers
    out = {}
    for t in targets:
        din, dout = _SHAPES[t](cfg)
        out[t] = {"a": (L, din, rank), "b": (L, rank, dout)}
    return out


def init_lora(generator: torch.Generator, cfg: TransformerConfig, rank: int,
              targets: tuple[str, ...] = DEFAULT_TARGETS,
              device: str | torch.device = "cuda") -> dict:
    """Adapter tree ``{target: {"a", "b"}}``: a gaussian / sqrt(in)
    down-projection drawn from ``generator`` (in target order) and a zero
    up-projection, in the model dtype, so the adapted model starts at the
    base. The alpha/rank scale is a hyperparameter of
    :func:`apply_lora`, never a trainable leaf."""
    dev = resolve_device(device)
    adapters = {}
    for t, shp in lora_shapes(cfg, rank, targets).items():
        a = torch.randn(shp["a"], generator=generator, device=dev,
                        dtype=torch.float32) * (shp["a"][1] ** -0.5)
        adapters[t] = {"a": a.to(cfg.dtype),
                       "b": torch.zeros(shp["b"], device=dev,
                                        dtype=cfg.dtype)}
    return adapters


def apply_lora(params: dict, adapters: dict, scale: float = 1.0) -> dict:
    """Each targeted layer leaf becomes ``{"w": base, "a", "b"}`` for
    :func:`lora_mm`. ``scale`` (alpha/rank) folds into ``b`` in fp32 and
    is cast back, so the gradient still reaches the raw ``b``. Base
    leaves are referenced, not copied (and may be int8 leaves)."""
    layers = dict(params["layers"])
    for t, ab in adapters.items():
        b = ab["b"]
        if scale != 1.0:
            b = (b.float() * scale).to(b.dtype)
        layers[t] = {"w": layers[t], "a": ab["a"], "b": b}
    return {**params, "layers": layers}


def lora_mm(x: torch.Tensor, w) -> torch.Tensor:
    """The ``mm`` hook: a LoRA leaf adds the low-rank path to the frozen
    base (int8 through qmm); anything else is qmm's dense / int8
    product."""
    if isinstance(w, dict) and "a" in w:
        base = qmm(x, w["w"])
        low = (x @ w["a"]) @ w["b"]
        return base + low.to(base.dtype)
    return qmm(x, w)


def merge_lora(params: dict, adapters: dict, scale: float = 1.0) -> dict:
    """Fold the adapters into dense base weights, ``w + a @ b * scale``
    in fp32, for serving without the extra products. Refuses an int8
    base."""
    layers = dict(params["layers"])
    for t, ab in adapters.items():
        w = layers[t]
        if isinstance(w, dict):
            raise ValueError(f"cannot merge into non-dense base leaf {t}; "
                             "dequantize first")
        delta = torch.einsum("ldr,lrn->ldn", ab["a"].float(),
                             ab["b"].float()) * scale
        layers[t] = (w.float() + delta).to(w.dtype)
    return {**params, "layers": layers}


def lora_param_count(cfg: TransformerConfig, rank: int,
                     targets: tuple[str, ...] = DEFAULT_TARGETS) -> int:
    """Closed-form adapter count — no allocation."""
    _validate_targets(targets)
    return sum(cfg.n_layers * rank * sum(_SHAPES[t](cfg)) for t in targets)


def init_lora_state(adapters: dict, optimizer: AdamW) -> dict:
    """Optimizer state over the adapters only — the frozen base never
    gets moments."""
    return {"adapters": adapters, "opt": optimizer.init(adapters),
            "step": 0}


def make_lora_train_step(cfg: TransformerConfig, optimizer: AdamW,
                         scale: float = 1.0):
    """Returns ``step(lora_state, base_params, inputs, targets) ->
    (lora_state, loss)``: the gradient of ``loss_fn`` over the adapted
    model with respect to the adapters alone, then one AdamW update of
    the adapters and their moments in place. The base rides as a frozen
    argument — no gradient, no moments — so the device holds base +
    adapters + adapter moments (QLoRA: pass ``quant.quantize_params`` of
    the base and the frozen products read int8). On the card the
    attention runs the flash forward with LSE and its dQ / dK/dV
    backward."""
    def step(state: dict, base_params: dict, inputs: torch.Tensor,
             targets: torch.Tensor):
        adapters = state["adapters"]
        leaves = tree_map(lambda p: p.detach().requires_grad_(), adapters)
        with torch.enable_grad():
            merged = apply_lora(base_params, leaves, scale)
            loss = loss_fn(merged, inputs, targets, cfg, mm=lora_mm)
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(leaves))))
        optimizer.update(tree_map(lambda _: next(grads), leaves),
                         state["opt"], adapters)
        state["step"] += 1
        return state, loss.detach()

    return step
