"""Training step of the port: AdamW over the transformer on one device —
the counterpart of ``tpushare/workloads/train.py``.

The reference jits loss, backward and the optax update into one
donating program over a mesh. Here the step runs eagerly on one device:
autograd through :func:`transformer.loss_fn` (on the card the attention
backward is the dQ and dK/dV kernels), then :class:`AdamW` updates the
parameters and moments **in place** (the counterpart of donation: one
copy of params + optimizer state on the device).

:class:`AdamW` is optax's ``adamw`` (optionally chained after
``clip_by_global_norm``, with the warmup + cosine schedule), written out
on a dict of tensors op for op: moments kept in the params' dtype
(optax's ``mu_dtype=None``), the bias correction computed in fp32 and
cast, decoupled weight decay ``p - lr * (adam + wd * p)``, and clipping
as ``g * max / ||g||`` only when ``||g|| >= max``. Python scalars are
rounded to the tensor's dtype first, as JAX does with weak-typed
scalars. ``torch.optim.AdamW`` differs in each of those places
(fused bias correction, ``clip_grad_norm_``'s ``||g|| + 1e-6``, its own
step counting), so the port keeps this form and the tests hold it to
optax.

:func:`make_moe_train_step` is the same step over the MoE model
(``models/moe.moe_loss_fn``: cross entropy plus ``router_aux_coef`` x
the load-balancing term) on one device.

There is no mesh in this slice: ring attention, expert parallelism and
more than one device are ROADMAP A.10.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Sequence

import torch

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (TransformerConfig,
                                                         loss_fn)

B1, B2, EPS = 0.9, 0.95, 1e-8


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more nested dicts of one
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX rounds a weak-typed
    scalar before it meets a tensor of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def warmup_cosine(init: float, peak: float, warmup_steps: int,
                  decay_steps: int, end: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps, end_value=end)`` as a function of the update count."""
    alpha = 0.0 if peak == 0.0 else end / peak
    cos_steps = decay_steps - warmup_steps

    def lr_at(count: int) -> float:
        if count < warmup_steps:
            return (init - peak) * (1 - count / warmup_steps) + peak
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak * ((1 - alpha) * cosine + alpha)
    return lr_at


class AdamW:
    """optax ``adamw(lr, b1=0.9, b2=0.95, weight_decay)``, optionally after
    ``clip_by_global_norm(clip_norm)``, over a nested dict of tensors.

    ``init(params)`` gives the state ``{"mu", "nu", "count"}`` (the
    moments mirror the params' tree and dtype; ``count`` is the number
    of updates applied, optax's adam and schedule count alike).
    ``update(grads, state, params)`` applies one step in place."""

    def __init__(self, lr: float | Callable[[int], float] = 3e-4,
                 weight_decay: float = 0.01,
                 clip_norm: float | None = None) -> None:
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def init(self, params: dict) -> dict:
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params), "count": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        gs = list(tree_leaves(grads))
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
            keep = norm < self.clip_norm
            gs = [torch.where(keep, g, (g / norm.to(g.dtype))
                              * _rounded(self.clip_norm, g.dtype))
                  for g in gs]
        lr = self.lr_at(state["count"])
        count = state["count"] + 1
        # 1 - b**count in fp32, then cast to the moment's dtype (optax)
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** count)
        for p, g, mu, nu in zip(tree_leaves(params), gs,
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            dt = mu.dtype

            def r(x, dt=dt):
                return _rounded(x, dt)
            mu.copy_(r(1 - B1) * g + r(B1) * mu)
            nu.copy_(r(1 - B2) * (g * g) + r(B2) * nu)
            u = (mu / r(bc1)) / (torch.sqrt(nu / r(bc2)) + r(EPS))
            u = u + r(self.weight_decay, p.dtype) * p
            p.add_(r(-lr, u.dtype) * u)
        state["count"] = count


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   clip_norm: float | None = None, warmup_steps: int = 0,
                   decay_steps: int | None = None,
                   end_lr_ratio: float = 0.1) -> AdamW:
    """AdamW, optionally with global-norm gradient clipping and a warmup +
    cosine-decay schedule — the reference's ``make_optimizer``: lr ramps
    0 -> lr over ``warmup_steps``, then decays to ``lr * end_lr_ratio``
    at ``decay_steps``; with warmup but no decay horizon the decay
    stretches to 10x the warmup; decay without warmup starts at peak
    lr."""
    schedule: float | Callable[[int], float] = lr
    if warmup_steps or decay_steps:
        if decay_steps is not None and decay_steps <= warmup_steps:
            raise ValueError(f"decay_steps {decay_steps} must exceed "
                             f"warmup_steps {warmup_steps}")
        total = decay_steps if decay_steps is not None else warmup_steps * 10
        init = 0.0 if warmup_steps else lr
        schedule = warmup_cosine(init, lr, max(warmup_steps, 1),
                                 max(total, warmup_steps + 1),
                                 end=lr * end_lr_ratio)
    return AdamW(schedule, weight_decay=weight_decay, clip_norm=clip_norm)


def init_state(params: dict, optimizer: AdamW) -> dict:
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def _one_device(device) -> torch.device:
    """The step's device; a mesh of several is ROADMAP A.10."""
    if isinstance(device, Sequence) and not isinstance(device, str):
        if len(device) != 1:
            raise NotImplementedError(
                f"training over {len(device)} devices needs the mesh, "
                "which is not ported yet (ROADMAP A.10)")
        device = device[0]
    return resolve_device(device)


def loss_and_grads(params: dict, inputs: torch.Tensor,
                   targets: torch.Tensor, cfg: TransformerConfig,
                   loss_of=loss_fn) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_of`` (default :func:`loss_fn`): detached
    leaves that share the params' storage stand in as the autograd
    leaves."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_of(leaves, inputs, targets, cfg)
    flat = list(tree_leaves(leaves))
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def make_train_step(cfg: TransformerConfig, optimizer: AdamW,
                    device="cuda", ring_attention: bool = False,
                    accum_steps: int = 1):
    """Returns ``step(state, inputs, targets) -> (state, loss)``, which
    updates ``state`` in place and returns it with the step's mean loss
    (a 0-d fp32 tensor on the device). ``accum_steps > 1`` runs that many
    microbatches with fp32 gradient accumulators before the one update.
    ``device`` is the card by default; a list of more than one device,
    or ``ring_attention=True``, raises (ROADMAP A.10)."""
    if ring_attention:
        raise NotImplementedError(
            "ring attention (sequence-parallel over a mesh) is not ported "
            "yet (ROADMAP A.10)")
    dev = _one_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def body(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        params = state["params"]
        inputs, targets = inputs.to(dev), targets.to(dev)
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, inputs, targets, cfg)
        else:
            # fp32 accumulators over equal microbatches: the mean of the
            # means is the full-batch mean, in 1/accum the activations
            B = inputs.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by "
                                 f"accum_steps {accum_steps}")
            mb = B // accum_steps
            gsum = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for a in range(accum_steps):
                rows = slice(a * mb, (a + 1) * mb)
                loss, grads = loss_and_grads(params, inputs[rows],
                                             targets[rows], cfg)
                for acc, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                    acc.add_(g.float())
                lsum = lsum + loss
                del grads
            grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype),
                             gsum, params)
            loss = lsum / accum_steps
        optimizer.update(grads, state["opt"], params)
        state["step"] += 1
        return state, loss

    return body


def make_moe_train_step(cfg, optimizer: AdamW, device="cuda"):
    """Returns ``step(state, inputs, targets) -> (state, loss)`` over the
    MoE model (``init_state(init_moe_params(...), optimizer)``): the
    gradient of ``moe_loss_fn`` (on the card the attention runs the
    flash forward with LSE and its dQ / dK/dV backward), then one AdamW
    update in place — the reference's ``make_moe_train_step`` on one
    device. A list of more than one device raises (ROADMAP A.10: the
    ``ep`` mesh)."""
    from tpushare_torch.workloads.models.moe import moe_loss_fn
    dev = _one_device(device)

    def step(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        loss, grads = loss_and_grads(state["params"], inputs.to(dev),
                                     targets.to(dev), cfg, moe_loss_fn)
        optimizer.update(grads, state["opt"], state["params"])
        state["step"] += 1
        return state, loss

    return step


def make_train_loop(cfg: TransformerConfig, optimizer: AdamW, device,
                    n_steps: int, ring_attention: bool = False,
                    accum_steps: int = 1):
    """Returns ``loop(state, inputs, targets) -> (state, losses)``:
    ``n_steps`` optimizer steps on the same batch, losses (n_steps,)."""
    body = make_train_step(cfg, optimizer, device, ring_attention,
                           accum_steps)

    def loop(state: dict, inputs: torch.Tensor, targets: torch.Tensor):
        losses = []
        for _ in range(n_steps):
            state, loss = body(state, inputs, targets)
            losses.append(loss)
        return state, torch.stack(losses)

    return loop
