"""The reference training step: the first steps of a run followed in
plain fp32 arithmetic from the seed's weights and batches.

What it follows is what the configuration states: parameters and both
AdamW moments stored in the configuration's dtype (bf16: 8 bytes a
parameter, optax's ``mu_dtype=None``), every product, the loss, the
gradients and the update computed in fp32 and rounded once into
storage. AdamW is optax's ``adamw`` (b1, b2, eps, decoupled weight
decay ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), with the
bias corrections of the update count.

The backward runs a layer at a time: a no-grad forward keeps each
layer's input, then each layer is recomputed under autograd from its
input and given the gradient of its output, and its leaves are updated
at once. Readings, per leaf — one layer's slice of a stacked leaf, or
``embed``, ``norm_f``, ``out``:

- ``losses``: each step's mean cross entropy (fp32 log-softmax);
- ``grad_norms``: the first step's gradient norm;
- ``change_norms``: the norm of the parameters' change after the last
  step, from the weights as drawn.
"""

from __future__ import annotations

import torch

from benchmark.reference import transformer as T
from benchmark.weights import make_leaf, make_params, param_shapes


def loss_of(logits: torch.Tensor, targets: torch.Tensor,
            loss_mode: str = "mean") -> torch.Tensor:
    """Mean cross entropy. ``"half"`` is a planted fault: half of the
    batch left out (half the rows, or half the positions of a one-row
    batch) and the mean taken over the rest."""
    if loss_mode == "half":
        B, S = targets.shape
        if B > 1:
            logits, targets = logits[: B // 2], targets[: B // 2]
        else:
            logits, targets = logits[:, : S // 2], targets[:, : S // 2]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


class _AdamW:
    def __init__(self, lr: float, weight_decay: float, b1: float,
                 b2: float, eps: float) -> None:
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    @torch.no_grad()
    def update(self, p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, count: int) -> None:
        """In place on the stored (possibly bf16) p, mu, nu."""
        g = g.float()
        m32 = self.b1 * mu.float() + (1 - self.b1) * g
        v32 = self.b2 * nu.float() + (1 - self.b2) * g * g
        mhat = m32 / (1 - self.b1 ** count)
        vhat = v32 / (1 - self.b2 ** count)
        p32 = p.float()
        u = mhat / (torch.sqrt(vhat) + self.eps) + self.wd * p32
        p.copy_(p32 - self.lr * u)
        mu.copy_(m32)
        nu.copy_(v32)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.float()))


def reference_train(seed: int, m: dict, batch, steps: int, opt: dict,
                    device, prec: str = "fp32", loss_mode: str = "mean"
                    ) -> dict:
    """Follow ``steps`` training steps. ``batch(k)`` gives step k's
    (inputs, targets), derived from the seed as the program's were."""
    precf = T.PRECISIONS[prec]
    params = make_params(seed, m, m["dtype"], device)
    mu = {"embed": torch.zeros_like(params["embed"]),
          "norm_f": torch.zeros_like(params["norm_f"]),
          "out": torch.zeros_like(params["out"]),
          "layers": {n: torch.zeros_like(w)
                     for n, w in params["layers"].items()}}
    nu = {k: ({n: torch.zeros_like(w) for n, w in v.items()}
              if k == "layers" else torch.zeros_like(v))
          for k, v in mu.items()}
    adam = _AdamW(opt.get("lr", 3e-4), opt.get("weight_decay", 0.01),
                  opt.get("b1", 0.9), opt.get("b2", 0.95),
                  opt.get("eps", 1e-8))
    L = m["n_layers"]
    losses, grad_norms = [], {}
    with T.fp32_matmul():
        for k in range(steps):
            count = k + 1
            first = k == 0
            inputs, targets = batch(k)
            S = inputs.shape[1]
            pos = torch.arange(S, device=device)
            xs = [params["embed"][inputs].float()]
            with torch.no_grad():
                for i in range(L):
                    xs.append(T.layer(xs[-1], T.layer_weights(params, i), m,
                                      pos, precf))
            x = xs.pop().requires_grad_()
            nf = params["norm_f"].float().requires_grad_()
            out = params["out"].float().requires_grad_()
            with torch.enable_grad():
                loss = loss_of(T.head(x, nf, out, m, precf), targets,
                               loss_mode)
                dy, g_nf, g_out = torch.autograd.grad(loss, [x, nf, out])
            losses.append(float(loss.detach()))
            del x, nf, out, loss
            for name, g in (("norm_f", g_nf), ("out", g_out)):
                if first:
                    grad_norms[name] = _norm(g)
                adam.update(params[name], g, mu[name], nu[name], count)
            del g_nf, g_out
            for i in reversed(range(L)):
                xi = xs.pop().requires_grad_()
                w = {n: t.requires_grad_()
                     for n, t in T.layer_weights(params, i).items()}
                with torch.enable_grad():
                    y = T.layer(xi, w, m, pos, precf)
                    grads = torch.autograd.grad(y, [xi, *w.values()], dy)
                dy = grads[0]
                for n, g in zip(w, grads[1:]):
                    if first:
                        grad_norms[f"layers.{n}[{i}]"] = _norm(g)
                    adam.update(params["layers"][n][i], g,
                                mu["layers"][n][i], nu["layers"][n][i],
                                count)
                del xi, w, y, grads
            g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                                  device=device)
            g_embed.index_add_(0, inputs.reshape(-1),
                               dy.reshape(-1, dy.shape[-1]))
            if first:
                grad_norms["embed"] = _norm(g_embed)
            adam.update(params["embed"], g_embed, mu["embed"], nu["embed"],
                        count)
            del g_embed, dy, xs
    del mu, nu
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms(seed, m, params, device)}


def change_norms(seed: int, m: dict, params: dict, device) -> dict:
    """Per-leaf norm of (params - the weights as drawn), drawing each
    initial leaf again from the seed."""
    out = {}
    flat = {"embed": params["embed"], "norm_f": params["norm_f"],
            "out": params["out"],
            **{f"layers.{n}": w for n, w in params["layers"].items()}}
    for name, shape in param_shapes(m).items():
        p0 = make_leaf(seed, name, shape, m["dtype"], device)
        p = flat[name]
        if name.startswith("layers."):
            for i in range(shape[0]):
                out[f"{name}[{i}]"] = _norm(p[i].float() - p0[i].float())
        else:
            out[name] = _norm(p.float() - p0.float())
        del p0
    return out
