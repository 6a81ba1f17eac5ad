"""Mixture-of-Experts transformer in PyTorch — the port of
``tpushare/workloads/models/moe.py`` on one device.

GShard-style routing with static shapes, as the reference: the top-k
experts of each token come from the router's softmax, each expert keeps
a buffer of ``C`` slots per batch row, a token's slot is a cumsum over
the sequence, and a token past its expert's capacity is dropped (its
residual path passes through). Dispatch and combine are (B, S, E, C)
one-hot / gate-weighted tensors around the expert SwiGLUs, four einsums
— plain PyTorch here as they are plain XLA in the reference, where no
Pallas kernel computes them.

Routing parity: ``lax.top_k`` breaks ties toward the lower expert
index, which ``torch.topk`` does not promise, so the top-k comes from a
stable descending argsort. Slots fill in the reference's order: the
cumsum runs over the sequence for the first choice of every token, then
the second (``j = 0 .. K-1``), with the kept counts carried between
them, so the same tokens drop under capacity pressure.

Expert parallelism (``moe_ffn(..., experts=...)``): under an ep mesh
the expert weights live split as ``parallel/mesh.moe_param_specs`` says
(experts over ep, their ff dim over tp). The dispatch runs on the
router's device; each ep rank computes its E/ep experts' (E/ep, B, C, D)
buffers on its devices (a tp split of the ff dim summed in rank order in
fp32), the buffers come back in rank order, and the combine runs the
unsharded einsum over them. The attention of a MoE layer is the dense
model's, so on the card it runs the flash kernels (forward, and its
backward in training).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig,
    attention,
    embed_lookup,
    layer_block,
    lm_head,
    rope_tables,
    unbind_layers,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    """The reference's ``MoEConfig``: the dense fields plus the experts,
    with the same names and defaults."""

    n_experts: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @property
    def expert_capacity(self) -> int:
        """Per-expert slots per batch row at full max_seq."""
        return self.capacity_for(self.max_seq)

    def capacity_for(self, seq: int) -> int:
        """ceil(k * seq * capacity_factor / E), floored at min(4, k * seq)
        so tiny shapes route — sized to the tokens actually routed (one
        per row in a decode step, the padded width in a chunk)."""
        c = -(-self.expert_top_k * seq * self.capacity_factor
              // self.n_experts)
        return max(min(4, self.expert_top_k * seq), int(c))


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device: str | torch.device = "cuda") -> dict:
    """The dense dict with the FFN replaced by E experts and a router:
    layers router (L, D, E) fp32, w1/w3 (L, E, D, F), w2 (L, E, F, D);
    attention, embedding and head as the dense model's. Draws
    ``normal * fan_in**-0.5`` from ``generator`` (on ``device``), in the
    order embed, wq, wk, wv, wo, router, w1, w3, w2, out; tests carry
    the reference's draws across with ``bridge.params_from_numpy``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, params on "
                         f"{dev}: draw the weights where they are used")
    L, D, F_, V, E = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
                      cfg.n_experts)
    KD = cfg.kv_dim

    def dense(shape, fan_in, dtype=cfg.dtype):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * (fan_in ** -0.5)).to(dtype)

    embed = dense((V, D), D)
    layers = {
        "wq": dense((L, D, D), D), "wk": dense((L, D, KD), D),
        "wv": dense((L, D, KD), D), "wo": dense((L, D, D), D),
        "router": dense((L, D, E), D, torch.float32),
        "w1": dense((L, E, D, F_), D), "w3": dense((L, E, D, F_), D),
        "w2": dense((L, E, F_, D), F_),
        "ln1": torch.ones((L, D), device=dev, dtype=cfg.dtype),
        "ln2": torch.ones((L, D), device=dev, dtype=cfg.dtype),
    }
    return {"embed": embed, "layers": layers,
            "norm_f": torch.ones((D,), device=dev, dtype=cfg.dtype),
            "out": dense((D, V), D)}


def build_dispatch_combine(h: torch.Tensor, router: torch.Tensor,
                           cfg: MoEConfig, C: int, with_stats: bool = False):
    """The routing: top-k over the router softmax (fp32), capacity slots
    by cumsum. Returns (dispatch, combine — (B, S, E, C) fp32 one-hot /
    gate-weighted — and the load-balancing aux scalar, Switch eq. 4:
    E * sum_e importance_e * load_e, load from the first choice only).
    ``with_stats`` adds the (importance, load) pair, (E,) each, that a
    batch split over dp averages before the product."""
    E, K = cfg.n_experts, cfg.expert_top_k
    logits = h.float() @ router                                # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.argsort(-probs, dim=-1, stable=True)[..., :K]
    gate_vals = torch.gather(probs, -1, gate_idx)              # (B, S, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    B, S = h.shape[:2]
    dispatch = torch.zeros((B, S, E, C), dtype=torch.float32, device=h.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((B, 1, E), dtype=torch.int64, device=h.device)
    for j in range(K):
        mask = F.one_hot(gate_idx[..., j], E)                  # (B, S, E)
        pos = torch.cumsum(mask, dim=1) - 1 + counts           # buffer slot
        keep = (mask == 1) & (pos < C)
        slot = F.one_hot(pos.clamp(0, C - 1), C).float()       # (B,S,E,C)
        d_j = slot * keep[..., None]
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_vals[..., j, None, None]
        counts = counts + keep.sum(dim=1, keepdim=True)

    importance = probs.mean(dim=(0, 1))                        # (E,)
    load = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(importance * load)
    if with_stats:
        return dispatch, combine, aux, (importance, load)
    return dispatch, combine, aux


def _experts(xin: torch.Tensor, w: dict) -> torch.Tensor:
    """The expert SwiGLUs over (E, B, C, D) buffers."""
    h1 = torch.einsum("ebcd,edf->ebcf", xin, w["w1"])
    h3 = torch.einsum("ebcd,edf->ebcf", xin, w["w3"])
    return torch.einsum("ebcf,efd->ebcd", F.silu(h1) * h3, w["w2"])


def moe_ffn(h: torch.Tensor, lp: dict, cfg: MoEConfig,
            capacity: int | None = None,
            experts: list | None = None, with_stats: bool = False):
    """Top-k routed expert SwiGLU, h (B, S, D) -> (out (B, S, D), aux).
    ``capacity`` overrides the max_seq-sized default.

    ``experts`` is the ep form: ``experts[e][t]`` the ``{w1, w3, w2}``
    blocks of ep rank e's E/ep experts and tp rank t's ff columns, each
    on its device. Rank e's buffers go to its devices and come back in
    rank order; the tp partials are summed in rank order in fp32. The
    router, dispatch and combine stay on ``h``'s device. ``with_stats``
    appends the routing's (importance, load)."""
    C = capacity if capacity is not None else cfg.expert_capacity
    if with_stats:
        dispatch, combine, aux, stats = build_dispatch_combine(
            h, lp["router"], cfg, C, with_stats=True)
    else:
        dispatch, combine, aux = build_dispatch_combine(h, lp["router"],
                                                        cfg, C)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(h.dtype), h)
    if experts is None:
        y = _experts(xin, lp)
    else:
        from tpushare_torch.workloads.parallel.mesh import Reduce
        el = cfg.n_experts // len(experts)
        blocks = []
        for e, ranks in enumerate(experts):
            parts = [_experts(xin[e * el:(e + 1) * el].to(w["w1"].device), w)
                     for w in ranks]
            y_e = parts[0] if len(parts) == 1 else Reduce.apply(
                parts[0].device, parts[0].dtype, *parts)
            blocks.append(y_e.to(h.device))
        y = torch.cat(blocks, dim=0)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(h.dtype), y)
    return (out, aux, stats) if with_stats else (out, aux)


def moe_layer_block(x: torch.Tensor, lp: dict, cfg: MoEConfig,
                    cos: torch.Tensor, sin: torch.Tensor, attn_core=None,
                    capacity: int | None = None):
    """One MoE layer: ``transformer.layer_block`` with the routed experts
    (:func:`moe_ffn`) in place of the SwiGLU. ``attn_core(q, k, v) ->
    (o, aux)`` overrides the attention (cache fills and reads); returns
    (x, (aux loss, attention aux))."""
    if attn_core is None:
        def attn_core(q, k, v):
            return attention(q, k, v, cfg), None
    auxes = []

    def experts(h, lp):
        y, aux = moe_ffn(h, lp, cfg, capacity=capacity)
        auxes.append(aux)
        return y
    x, attn_aux = layer_block(x, lp, cfg, cos, sin, attn_core, ffn=experts)
    return x, (auxes[0], attn_aux)


def moe_forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                attn_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, mean per-layer aux).
    ``attn_fn(q, k, v) -> o`` overrides the attention; ``cfg.remat``
    recomputes each layer in the backward, as the dense forward does."""
    S = tokens.shape[1]
    cos, sin = rope_tables(cfg, S, tokens.device)
    attn_core = None if attn_fn is None else (
        lambda q, k, v: (attn_fn(q, k, v), None))

    def layer(x, lp):
        x, (aux, _) = moe_layer_block(x, lp, cfg, cos, sin,
                                      attn_core=attn_core)
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    auxes = []
    for lp in unbind_layers(params):
        x, aux = (checkpoint(layer, x, lp, use_reentrant=False) if remat
                  else layer(x, lp))
        auxes.append(aux)
    return lm_head(params, x), torch.stack(auxes).mean()


def moe_loss_fn(params: dict, inputs: torch.Tensor, targets: torch.Tensor,
                cfg: MoEConfig, attn_fn=None) -> torch.Tensor:
    """Cross entropy plus ``router_aux_coef`` x the load-balancing aux."""
    logits, aux = moe_forward(params, inputs, cfg, attn_fn=attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean() + cfg.router_aux_coef * aux


def moe_param_count(cfg: MoEConfig) -> int:
    """Exact parameter count of :func:`init_moe_params`' dict."""
    D, F_, V, L, E = (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers,
                      cfg.n_experts)
    per_layer = (2 * D * D + 2 * D * cfg.kv_dim + D * E
                 + E * 3 * D * F_ + 2 * D)
    return V * D + L * per_layer + D + D * V
