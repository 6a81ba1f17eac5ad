"""Transformer LM in PyTorch — the port of
``tpushare/workloads/models/transformer.py``.

Same architecture and numerics contract as the reference: bf16
activations/weights, fp32 norm accumulation and logits, RoPE from
precomputed tables, SwiGLU, layers stacked on a leading ``(L, ...)``
axis. The reference scans the stack with ``lax.scan``; here ``forward``
loops over ``L`` eagerly. Parameters are a plain dict of tensors with the
reference's pytree layout, so weights cross over leaf for leaf
(``workloads/bridge.py``).

Attention goes through the port's kernel registry (``ops/registry.py``):
on a CUDA tensor the registry picks the hand-written flash kernels
(forward, and the dQ / dK/dV backward when a gradient is taken) where
the reference would pick a Pallas kernel, and on a CPU tensor (the
tests) the plain-PyTorch twin, which is the reference's fp32 einsum
branch op for op.

``loss_fn`` is the reference's training loss; ``cfg.remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``), the counterpart
of the reference's ``jax.checkpoint`` around the scanned layer.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpushare_torch.device import resolve_device
from tpushare_torch.workloads.ops.attention import flash_attention_plain
from tpushare_torch.workloads.ops.registry import (KIND_PREFILL,
                                                   select_attention)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the reference's ``TransformerConfig`` with the same
    name, default and meaning; ``dtype`` is a torch dtype. Fields whose
    machinery lies outside the ported slices (``kv_int8``,
    ``ragged_decode``) are carried so configs compare field for field;
    the entry points that cannot serve them reject them."""

    vocab: int = 2048
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_seq: int = 512
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    # None = auto (the registry picks the kernel on CUDA where the shape
    # tiles, the plain path otherwise, counting the fallback); True
    # requires a kernel; False forces the plain path
    use_flash: bool | None = None
    # pin one registry implementation by name; overrides use_flash
    attn_impl: str | None = None
    n_kv_heads: int | None = None
    remat: bool = False
    kv_int8: bool = False
    attn_window: int | None = None
    ragged_decode: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        h = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % h:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {h}")
        return h

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: str | torch.device = "cuda") -> dict:
    """Stacked-layer parameter dict with the reference's shapes and its
    ``normal * fan_in**-0.5`` scaling (L = n_layers):

    embed (vocab, d_model); layers: wq/wo (L, D, D), wk/wv (L, D, kv_dim),
    w1/w3 (L, D, d_ff), w2 (L, d_ff, D), ln1/ln2 (L, D); norm_f (D,);
    out (D, vocab).

    ``generator`` must live on ``device`` (a CUDA generator for the card)
    so the flagship's weights are drawn where they are used. The draws
    differ from ``jax.random``'s; tests carry reference weights across
    with ``bridge.params_from_numpy`` instead."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, params on "
                         f"{dev}: draw the weights where they are used")
    shapes = param_shapes(cfg)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * (fan_in ** -0.5)).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=cfg.dtype)

    # draws in the order embed, the layer matrices (fan-in = dim 1), out
    embed = dense(shapes["embed"], cfg.d_model)
    layers = {name: ones(shape) if name.startswith("ln")
              else dense(shape, shape[1])
              for name, shape in shapes["layers"].items()}
    return {
        "embed": embed,
        "layers": layers,
        "norm_f": ones(shapes["norm_f"]),
        "out": dense(shapes["out"], cfg.d_model),
    }


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter dict's tree of shapes, without allocating."""
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    KD = cfg.kv_dim
    return {
        "embed": (V, D),
        "layers": {
            "wq": (L, D, D), "wk": (L, D, KD), "wv": (L, D, KD),
            "wo": (L, D, D), "w1": (L, D, F_), "w3": (L, D, F_),
            "w2": (L, F_, D), "ln1": (L, D), "ln2": (L, D),
        },
        "norm_f": (D,),
        "out": (D, V),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer dict (views, no copy)."""
    return {name: w[i] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """fp32 normalise, cast to the model dtype, then scale — the
    reference's order."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(cfg: TransformerConfig,
               device: str | torch.device | None = None) -> torch.Tensor:
    """The (head_dim/2,) rotary frequency vector — the single
    definition the tables and the per-position phases derive from."""
    half = cfg.head_dim // 2
    return cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) / half)


def rope_tables(cfg: TransformerConfig, seq: int,
                device: str | torch.device | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    angles = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
              * rope_freqs(cfg, device)[None, :])
    return torch.cos(angles), torch.sin(angles)       # (seq, half) each


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd): rotate the two halves of the head dim. cos/sin
    are (S, half) shared across the batch or (B, S, half) per row, and
    are cast to x's dtype before the multiply, as in the reference."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: TransformerConfig) -> torch.Tensor:
    """Causal attention core, q (B, S, H, hd), k/v (B, S, Hkv, hd) ->
    (B, S, H, hd). The registry picks the implementation from the shape
    and the tensors' device; a choice other than "xla" runs the flash
    kernel, "xla" runs the plain fp32 einsum twin with the -1e30 mask."""
    impl = cfg.attn_impl or ("kernel" if cfg.use_flash
                             else "xla" if cfg.use_flash is False
                             else "auto")
    if impl != "xla":
        choice = select_attention(
            KIND_PREFILL, impl=impl, seq=q.shape[1], window=cfg.attn_window,
            n_heads=q.shape[2], n_kv_heads=k.shape[2], head_dim=q.shape[3],
            platform=q.device.type)
        if choice.impl != "xla":
            return choice.fn(q, k, v)
    return flash_attention_plain(q, k, v, causal=True,
                                 window=cfg.attn_window)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def layer_block(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
                cos: torch.Tensor, sin: torch.Tensor, attn_core):
    """One transformer layer — the single definition of the architecture
    shared by the batch forward, prefill and the cached decode steps.
    ``attn_core(q, k, v) -> (o, aux)`` supplies the attention inner
    product; ``aux`` carries per-layer state out (K/V for cache fills)."""
    B, S = x.shape[:2]
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    h = rmsnorm(x, lp["ln1"])
    q = (h @ lp["wq"]).reshape(B, S, H, hd)
    k = (h @ lp["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ lp["wv"]).reshape(B, S, Hkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o, aux = attn_core(q, k, v)
    x = x + o.reshape(B, S, cfg.d_model) @ lp["wo"]
    h = rmsnorm(x, lp["ln2"])
    x = x + (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"]
    return x, aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) float32.

    ``attn_fn(q, k, v) -> o`` overrides the attention core, and
    ``positions`` (S,) overrides each slot's RoPE position — the
    reference's hooks, with its meaning. With ``cfg.remat`` and a
    gradient being taken, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes
    it from its input instead of keeping its intermediates."""
    S = tokens.shape[1]
    cos, sin = rope_tables(cfg, S, tokens.device)
    if positions is not None:
        cos, sin = cos[positions], sin[positions]

    def attn_core(q, k, v):
        if attn_fn is not None:
            return attn_fn(q, k, v), None
        return attention(q, k, v, cfg), None

    def layer(x, lp):
        return layer_block(x, lp, cfg, cos, sin, attn_core)[0]

    # unbind, not per-layer indexing: its backward stacks the layers'
    # gradients once instead of scattering each into a zeroed full stack
    stacks = {name: w.unbind(0) for name, w in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = {name: ws[i] for name, ws in stacks.items()}
        x = (checkpoint(layer, x, lp, use_reentrant=False) if remat
             else layer(x, lp))
    return lm_head(params, x)


def loss_fn(params: dict, inputs: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, attn_fn=None,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross entropy of (B, S) targets given (B, S) inputs, from
    fp32 logits through an fp32 log-softmax, as the reference computes
    it. Inputs and targets keep identical shapes (callers shift
    outside)."""
    logits = forward(params, inputs, cfg, attn_fn=attn_fn,
                     positions=positions)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def embed_lookup(e: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return e[tokens]


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + fp32 output projection, shared by forward and
    decode."""
    x = rmsnorm(x, params["norm_f"])
    return x.float() @ params["out"].float()


def param_count(cfg: TransformerConfig) -> int:
    """Exact parameter count of :func:`init_params`' dict."""
    D, F_, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    KD = cfg.kv_dim
    per_layer = 2 * D * D + 2 * D * KD + 3 * D * F_ + 2 * D
    return V * D + L * per_layer + D + D * V


def forward_flops(cfg: TransformerConfig, batch: int, seq: int) -> int:
    """Dense matmul FLOPs of one batch forward (2 per MAC, full S x S
    attention as in the usual MFU convention) — the reference's
    accounting."""
    D, F_, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    KD = cfg.kv_dim
    per_token = L * (4 * D * D + 4 * D * KD + 6 * D * F_ + 4 * seq * D) \
        + 2 * D * V
    return batch * seq * per_token


def kv_cache_bytes_per_token(cfg: TransformerConfig) -> int:
    """K+V cache bytes appended per token per batch row."""
    if cfg.kv_int8:
        return 2 * cfg.n_layers * (cfg.kv_dim + cfg.kv_heads * 4)
    return 2 * cfg.n_layers * cfg.kv_dim * cfg.dtype.itemsize
