"""A dense decoder written out in plain fp32 PyTorch: RMSNorm (fp32,
eps as run), RoPE on the two halves of each head, causal softmax
attention with grouped K/V heads, SwiGLU, an untied fp32 head. Weights
come in the port's stacked layout (:mod:`benchmark.weights`) and are
read one layer at a time, so the whole model never has to exist in
fp32 at once.

``prec`` rounds every matrix-product operand: :func:`exact` keeps fp32
(TF32 is switched off by :func:`fp32_matmul`), :func:`fp8` rounds to
float8 e4m3 with one scale per tensor — the control, the precision
below the configuration's bf16. The rounding passes gradients through
unchanged, so a backward runs through it."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_matmul():
    """fp32 products in full fp32: TF32 off for the block, restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x)


PRECISIONS = {"fp32": exact, "fp8": fp8}


def mm(x: torch.Tensor, w: torch.Tensor, prec=exact) -> torch.Tensor:
    return prec(x) @ prec(w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at absolute positions ``pos`` (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                 None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec=exact, head_chunk: int | None = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, Hkv, hd) at
    the same positions; ``head_chunk`` bounds the score block (no-grad
    use)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    step = head_chunk or H
    outs = []
    for h0 in range(0, H, step):
        qh = q[:, :, h0:h0 + step].transpose(1, 2)
        kh = k[:, :, h0:h0 + step].transpose(1, 2)
        vh = v[:, :, h0:h0 + step].transpose(1, 2)
        s = (prec(qh) @ prec(kh).transpose(-1, -2)) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append((prec(p) @ prec(vh)).transpose(1, 2))
    return torch.cat(outs, dim=2)


def layer(x: torch.Tensor, w: dict, m: dict, pos: torch.Tensor, prec=exact,
          head_chunk: int | None = None) -> torch.Tensor:
    """One decoder layer, x (B, S, D) fp32; ``w`` holds the layer's
    fp32 matrices and norm scales."""
    B, S, D = x.shape
    H, Hkv, hd = m["n_heads"], m["kv_heads"], m["head_dim"]
    h = rmsnorm(x, w["ln1"], m["rms_eps"])
    q = mm(h, w["wq"], prec).reshape(B, S, H, hd)
    k = mm(h, w["wk"], prec).reshape(B, S, Hkv, hd)
    v = mm(h, w["wv"], prec).reshape(B, S, Hkv, hd)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    o = attention(q, k, v, prec, head_chunk).reshape(B, S, D)
    x = x + mm(o, w["wo"], prec)
    h = rmsnorm(x, w["ln2"], m["rms_eps"])
    f = torch.nn.functional.silu(mm(h, w["w1"], prec)) * mm(h, w["w3"], prec)
    return x + mm(f, w["w2"], prec)


def head(x: torch.Tensor, norm_f: torch.Tensor, out: torch.Tensor,
         m: dict, prec=exact) -> torch.Tensor:
    return mm(rmsnorm(x, norm_f, m["rms_eps"]), out, prec)


LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2", "ln1", "ln2")


def layer_weights(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a stacked parameter dict, in fp32."""
    out = {}
    for n in LAYER_LEAVES:
        t = params["layers"][n][i].detach()
        out[n] = t.clone() if t.dtype == torch.float32 else t.float()
    return out
