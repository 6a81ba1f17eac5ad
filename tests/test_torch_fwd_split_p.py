"""The bf16 forward kernels' algebra, emulated in plain PyTorch on the CPU.

The bf16 rungs of ``kernels/flash_fwd.cu`` (K1) and
``kernels/splash_fwd.cu`` (K6-fwd) share one tensor-core tile body
(``kernels/attn_fwd_tile.cuh``): per 64-key tile, fp32 scores of bf16
operands, dropped scores at -inf, an online row max, P = 2^(s c - m c)
with c = log2(e) x the softmax scale, and O += P V with P split into
two bf16 halves, hi = bf16(p) and lo = bf16(p - hi). A CUDA kernel has
no CPU mode, so this file replays that algebra tile by tile and holds it
to the plain twins (``flash_attention_plain``, ``splash_attention_plain``)
element by element, at the limit the on-card check uses: 1e-2 of
max(|value|, 2^-8 x the output's largest |value|). The control, P
rounded once to bf16 as FlashAttention-2 does, must fail that limit:
the split is what lets the kernels keep the reference's fp32-P
precision.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads.ops.attention import (  # noqa: E402
    NEG_INF, flash_attention_plain)
from tpushare_torch.workloads.ops.splash_attention import (  # noqa: E402
    MASK_VALUE, prescale, splash_attention_plain)

BN = 64                       # keys per tile, as the kernels stream them
LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
# the on-card forward check (chip_smoke.FWD_TOL, FWD_FLOOR): element by
# element, one bf16 rounding of the output on each side
FWD_TOL = 1e-2
FWD_FLOOR = 2 ** -8
LSE_TOL = 1e-4


def elem_rel_err(got, want) -> float:
    want = want.float()
    floor = FWD_FLOOR * want.abs().max()
    return ((got.float() - want).abs()
            / torch.maximum(want.abs(), floor)).max().item()


def emulate(q, k, v, *, scale, m0, keep, split=True):
    """The tile body's algebra over (B, S, H|Hkv, hd) bf16 tensors: o in
    q's dtype and the fp32 (B, H, S) LSE. ``keep``: (S, S) bool of live
    (query, key) pairs, or None; ``split``: P as hi + lo (the kernels)
    or rounded once to bf16 (the control)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(group, 2).transpose(1, 2)
              for x in (k, v))
    c = torch.tensor(LOG2E * scale, dtype=torch.float32)
    m = torch.full((B, H, S, 1), m0, dtype=torch.float32)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, BN):
        s = qf @ kf[:, :, k0:k0 + BN].transpose(-1, -2)
        if keep is not None:
            s = s.masked_fill(~keep[:, k0:k0 + BN], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        mc = (m_new * c).clamp(min=-FLT_MAX)   # the mask value's overflows
        p = torch.exp2(s * c - mc)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + BN]
        if split:
            hi = p.bfloat16().float()
            pv = hi @ vt + (p - hi).bfloat16().float() @ vt
        else:
            pv = p.bfloat16().float() @ vt
        o = o * corr + pv
        m = m_new
    lse = (m * scale + torch.log(l))[..., 0]
    return (o / l).transpose(1, 2).to(q.dtype), lse


def inputs(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return rn(B, S, H, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd)


def keep_mask(S, causal, window):
    """(S, S) bool of live (query, key) pairs, or None for full
    attention."""
    if not causal:
        return None
    ids = torch.arange(S)
    keep = ids[None, :] <= ids[:, None]
    if window is not None:
        keep &= ids[None, :] > ids[:, None] - window
    return keep


def run(case, split=True):
    """(emulated o, emulated lse, twin o, twin lse) for one case."""
    kind, B, S, H, Hkv, hd, causal, window = case
    q, k, v = inputs(CASES.index(case), B, S, H, Hkv, hd)
    if kind == "splash":
        qs = prescale(q)
        got = emulate(qs, k, v, scale=1.0, m0=MASK_VALUE,
                      keep=keep_mask(S, True, None), split=split)
        want = splash_attention_plain(qs, k, v, with_lse=True)
    else:
        got = emulate(q, k, v, scale=hd ** -0.5, m0=NEG_INF,
                      keep=keep_mask(S, causal, window), split=split)
        want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                     with_lse=True)
    return (*got, *want)


CASES = [  # kind, B, S, H, Hkv, hd, causal, window
    ("flash", 2, 1024, 8, 8, 96, True, None),     # the train shape's heads
    ("flash", 1, 1024, 8, 2, 96, True, None),     # GQA
    ("flash", 1, 1024, 8, 8, 96, True, 256),      # the window band
    ("flash", 1, 512, 8, 8, 128, False, None),    # full attention
    ("flash", 2, 300, 4, 4, 128, True, None),     # S past the last tile
    ("flash", 2, 77, 4, 2, 64, True, None),
    ("flash", 4, 64, 8, 8, 16, True, None),
    ("flash", 1, 256, 4, 4, 32, True, None),
    ("splash", 1, 2048, 8, 8, 128, True, None),   # long-context heads
    ("splash", 1, 512, 2, 2, 256, True, None),
]


def case_id(case):
    kind, B, S, H, Hkv, hd, causal, window = case
    return (f"{kind}-B{B}-S{S}-{H}:{Hkv}x{hd}"
            f"{'' if causal else '-full'}{f'-w{window}' if window else ''}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_split_p_emulation_matches_the_plain_twin(case):
    got, lse, want, want_lse = run(case)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert elem_rel_err(got, want) <= FWD_TOL
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bf16_p_control_fails_the_limit(case):
    """P rounded once to bf16 errs by up to 2^-9 of each term of P V; near
    the floor, where terms cancel, that is far above the limit."""
    got, _, want, _ = run(case, split=False)
    assert elem_rel_err(got, want) > FWD_TOL
