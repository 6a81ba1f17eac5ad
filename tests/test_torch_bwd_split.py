"""The bf16 flash backward kernels' algebra, emulated in plain PyTorch on
the CPU.

The bf16 rungs of ``kernels/flash_bwd.cu`` (K2 dQ, K3 dK/dV) run every
product on tensor cores over bf16 operands with fp32 accumulators:

    S = Q K^T, dP = dO V^T             (bf16 inputs, fp32 sums)
    P = 2^(s c - lse log2 e)           c = log2(e) x the softmax scale;
                                       0 where the mask drops a pair
    dS = P o (dP - delta)
    dQ = scale dS K,  dV = P^T dO,  dK = scale dS^T Q

P and dS are formed in fp32 registers, but a tensor-core product takes
bf16 operands. The reference keeps both in fp32 for the three gradient
products (``tpushare/workloads/ops/attention.py`` ``_dq_kernel`` and
``_dkv_kernel``), so the kernels split each into two bf16 halves, hi =
bf16(x) and lo = bf16(x - hi), and multiply both by the same operand:
about 16 significant bits where one rounding keeps 8. A CUDA kernel has
no CPU mode, so this file replays that algebra and holds it to the plain
twin (``flash_attention_bwd_plain``) at the limit the on-card check uses
(``chip_smoke.BWD_TOL``): 1e-2 of each gradient's largest magnitude.
The control, the emulated gradients rounded to 4 significant bits
(``chip_smoke.CONTROL_BITS_BWD``), must fail it.

P and dS rounded once to bf16 (no lo half) also pass the limit on these
shapes, but use up to 57% of it: max |error| over each gradient's scale,
the worst of dq / dk / dv, reads 0.0049 at S=1024 with 4 heads of 96,
0.0052 with GQA 4:1, 0.0038 with a window of 256, 0.0034 for full
attention, 0.0053 at S=300 and 0.0057 at hd 16, where the split reads
0.0016, 0.0022, 0.0009, 0.0017, 0.0013 and 0.0012: the output's own
bf16 rounding. Those readings are recorded, not asserted; run this file
as a script to print them:

    PYTHONPATH=. python tests/test_torch_bwd_split.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads.ops.attention import (  # noqa: E402
    bwd_delta, flash_attention_bwd_plain, flash_attention_plain)

LOG2E = 1.4426950408889634
# the on-card backward check: max |error| as a share of each gradient's
# largest magnitude, and the rounding control that must fail it
BWD_TOL = 1e-2
CONTROL_BITS = 4


def split(x):
    """x as two bf16 halves, each back in fp32: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def split_matmul(a, b, halves=2):
    """a b with a split into two bf16 halves and b already bf16 (exact in
    fp32), summed in fp32: the kernels' two mma.sync on one B fragment.
    ``halves=1``: a rounded once to bf16 instead."""
    hi, lo = split(a)
    return hi @ b + lo @ b if halves == 2 else hi @ b


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


def emulate(q, k, v, do, o, lse, causal, window, halves=2):
    """The bf16 kernels' algebra over (B, S, H|Hkv, hd) bf16 tensors:
    (dq, dk, dv) in the inputs' dtype, dK and dV summed over each
    query-head group. ``halves=1``: P and dS rounded once to bf16."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = hd ** -0.5
    c = torch.tensor(LOG2E * scale, dtype=torch.float32)
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))
    kf, vf = (x.float().repeat_interleave(group, 2).transpose(1, 2)
              for x in (k, v))
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * c - (lse * LOG2E)[..., None])
    keep = keep_mask(S, causal, window)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - bwd_delta(do, o)[..., None])
    dq = split_matmul(ds, kf, halves) * scale
    dk = split_matmul(ds.transpose(-1, -2), qf, halves) * scale
    dv = split_matmul(p.transpose(-1, -2), dof, halves)
    dk, dv = (x.transpose(1, 2).reshape(B, S, Hkv, group, hd).sum(3)
              for x in (dk, dv))
    return dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def round_to_bits(x, bits):
    """x rounded to ``bits`` significant bits (bf16 keeps 8)."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e)


def rel_errs(got, want):
    """max |got - want| over max |want|, per gradient."""
    return [(g.float() - w.float()).abs().max().item()
            / w.float().abs().max().item() for g, w in zip(got, want)]


CASES = [  # B, S, H, Hkv, hd, causal, window
    (1, 1024, 4, 4, 96, True, None),     # the train shape's head width
    (1, 1024, 4, 1, 96, True, None),     # GQA 4:1
    (1, 1024, 4, 4, 96, True, 256),      # the window band
    (1, 512, 4, 4, 96, False, None),     # full attention
    (2, 300, 4, 2, 96, True, None),      # S past the last tile
    (4, 64, 4, 4, 16, True, None),       # the payload's heads
]


def case_id(case):
    B, S, H, Hkv, hd, causal, window = case
    return (f"B{B}-S{S}-{H}:{Hkv}x{hd}{'' if causal else '-full'}"
            f"{f'-w{window}' if window else ''}")


def run(case, halves=2):
    """(emulated gradients, the twin's gradients) on one case's seeded
    bf16 inputs, both fed the plain forward's o and lse."""
    B, S, H, Hkv, hd, causal, window = case
    rng = np.random.default_rng(CASES.index(case))

    def rn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()
    q, k, v, do = rn(B, S, H, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd), \
        rn(B, S, H, hd)
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   with_lse=True)
    got = emulate(q, k, v, do, o, lse, causal, window, halves)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    return got, want


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_split_p_and_ds_emulation_matches_the_plain_twin(case):
    got, want = run(case)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all()
    assert max(rel_errs(got, want)) <= BWD_TOL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_four_bit_control_fails_the_limit(case):
    """The emulated gradients rounded to 4 significant bits land above the
    limit: the check tells a backward that loses precision."""
    got, want = run(case)
    assert max(rel_errs([round_to_bits(g, CONTROL_BITS) for g in got],
                        want)) > BWD_TOL


if __name__ == "__main__":
    # the readings the docstring records: the worst of dq / dk / dv over
    # each gradient's scale, split, rounded once, and the 4-bit control
    for case in CASES:
        split_got, want = run(case)
        once, _ = run(case, halves=1)
        control = [round_to_bits(g, CONTROL_BITS) for g in split_got]
        print(f"{case_id(case)}: split {max(rel_errs(split_got, want)):.4f} "
              f"once {max(rel_errs(once, want)):.4f} "
              f"4-bit {max(rel_errs(control, want)):.4f}")
