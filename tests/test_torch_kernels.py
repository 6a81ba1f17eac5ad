"""The port's CUDA kernels (flash forward, flash backward dQ and dK/dV,
paged decode) against their plain-PyTorch twins, on an NVIDIA GPU.
Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a host
without a card. The file imports no JAX, so it runs on a GPU
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.ops import attention  # noqa: E402
from tpushare_torch.workloads.ops import paged_attention  # noqa: E402

# bf16: outputs round once after a tiled online softmax vs an einsum
# chain; fp32: summation order only
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def randn(rng, shape, dtype, dev):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,dtype", [
    (2, 128, 16, 16, 128, "bfloat16"),
    (2, 300, 16, 4, 128, "bfloat16"),
    (1, 77, 4, 2, 64, "float32"),
])
def test_flash_kernel_matches_plain(B, S, H, Hkv, hd, dtype):
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(5)
    q = randn(rng, (B, S, H, hd), dt, dev)
    k, v = (randn(rng, (B, S, Hkv, hd), dt, dev) for _ in range(2))
    before = build.LAUNCHES["flash_fwd"]
    got = attention.flash_attention(q, k, v)
    assert build.LAUNCHES["flash_fwd"] == before + 1
    want = attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,hd", [("bfloat16", 16, 16, 128),
                                            ("float32", 8, 4, 64)])
def test_paged_kernel_matches_plain_with_aliased_tables(dtype, H, Hkv, hd):
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(6)
    B, P, ps, n_pages = 4, 6, 16, 40
    kp, vp = (randn(rng, (n_pages, ps, Hkv, hd), dt, dev) for _ in range(2))
    tables = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    tables[1, :2] = tables[0, :2]          # aliased shared-prefix pages
    tables = torch.from_numpy(tables.astype(np.int32)).to(dev)
    kv_lens = torch.tensor([P * ps, 13, 1, 29], dtype=torch.int32,
                           device=dev)
    q1 = randn(rng, (B, H, hd), dt, dev)
    before = build.LAUNCHES["paged_decode"]
    got = paged_attention.paged_decode(q1, kp, vp, tables, kv_lens)
    assert build.LAUNCHES["paged_decode"] == before + 1
    want = paged_attention.xla_paged_read(q1[:, None], kp, vp, tables,
                                          kv_lens, H, Hkv)[:, 0]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # a narrowed read (the engine's power-of-two rung) passes a column
    # slice of the table: same answer for lanes it covers
    narrow = tables[:, :2]
    lens2 = kv_lens.clamp(max=2 * ps)
    got2 = paged_attention.paged_decode(q1, kp, vp, narrow, lens2)
    want2 = paged_attention.xla_paged_read(q1[:, None], kp, vp,
                                           narrow.contiguous(), lens2,
                                           H, Hkv)[:, 0]
    torch.testing.assert_close(got2.float(), want2.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("plen", [32, 77])
def test_generate_prefills_an_untiled_prompt_through_the_kernel(plen):
    """``decode.generate`` (what ``infer --mode decode`` runs) prefills a
    prompt of any length with the flash kernel — one launch per layer —
    and the greedy tokens match the plain-attention prefill in fp32."""
    import dataclasses

    from tpushare_torch.workloads.decode import generate
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    dev = card()
    cfg = TransformerConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=256, max_seq=256,
                            dtype=torch.float32)
    params = init_params(torch.Generator(device=dev).manual_seed(7), cfg, dev)
    prompt = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (2, plen))).to(dev)
    before = build.LAUNCHES["flash_fwd"]
    got = generate(params, prompt, cfg, 8)
    assert build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    want = generate(params, prompt, dataclasses.replace(cfg, attn_impl="xla"),
                    8)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take():
    dev = card()
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="causal"):
        attention.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), q, q)


# ---------------------------------------------------------------------------
# the flash backward (K2 dQ, K3 dK/dV) and the forward's LSE and window
# ---------------------------------------------------------------------------

BWD_CASES = [  # B, S, H, Hkv, hd, dtype, causal, window
    (2, 128, 4, 4, 64, "float32", True, None),
    (2, 300, 4, 2, 96, "float32", True, None),      # partial tile, GQA
    (2, 200, 4, 2, 16, "float32", True, 48),        # window, payload hd
    (1, 130, 4, 1, 32, "float32", False, None),     # full attention
    (2, 256, 8, 2, 128, "bfloat16", True, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,dtype,causal,window", BWD_CASES)
def test_flash_backward_kernels_match_plain(B, S, H, Hkv, hd, dtype, causal,
                                            window):
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(8)
    q, do = (randn(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    k, v = (randn(rng, (B, S, Hkv, hd), dt, dev) for _ in range(2))
    before = dict(build.LAUNCHES)
    o, lse = attention.flash_attention_fwd(q, k, v, causal, window,
                                           with_lse=True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    assert {n: build.LAUNCHES[n] - before[n] for n in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    po, plse = attention.flash_attention_plain(q, k, v, causal, window,
                                               with_lse=True)
    want = attention.flash_attention_bwd_plain(q, k, v, po, plse, do, causal,
                                               window)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=TOL[dtype] * scale, rtol=TOL[dtype])


@pytest.mark.cuda
def test_training_backward_runs_the_kernels():
    """Autograd through ``flash_attention`` on the card: one LSE forward,
    one dQ and one dK/dV launch, and the plain twins' gradients."""
    dev = card()
    rng = np.random.default_rng(9)
    q = randn(rng, (2, 96, 4, 32), torch.float32, dev).requires_grad_()
    k = randn(rng, (2, 96, 2, 32), torch.float32, dev).requires_grad_()
    v = randn(rng, (2, 96, 2, 32), torch.float32, dev).requires_grad_()
    do = randn(rng, (2, 96, 4, 32), torch.float32, dev)
    before = dict(build.LAUNCHES)
    got = torch.autograd.grad(attention.flash_attention(q, k, v, window=40),
                              (q, k, v), do)
    assert build.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert build.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = torch.autograd.grad(
        attention.flash_attention_plain(q, k, v, window=40), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
