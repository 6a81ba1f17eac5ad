"""The port's CUDA kernels (flash forward, flash backward dQ and dK/dV,
paged decode and ragged decode, each decode read with its int8 rung,
splash forward, dQ and dK/dV) against their plain-PyTorch twins, on an
NVIDIA GPU.
Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a host
without a card. The file imports no JAX, so it runs on a GPU
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -q -m cuda
"""

import re
import shutil

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
    (4, 77, 8, 8, 16, "bfloat16", True, None),      # payload hd, S = 77
    (2, 200, 4, 2, 32, "bfloat16", True, 48),       # window, hd 32
    (2, 77, 4, 1, 64, "bfloat16", False, None),     # full, GQA 4:1, S = 77
    (2, 300, 8, 2, 96, "bfloat16", False, None),    # full, partial tile
    (1, 1024, 16, 4, 96, "bfloat16", True, None),   # train heads, GQA 16:4
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
@pytest.mark.parametrize("B,S,H,Hkv,hd,dtype,causal,window",
                         [c for c in BWD_CASES if c[5] == "bfloat16"])
def test_flash_backward_kernels_are_deterministic(B, S, H, Hkv, hd, dtype,
                                                  causal, window):
    """No atomics and a fixed order of sums, the GQA group's included: two
    launches on the same inputs give the same bits."""
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(18)
    q, do = (randn(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    k, v = (randn(rng, (B, S, Hkv, hd), dt, dev) for _ in range(2))
    o, lse = attention.flash_attention_fwd(q, k, v, causal, window,
                                           with_lse=True)
    delta = attention.bwd_delta(do, o)

    def launch():
        return (attention.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                       window),
                *attention.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         window))
    first, second = launch(), launch()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# the ragged decode read (K4)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv", [("bfloat16", 16, 16),
                                         ("bfloat16", 16, 4),
                                         ("float32", 8, 1)])
def test_ragged_kernel_matches_plain(dtype, H, Hkv):
    """The ragged kernel against its twin on a stacked cache, one slot at
    length 0 (one live row) and one at S - 1; the same live rows in a
    larger cache give a bitwise-equal result."""
    from tpushare_torch.workloads.ops import ragged_decode
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(10)
    L, B, S, hd = 2, 4, 512, 128
    q = randn(rng, (B, H, hd), dt, dev)
    k, v = (randn(rng, (L, B, S, Hkv, hd), dt, dev) for _ in range(2))
    lengths = torch.tensor([0, 37, 300, S - 1], dtype=torch.int32,
                           device=dev)
    before = build.LAUNCHES["ragged_decode"]
    got = ragged_decode.ragged_decode_attention(q, k, v, lengths, layer=1)
    assert build.LAUNCHES["ragged_decode"] == before + 1
    want = ragged_decode.ragged_decode_plain(q, k, v, lengths, layer=1)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    big_k = torch.zeros((B, 2 * S, Hkv, hd), dtype=dt, device=dev)
    big_v = torch.zeros_like(big_k)
    big_k[:, :S], big_v[:, :S] = k[1], v[1]
    again = ragged_decode.ragged_decode_attention(q, big_k, big_v, lengths)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_ragged_wrapper_rejects_what_the_kernel_cannot_take():
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    lengths = torch.zeros((2,), dtype=torch.int32, device=dev)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ragged_decode.ragged_decode_attention(q, k, k, lengths)
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 16, 4, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        ragged_decode.ragged_decode_attention(q, k, k, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        ragged_decode.ragged_decode_attention(
            q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lengths)


# ---------------------------------------------------------------------------
# the int8 rungs of the paged (K5) and ragged (K4) reads
# ---------------------------------------------------------------------------

# the limits chip_smoke.py holds the rungs to: absolute + relative at
# TOL, then element by element as a share of max(|value|, 2^-8 x the
# largest |value|) at INT8_TOL. The rung folds the scales into score and
# probability where the twin dequantizes first (or walks the rows in
# another order), so the two differ in fp32 rounding, then once in the
# output's rounding. The output rounded to INT8_CONTROL_BITS significant
# bits (8 is bf16's precision) must fail the element-wise limit. Sound
# readings on an H100 at the smoke's shapes: bf16 <= 0.0077, fp32
# 8.49e-5 (K5) and 1.0021e-4 (K4, 4096 rows); controls >= 0.0154 (6
# bits) and >= 3.8e-3 (8 bits).
INT8_TOL = {"bfloat16": 1e-2, "float32": 2e-4}
INT8_CONTROL_BITS = {"bfloat16": 6, "float32": 8}


def int8_leaf(rng, shape, dev):
    from tpushare_torch.workloads.decode import kv_quantize
    return kv_quantize(randn(rng, shape, torch.float32, dev))


def elem_share(got, want):
    want = want.float()
    floor = 2 ** -8 * want.abs().max()
    return ((got.float() - want).abs()
            / torch.maximum(want.abs(), floor)).max().item()


def assert_int8_rung_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert elem_share(got, want) <= INT8_TOL[dtype]
    m, e = torch.frexp(got.float())
    bits = 2 ** INT8_CONTROL_BITS[dtype]
    control = torch.ldexp(torch.round(m * bits) / bits, e)
    assert elem_share(control, want) > INT8_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,hd", [("bfloat16", 16, 16, 128),
                                            ("bfloat16", 16, 4, 128),
                                            ("float32", 8, 4, 64)])
def test_paged_int8_rung_matches_plain_with_aliased_tables(dtype, H, Hkv,
                                                           hd):
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(16)
    B, P, ps, n_pages = 4, 6, 16, 40
    kp, vp = (int8_leaf(rng, (n_pages, ps, Hkv, hd), dev) for _ in range(2))
    tables = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    tables[1, :2] = tables[0, :2]          # aliased shared-prefix pages
    tables = torch.from_numpy(tables.astype(np.int32)).to(dev)
    kv_lens = torch.tensor([P * ps, 13, 1, 29], dtype=torch.int32,
                           device=dev)
    q1 = randn(rng, (B, H, hd), dt, dev)
    before = dict(build.LAUNCHES)
    got = paged_attention.paged_decode(q1, kp, vp, tables, kv_lens)
    assert build.LAUNCHES["paged_decode_int8"] == \
        before["paged_decode_int8"] + 1
    assert build.LAUNCHES["paged_decode"] == before["paged_decode"]
    want = paged_attention.xla_paged_read(q1[:, None], kp, vp, tables,
                                          kv_lens, H, Hkv)[:, 0]
    assert_int8_rung_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv", [("bfloat16", 16, 16),
                                         ("bfloat16", 16, 4),
                                         ("float32", 8, 1)])
def test_ragged_int8_rung_matches_plain(dtype, H, Hkv):
    """The int8 rung against its twin on a stacked codec cache, one slot
    at length 0 and one at S - 1; the same live rows in a larger cache
    give a bitwise-equal result."""
    from tpushare_torch.workloads.decode import kv_view
    from tpushare_torch.workloads.ops import ragged_decode
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(17)
    L, B, S, hd = 2, 4, 512, 128
    q = randn(rng, (B, H, hd), dt, dev)
    k, v = (int8_leaf(rng, (L, B, S, Hkv, hd), dev) for _ in range(2))
    lengths = torch.tensor([0, 37, 300, S - 1], dtype=torch.int32,
                           device=dev)
    before = dict(build.LAUNCHES)
    got = ragged_decode.ragged_decode_attention(q, k, v, lengths, layer=1)
    assert build.LAUNCHES["ragged_decode_int8"] == \
        before["ragged_decode_int8"] + 1
    assert build.LAUNCHES["ragged_decode"] == before["ragged_decode"]
    want = ragged_decode.ragged_decode_plain(q, k, v, lengths, layer=1)
    assert_int8_rung_close(got, want, dtype)
    big = {}
    for name, leaf in (("k", kv_view(k, 1)), ("v", kv_view(v, 1))):
        big[name] = {"q": torch.zeros((B, 2 * S, Hkv, hd), dtype=torch.int8,
                                      device=dev),
                     "s": torch.ones((B, 2 * S, Hkv), device=dev)}
        big[name]["q"][:, :S], big[name]["s"][:, :S] = leaf["q"], leaf["s"]
    again = ragged_decode.ragged_decode_attention(q, big["k"], big["v"],
                                                  lengths)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_int8_wrappers_reject_what_the_rungs_cannot_take():
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    rng = np.random.default_rng(18)
    q = randn(rng, (2, 4, 128), torch.bfloat16, dev)
    k = int8_leaf(rng, (2, 16, 4, 128), dev)
    lengths = torch.zeros((2,), dtype=torch.int32, device=dev)
    bad = {"q": k["q"], "s": k["s"].double()}
    with pytest.raises(ValueError, match="scales"):
        ragged_decode.ragged_decode_attention(q, bad, k, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_decode.ragged_decode_attention(
            q, {"q": k["q"], "s": k["s"].transpose(1, 2).contiguous()
                .transpose(1, 2)}, k, lengths)
    pool = int8_leaf(rng, (5, 8, 4, 128), dev)
    tables = torch.ones((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="scales"):
        paged_attention.paged_decode(q, pool, {"q": pool["q"],
                                               "s": pool["s"][:4]},
                                     tables, lengths + 1)


# ---------------------------------------------------------------------------
# the ragged read's split: chunk edges, stragglers, determinism, counts
# ---------------------------------------------------------------------------

# the smoke's element-wise limits for the ragged rows (FWD_TOL)
RAGGED_ELEM_TOL = {"bfloat16": 1e-2, "float32": 1e-3}


def ragged_case(rng, dev, dtype, S, H, Hkv, lengths, int8):
    """q (B, H, 128) and (B, S, Hkv, 128) caches of ``dtype`` (int8
    ``{q, s}`` leaves with ``int8``), B = len(lengths)."""
    B = len(lengths)
    q = randn(rng, (B, H, 128), getattr(torch, dtype), dev)
    if int8:
        k, v = (int8_leaf(rng, (B, S, Hkv, 128), dev) for _ in range(2))
    else:
        k, v = (randn(rng, (B, S, Hkv, 128), getattr(torch, dtype), dev)
                for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def assert_ragged_close(got, want, dtype, int8):
    if int8:
        assert_int8_rung_close(got, want, dtype)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert elem_share(got, want) <= RAGGED_ELEM_TOL[dtype]


def slot(leaf, b):
    """Slot b of a cache leaf, kept as a batch of one."""
    if isinstance(leaf, dict):
        return {p: x[b:b + 1].contiguous() for p, x in leaf.items()}
    return leaf[b:b + 1].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,H,Hkv", [("bfloat16", 16, 16),
                                         ("bfloat16", 16, 4),
                                         ("bfloat16", 16, 2),
                                         ("float32", 8, 1)])
def test_ragged_rungs_at_the_chunk_edges(dtype, H, Hkv, int8):
    """Live rows ending just inside, at and just past a chunk boundary
    (lengths are inclusive: length C - 1 is one full chunk), against the
    twin; every group size, so both lane layouts of the int8 rung."""
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    C = ragged_decode.CHUNK_ROWS
    S = 4 * C
    lengths = [0, C - 2, C - 1, C, C + 1, 2 * C - 1, 3 * C, S - 1]
    q, k, v, lens = ragged_case(np.random.default_rng(40), dev, dtype, S, H,
                                Hkv, lengths, int8)
    got = ragged_decode.ragged_decode_attention(q, k, v, lens)
    assert_ragged_close(got, ragged_decode.ragged_decode_plain(q, k, v, lens),
                        dtype, int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_ragged_straggler_slot_is_read_whole_and_alone(int8):
    """One slot at S - 1 and the others short, at S=4096 with GQA 16:4:
    the batch matches the twin, and each slot's output equals, bit for
    bit, that slot read alone — no slot depends on its neighbours."""
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    rng = np.random.default_rng(41)
    S = 4096
    lengths = [0, S - 1, *rng.integers(1, 400, size=6).tolist()]
    q, k, v, lens = ragged_case(rng, dev, "bfloat16", S, 16, 4, lengths,
                                int8)
    got = ragged_decode.ragged_decode_attention(q, k, v, lens)
    assert_ragged_close(got, ragged_decode.ragged_decode_plain(q, k, v, lens),
                        "bfloat16", int8)
    for b in range(len(lengths)):
        alone = ragged_decode.ragged_decode_attention(
            q[b:b + 1].contiguous(), slot(k, b), slot(v, b), lens[b:b + 1])
        assert torch.equal(got[b:b + 1], alone), b


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,H,Hkv", [("bfloat16", 16, 4),
                                         ("float32", 16, 16)])
def test_ragged_rungs_are_deterministic(dtype, H, Hkv, int8):
    """No atomics, a fixed order in every sum: two launches on the same
    inputs give the same bits."""
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    S = 2048
    lengths = [S - 1, 0, 700, 1500]
    q, k, v, lens = ragged_case(np.random.default_rng(42), dev, dtype, S, H,
                                Hkv, lengths, int8)
    first = ragged_decode.ragged_decode_attention(q, k, v, lens)
    second = ragged_decode.ragged_decode_attention(q, k, v, lens)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_one_ragged_call_counts_one_launch(int8):
    """One wrapper call adds exactly one to its counter and nothing to
    any other, with the combine (many chunks) and without it (one chunk
    covers S); the one-chunk output equals the combine's bit for bit."""
    from tpushare_torch.workloads.ops import ragged_decode
    dev = card()
    C = ragged_decode.CHUNK_ROWS
    name = "ragged_decode_int8" if int8 else "ragged_decode"
    lengths = [0, C // 2, C - 1]
    q, k, v, lens = ragged_case(np.random.default_rng(43), dev, "bfloat16",
                                4 * C, 16, 4, lengths, int8)
    outs = []
    for S in (C, 4 * C):
        kS, vS = ({p: x[:, :S].contiguous() for p, x in leaf.items()}
                  if int8 else leaf[:, :S].contiguous() for leaf in (k, v))
        before = dict(build.LAUNCHES)
        outs.append(ragged_decode.ragged_decode_attention(q, kS, vS, lens))
        assert build.LAUNCHES == {**before, name: before[name] + 1}
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the paged read's split: chunk edges, page sizes, stragglers, table
# widths, determinism, counts, empty lanes
# ---------------------------------------------------------------------------

def paged_case(rng, dev, dtype, H, Hkv, hd, ps, P, lengths, int8):
    """q1 (B, H, hd), K/V pools of distinct pages (int8 ``{q, s}``
    leaves with ``int8``), (B, P) tables with lane 1's first half aliased
    onto lane 0's, kv_lens; B = len(lengths)."""
    B = len(lengths)
    n_pages = B * P + 1
    shape = (n_pages, ps, Hkv, hd)
    if int8:
        kp, vp = (int8_leaf(rng, shape, dev) for _ in range(2))
    else:
        kp, vp = (randn(rng, shape, getattr(torch, dtype), dev)
                  for _ in range(2))
    tables = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    tables[1, :P // 2] = tables[0, :P // 2]
    tables = torch.from_numpy(tables.astype(np.int32)).to(dev)
    q1 = randn(rng, (B, H, hd), getattr(torch, dtype), dev)
    kv_lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q1, kp, vp, tables, kv_lens


def paged_twin(q1, kp, vp, tables, kv_lens):
    Hkv = (kp["q"] if isinstance(kp, dict) else kp).shape[2]
    return paged_attention.xla_paged_read(q1[:, None], kp, vp, tables,
                                          kv_lens, q1.shape[1], Hkv)[:, 0]


def lane(leaf, b):
    """Lane b of a per-lane tensor, kept as a batch of one."""
    return leaf[b:b + 1].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,H,Hkv,hd", [
    ("bfloat16", 16, 16, 128), ("float32", 8, 8, 64),      # G = 1
    ("bfloat16", 16, 8, 64), ("float32", 8, 4, 128),       # G = 2
    ("bfloat16", 16, 4, 128), ("bfloat16", 16, 4, 64),     # G = 4
    ("float32", 16, 2, 128), ("bfloat16", 8, 1, 64),       # G = 8
])
def test_paged_rungs_at_the_chunk_edges(dtype, H, Hkv, hd, int8):
    """Live rows ending just inside, at and just past a chunk boundary,
    and the table's whole width, against the twin: every group size and
    both head dims, so every lane layout of both rungs."""
    dev = card()
    C, ps = paged_attention.CHUNK_ROWS, 16
    P = 3 * C // ps
    lengths = [1, C - 1, C, C + 1, 2 * C - 1, 2 * C + 1, P * ps, 7]
    case = paged_case(np.random.default_rng(50), dev, dtype, H, Hkv, hd, ps,
                      P, lengths, int8)
    got = paged_attention.paged_decode(*case)
    assert_ragged_close(got, paged_twin(*case), dtype, int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("ps", [16, 32, 24, 1, 1024])
def test_paged_rungs_at_any_page_size(ps, int8):
    """Page sizes that divide the chunk and ones that do not (a chunk
    then starts mid-page), down to one row a page and up to pages longer
    than a chunk, with lane 1's first pages aliased onto lane 0's."""
    dev = card()
    C = paged_attention.CHUNK_ROWS
    P = -(-(2 * C + 5) // ps)
    lengths = [P * ps, C + 1, C, 3, C - 1, 2 * C + 5]
    case = paged_case(np.random.default_rng(51), dev, "bfloat16", 16, 4,
                      128, ps, P, lengths, int8)
    got = paged_attention.paged_decode(*case)
    assert_ragged_close(got, paged_twin(*case), "bfloat16", int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_paged_straggler_lane_is_read_whole_and_alone(int8):
    """One lane at 16384 rows among short ones: the batch matches the
    twin, and each lane's output equals, bit for bit, that lane read
    alone (B = 1) through its own table row — no lane depends on its
    neighbours."""
    dev = card()
    rng = np.random.default_rng(52)
    ps, P = 32, 512
    lengths = [P * ps, *rng.integers(1, 1024, size=7).tolist()]
    q1, kp, vp, tables, kv_lens = paged_case(rng, dev, "bfloat16", 16, 4,
                                             128, ps, P, lengths, int8)
    got = paged_attention.paged_decode(q1, kp, vp, tables, kv_lens)
    assert_ragged_close(got, paged_twin(q1, kp, vp, tables, kv_lens),
                        "bfloat16", int8)
    for b in range(len(lengths)):
        alone = paged_attention.paged_decode(lane(q1, b), kp, vp,
                                             lane(tables, b),
                                             lane(kv_lens, b))
        assert torch.equal(got[b:b + 1], alone), b


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,H,Hkv,hd", [("bfloat16", 16, 16, 128),
                                            ("float32", 8, 1, 64)])
def test_paged_narrow_and_wide_tables_read_the_same_bits(dtype, H, Hkv, hd,
                                                         int8):
    """The engine narrows the table to a power-of-two rung over the
    longest live lane (a column slice, its row stride the wide table's):
    the same lanes read through the narrow rung, a contiguous copy of it
    and the whole table give bitwise-equal outputs, one chunk or many."""
    dev = card()
    C, ps = paged_attention.CHUNK_ROWS, 32
    P = 4 * C // ps
    lengths = [C + 1, 1, C, 2 * C - 3, 5, C - 1]
    q1, kp, vp, tables, kv_lens = paged_case(
        np.random.default_rng(53), dev, dtype, H, Hkv, hd, ps, P, lengths,
        int8)
    wide = paged_attention.paged_decode(q1, kp, vp, tables, kv_lens)
    assert_ragged_close(wide, paged_twin(q1, kp, vp, tables, kv_lens),
                        dtype, int8)
    for width in (2 * C // ps, 3 * C // ps):
        narrow = tables[:, :width]
        assert torch.equal(paged_attention.paged_decode(
            q1, kp, vp, narrow, kv_lens), wide), width
        assert torch.equal(paged_attention.paged_decode(
            q1, kp, vp, narrow.contiguous(), kv_lens), wide), width
    # lanes of at most one chunk, through a one-chunk table (pass 1
    # writes o, no combine) and the wide one (the combine of one chunk)
    short = kv_lens.clamp(max=C)
    assert torch.equal(
        paged_attention.paged_decode(q1, kp, vp, tables[:, :C // ps], short),
        paged_attention.paged_decode(q1, kp, vp, tables, short))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,H,Hkv", [("bfloat16", 16, 4),
                                         ("float32", 16, 16)])
def test_paged_rungs_are_deterministic(dtype, H, Hkv, int8):
    """No atomics, a fixed order in every sum: two launches on the same
    inputs give the same bits."""
    dev = card()
    ps, P = 32, 64
    lengths = [P * ps, 1, 700, 1500]
    case = paged_case(np.random.default_rng(54), dev, dtype, H, Hkv, 128, ps,
                      P, lengths, int8)
    first = paged_attention.paged_decode(*case)
    second = paged_attention.paged_decode(*case)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_one_paged_call_counts_one_launch(int8):
    """One wrapper call adds exactly one to its counter and nothing to
    any other, with the combine (a table of many chunks) and without it
    (one chunk covers the table)."""
    dev = card()
    C, ps = paged_attention.CHUNK_ROWS, 32
    name = "paged_decode_int8" if int8 else "paged_decode"
    q1, kp, vp, tables, kv_lens = paged_case(
        np.random.default_rng(55), dev, "bfloat16", 16, 4, 128, ps,
        4 * C // ps, [3, C // 2, C - 1], int8)
    for width in (C // ps, 4 * C // ps):
        before = dict(build.LAUNCHES)
        paged_attention.paged_decode(q1, kp, vp, tables[:, :width], kv_lens)
        assert build.LAUNCHES == {**before, name: before[name] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_a_paged_lane_with_no_live_row_writes_zeros(int8):
    """kv_lens 0 (the engine never issues one) writes zeros, with one
    chunk and with many, and leaves the other lanes as they were."""
    dev = card()
    C, ps = paged_attention.CHUNK_ROWS, 32
    q1, kp, vp, tables, kv_lens = paged_case(
        np.random.default_rng(56), dev, "bfloat16", 16, 4, 128, ps,
        4 * C // ps, [C + 7, 0, 300], int8)
    for width in (C // ps, 4 * C // ps):
        got = paged_attention.paged_decode(q1, kp, vp, tables[:, :width],
                                           kv_lens)
        assert torch.equal(got[1], torch.zeros_like(got[1])), width
        assert torch.isfinite(got.float()).all(), width
        for b in (0, 2):
            alone = paged_attention.paged_decode(
                lane(q1, b), kp, vp, lane(tables[:, :width], b),
                lane(kv_lens, b))
            assert torch.equal(got[b:b + 1], alone), (width, b)


# ---------------------------------------------------------------------------
# splash (K6-fwd, K6-dq, K6-dkv)
# ---------------------------------------------------------------------------

SPLASH_CASES = [  # B, S, H, hd, dtype
    (2, 1024, 4, 128, "bfloat16"),      # block 512: full, partial, skipped
    (1, 384, 2, 128, "float32"),        # block 128
    (1, 640, 2, 256, "bfloat16"),       # block 128, hd 256
    (1, 512, 2, 256, "float32"),
]
# forward element by element, as a share of max(|x|, 2^-8 x scale): one
# output rounding in bf16, summation order in fp32; the backward kernels
# as a share of each gradient's scale (both sides round p and ds alike)
SPLASH_FWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
SPLASH_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def rel_err(got, want) -> float:
    want = want.float()
    floor = 2 ** -8 * want.abs().max()
    return ((got.float() - want).abs()
            / torch.maximum(want.abs(), floor)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,dtype", SPLASH_CASES)
@pytest.mark.parametrize("with_lse", [False, True])
def test_splash_forward_kernel_matches_plain(B, S, H, hd, dtype, with_lse):
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    qs = sa.prescale(randn(rng, (B, S, H, hd), dt, dev))
    k, v = (randn(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    before = build.LAUNCHES["splash_fwd"]
    got = sa.splash_fwd(qs, k, v, with_lse=with_lse)
    assert build.LAUNCHES["splash_fwd"] == before + 1
    want = sa.splash_attention_plain(qs, k, v, with_lse=with_lse)
    if with_lse:
        (got, lse), (want, want_lse) = got, want
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    assert got.dtype == dt
    assert rel_err(got, want) <= SPLASH_FWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,dtype", SPLASH_CASES)
def test_splash_backward_kernels_match_plain(B, S, H, hd, dtype):
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(12)
    qs = sa.prescale(randn(rng, (B, S, H, hd), dt, dev))
    k, v, do = (randn(rng, (B, S, H, hd), dt, dev) for _ in range(3))
    o, lse = sa.splash_fwd(qs, k, v, with_lse=True)
    before = dict(build.LAUNCHES)
    got = sa.splash_attention_bwd(qs, k, v, o, lse, do)
    assert {n: build.LAUNCHES[n] - before[n] for n in
            ("splash_bwd_dq", "splash_bwd_dkv")} == \
        {"splash_bwd_dq": 1, "splash_bwd_dkv": 1}
    want = sa.splash_attention_bwd_plain(qs, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= \
            SPLASH_BWD_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,dtype", SPLASH_CASES)
def test_splash_backward_kernels_are_deterministic(B, S, H, hd, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    from tpushare_torch.workloads.ops import splash_attention as sa
    from tpushare_torch.workloads.ops.attention import bwd_delta
    dev, dt = card(), getattr(torch, dtype)
    rng = np.random.default_rng(14)
    qs = sa.prescale(randn(rng, (B, S, H, hd), dt, dev))
    k, v, do = (randn(rng, (B, S, H, hd), dt, dev) for _ in range(3))
    o, lse = sa.splash_fwd(qs, k, v, with_lse=True)
    di = bwd_delta(do, o)
    first = (sa.splash_bwd_dq(qs, k, v, do, lse, di),
             *sa.splash_bwd_dkv(qs, k, v, do, lse, di))
    second = (sa.splash_bwd_dq(qs, k, v, do, lse, di),
              *sa.splash_bwd_dkv(qs, k, v, do, lse, di))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_splash_autograd_runs_the_kernels():
    """Autograd through ``splash_attention`` on the card: one LSE forward,
    one dQ and one dK/dV launch, and the plain twins' gradients."""
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev = card()
    rng = np.random.default_rng(13)
    q, k, v = (randn(rng, (1, 256, 2, 128), torch.float32,
                     dev).requires_grad_() for _ in range(3))
    do = randn(rng, (1, 256, 2, 128), torch.float32, dev)
    before = dict(build.LAUNCHES)
    got = torch.autograd.grad(sa.splash_attention(q, k, v), (q, k, v), do)
    assert {n: build.LAUNCHES[n] - before[n] for n in
            ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv")} == \
        {"splash_fwd": 1, "splash_bwd_dq": 1, "splash_bwd_dkv": 1}
    want = torch.autograd.grad(
        sa.splash_attention_plain(sa.prescale(q), k, v), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_splash_wrappers_reject_what_the_kernels_cannot_take():
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev = card()
    x = torch.zeros((1, 256, 2, 128), device=dev)
    with pytest.raises(ValueError, match="MHA only"):
        sa.splash_fwd(x, x[:, :, :1].contiguous(), x[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="does not tile"):
        y = torch.zeros((1, 200, 2, 128), device=dev)
        sa.splash_fwd(y, y, y)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros((1, 256, 2, 64), device=dev)
        sa.splash_fwd(z, z, z)


# ---------------------------------------------------------------------------
# the bf16 forwards on tensor cores (K1, K6-fwd: P as two bf16 halves)
# ---------------------------------------------------------------------------

# element by element, as chip_smoke.py holds them (FWD_TOL, FWD_FLOOR):
# one bf16 rounding of the output on each side; the fp32 LSE from the
# same fp32 scores
FWD_TOL, LSE_TOL = 1e-2, 1e-4
FLASH_BF16_CASES = [  # B, S, H, Hkv, hd, causal, window
    (2, 128, 16, 16, 128, True, None),     # the forward's heads
    (2, 300, 16, 16, 128, True, None),     # S past the last tile
    (2, 32, 8, 8, 64, True, None),         # the decode prompt
    (2, 77, 4, 2, 64, True, None),
    (8, 64, 8, 8, 16, True, None),         # the payload's heads
    (2, 256, 8, 8, 32, True, None),
    (2, 1024, 16, 16, 96, True, None),     # the train shape's heads
    (2, 1024, 16, 4, 96, True, None),      # GQA 16:4
    (2, 1024, 16, 16, 96, True, 256),      # the window band
    (2, 512, 16, 16, 128, False, None),    # full attention
    (2, 300, 8, 2, 96, False, None),
]
SPLASH_BF16_CASES = [  # B, S, H, hd
    (2, 4096, 2, 128),                     # block 512
    (1, 4224, 4, 128),                     # block 128
    (1, 4096, 2, 256),
]


def flash_bf16_inputs(seed, B, S, H, Hkv, hd):
    dev = card()
    rng = np.random.default_rng(seed)
    return (randn(rng, (B, S, H, hd), torch.bfloat16, dev),
            *(randn(rng, (B, S, Hkv, hd), torch.bfloat16, dev)
              for _ in range(2)))


def splash_bf16_inputs(seed, B, S, H, hd):
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev = card()
    rng = np.random.default_rng(seed)
    qs = sa.prescale(randn(rng, (B, S, H, hd), torch.bfloat16, dev))
    return (qs, *(randn(rng, (B, S, H, hd), torch.bfloat16, dev)
                  for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", FLASH_BF16_CASES)
def test_flash_bf16_forward_matches_plain_element_by_element(
        B, S, H, Hkv, hd, causal, window):
    q, k, v = flash_bf16_inputs(15, B, S, H, Hkv, hd)
    before = build.LAUNCHES["flash_fwd"]
    got, lse = attention.flash_attention_fwd(q, k, v, causal, window,
                                             with_lse=True)
    bare = attention.flash_attention_fwd(q, k, v, causal, window)
    assert build.LAUNCHES["flash_fwd"] == before + 2
    want, want_lse = attention.flash_attention_plain(
        q, k, v, causal=causal, window=window, with_lse=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, bare)
    assert rel_err(got, want) <= FWD_TOL
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd", SPLASH_BF16_CASES)
def test_splash_bf16_forward_matches_plain_at_the_long_shapes(B, S, H, hd):
    from tpushare_torch.workloads.ops import splash_attention as sa
    qs, k, v = splash_bf16_inputs(16, B, S, H, hd)
    got, lse = sa.splash_fwd(qs, k, v, with_lse=True)
    want, want_lse = sa.splash_attention_plain(qs, k, v, with_lse=True)
    assert rel_err(got, want) <= FWD_TOL
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("flash", (2, 1024, 16, 16, 96, True, None)),
    ("flash", (2, 1024, 16, 16, 96, True, 256)),
    ("flash", (2, 300, 8, 2, 64, False, None)),
    ("splash", (1, 4224, 4, 128)),
    ("splash", (1, 1024, 2, 256)),
])
def test_forward_kernels_are_deterministic(kind, shape):
    """No atomics and a fixed order of sums: two launches on the same
    inputs give the same bits, output and LSE."""
    from tpushare_torch.workloads.ops import splash_attention as sa
    if kind == "flash":
        B, S, H, Hkv, hd, causal, window = shape
        q, k, v = flash_bf16_inputs(17, B, S, H, Hkv, hd)

        def launch():
            return attention.flash_attention_fwd(q, k, v, causal, window,
                                                 with_lse=True)
    else:
        qs, k, v = splash_bf16_inputs(17, *shape)

        def launch():
            return sa.splash_fwd(qs, k, v, with_lse=True)
    first, second = launch(), launch()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_forwards_refuse_a_misaligned_tensor():
    """cp.async reads 16-byte chunks: a bf16 view that starts 2 bytes off
    is refused with CUDA's misaligned-address error, not run or sent to a
    twin."""
    from tpushare_torch.workloads.ops import splash_attention as sa
    dev = card()
    buf = torch.zeros(2 * 256 * 2 * 128 + 1, dtype=torch.bfloat16,
                      device=dev)
    off = buf[1:].view(2, 256, 2, 128)
    ok = torch.zeros_like(off)
    with pytest.raises(RuntimeError, match="misaligned"):
        attention.flash_attention_fwd(off, ok, ok)
    with pytest.raises(RuntimeError, match="misaligned"):
        sa.splash_fwd(ok, off, ok)


@pytest.mark.cuda
def test_bf16_backwards_refuse_a_misaligned_tensor():
    """The flash backward's bf16 kernels read 16-byte chunks too: a view
    that starts 2 bytes off is refused by the dQ and the dK/dV kernel
    alike, not run or sent to a twin."""
    dev = card()
    B, S, H, hd = 2, 256, 2, 128
    buf = torch.zeros(B * S * H * hd + 1, dtype=torch.bfloat16, device=dev)
    off = buf[1:].view(B, S, H, hd)
    ok = torch.zeros_like(off)
    stat = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    before = dict(build.LAUNCHES)
    for args in ((off, ok, ok, ok), (ok, ok, ok, off)):
        with pytest.raises(RuntimeError, match="misaligned"):
            attention.flash_bwd_dq(*args, stat, stat)
        with pytest.raises(RuntimeError, match="misaligned"):
            attention.flash_bwd_dkv(*args, stat, stat)
    assert build.LAUNCHES == before


# ---------------------------------------------------------------------------
# the build's digest (CPU: reads files only, needs no nvcc)
# ---------------------------------------------------------------------------

def _local_includes(path):
    return re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(),
                      re.MULTILINE)


def test_every_included_header_is_in_the_build_digest():
    """Every ``#include "..."`` of every kernel source and header is listed
    in ``build.HEADERS``, so no kernel is served from a stale build after
    a header edit."""
    files = sorted(build.KERNEL_DIR.glob("*.cu")) + \
        sorted(build.KERNEL_DIR.glob("*.cuh"))
    assert {p.name for p in files if p.suffix == ".cu"} == \
        set(build.SOURCES.values())
    included = {name for p in files for name in _local_includes(p)}
    assert "mma_tile.cuh" in included
    assert included <= set(build.HEADERS)
    assert all((build.KERNEL_DIR / h).is_file() for h in build.HEADERS)


@pytest.mark.parametrize("header", build.HEADERS)
def test_a_header_edit_renames_every_library(tmp_path, monkeypatch, header):
    """``library_path`` digests the shared headers: an edit to one names
    a new library for every source."""
    for f in (*build.SOURCES.values(), *build.HEADERS):
        shutil.copy(build.KERNEL_DIR / f, tmp_path / f)
    monkeypatch.setattr(build, "KERNEL_DIR", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    with open(tmp_path / header, "a") as fh:
        fh.write("\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
