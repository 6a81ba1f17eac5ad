"""The offset flash kernel of a cached chunk (``flash_fwd.cu``'s
``tpushare_flash_fwd_chunk``) against the einsum core it replaces on the
card and a plain fp32 reference, and the paged engine that runs it
against the ``chunked_generate`` oracle at the document-QA model's widths.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a host
without a card (the routing rule is tested on the CPU in
``tests/test_torch_chunk_route.py``). The file imports no JAX:

    python -m pytest tests/test_torch_chunk_kernel.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads import decode  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.models.transformer import (  # noqa: E402
    TransformerConfig)
from tpushare_torch.workloads.ops import attention  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402

# each output element within 1e-2 of max(|value|, 2^-8 x the largest
# |value|): bf16 output rounded once, after an online softmax against
# the einsum chain (the flash kernels' forward bound)
TOL = 1e-2


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    want = want.float()
    floor = 2 ** -8 * want.abs().max()
    return ((got.float() - want).abs()
            / torch.maximum(want.abs(), floor)).max().item()


def plain_chunk(q, k, v, pos):
    """fp32 attention of q (B, Q, H, hd) at positions pos .. pos+Q-1
    against the first pos + Q rows of k / v: key j kept for query i
    exactly when j <= pos + i."""
    B, Q, H, hd = q.shape
    n = pos + Q
    kf, vf = (x[:, :n].float().repeat_interleave(H // x.shape[2], dim=2)
              for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    i = torch.arange(Q, device=q.device)[:, None]
    j = torch.arange(n, device=q.device)[None, :]
    p = torch.softmax(torch.where(j <= pos + i, s, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)


def chunk_inputs(seed, B, Q, pos, rows, H, Hkv, hd, layers=2):
    """q and a (layers, B, rows, Hkv, hd) bf16 cache whose layer 1 holds
    random rows everywhere: the kernel reads layer 1's view in place."""
    dev = card()
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Q, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((layers, B, rows, Hkv, hd), generator=g,
                        device=dev).bfloat16() for _ in range(2))
    return q, k, v


CASES = [  # B, Q, pos, rows, H, Hkv, hd
    (1, 2, 0, 32, 32, 8, 128),          # two queries
    (1, 256, 0, 288, 32, 8, 128),       # a bucket, the page-rounded rows
    (1, 2048, 0, 2080, 32, 8, 128),     # the docqa median's bucket
    (1, 2048, 4096, 6144, 32, 8, 128),  # a later chunk of a long prompt
    (1, 256, 1800, 2080, 32, 8, 128),   # a suffix after a prefix
    (1, 2, 37, 96, 32, 8, 128),
    (2, 256, 100, 512, 16, 4, 128),
    (1, 2048, 0, 2048, 16, 4, 128),
    (1, 256, 0, 288, 32, 8, 64),
    (2, 2, 300, 320, 16, 4, 64),
    (1, 2048, 512, 2592, 16, 4, 64),
    (1, 256, 0, 256, 32, 8, 96),
    (1, 2, 63, 100, 16, 4, 96),
    (2, 2048, 700, 2800, 16, 4, 96),
    (1, 64, 0, 96, 8, 8, 16),
    (2, 130, 77, 224, 8, 2, 16),
    (1, 256, 0, 288, 8, 4, 32),
    (2, 40, 500, 544, 8, 8, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,pos,rows,H,Hkv,hd", CASES)
def test_chunk_kernel_matches_the_einsum_core_and_plain(B, Q, pos, rows, H,
                                                        Hkv, hd):
    q, kc, vc = chunk_inputs(Q + pos + hd, B, Q, pos, rows, H, Hkv, hd)
    k, v = decode.kv_view(kc, 1), decode.kv_view(vc, 1)
    before = dict(build.LAUNCHES)
    got = attention.flash_chunk_attention(q, k, v, pos)
    assert build.LAUNCHES["flash_fwd_chunk"] == \
        before["flash_fwd_chunk"] + 1
    assert {n: c for n, c in build.LAUNCHES.items()
            if n != "flash_fwd_chunk"} == \
        {n: c for n, c in before.items() if n != "flash_fwd_chunk"}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    cfg = TransformerConfig(d_model=H * hd, n_heads=H, n_kv_heads=Hkv,
                            max_seq=rows, dtype=torch.bfloat16)
    einsum = decode.cached_attn_einsum(q, k, v, pos, cfg,
                                       torch.arange(rows, device=q.device))
    assert rel_err(got, plain_chunk(q, k, v, pos)) <= TOL
    assert rel_err(got, einsum) <= TOL
    assert torch.equal(got, attention.flash_chunk_attention(q, k, v, pos))


@pytest.mark.cuda
def test_chunk_kernel_reads_only_the_first_pos_plus_q_rows():
    """Rows past pos + Q (the scratch's stale tail, or what a later
    chunk will write) never reach the output: NaN there changes no bit."""
    B, Q, pos, rows, H, Hkv, hd = 1, 200, 300, 640, 32, 8, 128
    q, kc, vc = chunk_inputs(11, B, Q, pos, rows, H, Hkv, hd)
    k, v = decode.kv_view(kc, 1), decode.kv_view(vc, 1)
    want = attention.flash_chunk_attention(q, k, v, pos)
    k[:, pos + Q:] = float("nan")
    v[:, pos + Q:] = float("nan")
    assert torch.equal(attention.flash_chunk_attention(q, k, v, pos), want)


@pytest.mark.cuda
def test_chunk_wrapper_rejects_what_the_kernel_cannot_take():
    dev = card()
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 32, 2, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="past the cache"):
        attention.flash_chunk_attention(q, kv, kv, 25)
    with pytest.raises(ValueError, match="bf16"):
        attention.flash_chunk_attention(q.float(), kv, kv, 0)
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros((1, 32, 2, 80), dtype=torch.bfloat16, device=dev)
        attention.flash_chunk_attention(q[..., :80], odd, odd, 0)
    heads_apart = kv.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="packed"):
        attention.flash_chunk_attention(q, heads_apart, heads_apart, 0)
    with pytest.raises(ValueError, match="do not match"):
        attention.flash_chunk_attention(q, heads_apart, kv, 0)


@pytest.mark.cuda
def test_paged_engine_matches_chunked_generate_at_the_docqa_widths():
    """Mistral-7B-v0.3's widths (d_model 4096, 32:8 heads of 128, d_ff
    14336, vocab 32768) with two layers, bf16: the paged engine's chunked
    admission and ``chunked_generate`` both take the chunk kernel, one
    launch a layer per admission chunk, and their greedy tokens match
    token for token; no chunk falls back. The engine decodes through the
    paged read's gather twin, the oracle's einsum decode step in the same
    order of sums: the paged kernel sums in its own order, and bf16
    transcripts of random weights part after a few tokens on that alone
    (the f32 identities of ``chip_smoke.py`` hold the kernel read)."""
    from tpushare_torch.workloads.models.transformer import init_params
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    dev = card()
    cfg = TransformerConfig(vocab=32768, d_model=4096, n_heads=32,
                            n_kv_heads=8, n_layers=2, d_ff=14336,
                            max_seq=1024, rope_theta=1e6,
                            dtype=torch.bfloat16)
    params = init_params(torch.Generator(device=dev).manual_seed(3), cfg,
                         dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (300, 77, 600, 5)]
    buckets = (64, 256)
    chunks = sum(len(decode.prefill_chunk_layout(len(p), buckets))
                 for p in prompts)
    registry.reset_fallbacks()
    before = build.LAUNCHES["flash_fwd_chunk"]
    eng = PagedServingEngine(params, cfg, n_lanes=4, max_seq=1024,
                             n_pages=129, page_size=32,
                             prompt_buckets=buckets, chunk=4,
                             attn_impl="xla")
    reqs = [Request(prompt=p, max_new=12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert build.LAUNCHES["flash_fwd_chunk"] - before == \
        cfg.n_layers * chunks
    for r in reqs:
        want = decode.chunked_generate(
            params, torch.tensor([r.prompt], device=dev), cfg, r.max_new,
            buckets=buckets, max_seq=1024)
        assert r.output == want[0].tolist()
    assert build.LAUNCHES["flash_fwd_chunk"] - before == \
        2 * cfg.n_layers * chunks
    assert not [k for k in registry.fallback_counts_flat()
                if k.startswith("flash:")]
