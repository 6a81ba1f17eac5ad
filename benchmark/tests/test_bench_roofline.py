"""The yardstick's arithmetic: the causal FLOP counts against a
brute-force count, the kernel bounds against PERF.md's table of
kernels (bytes and operations from shapes), and the peaks."""

import pytest

from benchmark import roofline as R

SMALL = [
    {"vocab": 11, "d_model": 8, "n_heads": 2, "kv_heads": 2, "head_dim": 4,
     "n_layers": 3, "d_ff": 12},
    {"vocab": 7, "d_model": 12, "n_heads": 4, "kv_heads": 2, "head_dim": 3,
     "n_layers": 2, "d_ff": 5},
]


def brute_token_macs(m, position, logits):
    D, F, L = m["d_model"], m["d_ff"], m["n_layers"]
    H, Hkv, hd = m["n_heads"], m["kv_heads"], m["head_dim"]
    macs = 0
    for _ in range(L):
        macs += D * H * hd + 2 * D * Hkv * hd + H * hd * D     # q, k, v, o
        macs += 3 * D * F                                      # SwiGLU
        for _key in range(position + 1):                       # causal keys
            macs += 2 * H * hd                                 # QK^T, PV
    if logits:
        macs += D * m["vocab"]
    return macs


@pytest.mark.parametrize("m", SMALL)
@pytest.mark.parametrize("batch,seq", [(1, 1), (2, 5), (3, 9)])
def test_forward_and_train_flops_brute_force(m, batch, seq):
    macs = batch * sum(brute_token_macs(m, p, True) for p in range(seq))
    assert R.forward_flops(m, batch, seq) == 2 * macs
    assert R.train_step_flops(m, batch, seq) == 6 * macs


@pytest.mark.parametrize("m", SMALL)
@pytest.mark.parametrize("prompt,n_out", [(1, 1), (5, 1), (5, 4), (9, 7)])
def test_served_request_flops_brute_force(m, prompt, n_out):
    macs = sum(brute_token_macs(m, p, p == prompt - 1)
               for p in range(prompt))
    macs += sum(brute_token_macs(m, p, True)
                for p in range(prompt, prompt + n_out - 1))
    assert R.serve_request_flops(m, prompt, n_out) == 2 * macs


@pytest.mark.parametrize("S", [1, 2, 7, 16])
def test_attention_ops_brute_force(S):
    B, H, hd = 2, 3, 4
    pairs = sum(1 for q in range(S) for k in range(S) if k <= q)
    assert R.attn_fwd_ops(B, H, S, hd) == 2 * 2 * B * H * hd * pairs
    assert R.attn_dq_ops(B, H, S, hd) == 3 * 2 * B * H * hd * pairs
    assert R.attn_dkv_ops(B, H, S, hd) == 4 * 2 * B * H * hd * pairs


def ms(ops, n_bytes, dtype="bfloat16"):
    t, which = R.bound_s(ops, n_bytes, dtype)
    return round(t * 1e3, 4), which


# PERF.md's table of kernels, column "Bound" (ms, and what bounds it)
def test_splash_bounds_match_the_kernel_table():
    B, H, S, hd = 2, 16, 4096, 128                      # K6 rows
    f = R.attn_fwd_bytes(B, H, H, S, hd, lse=True)
    assert ms(R.attn_fwd_ops(B, H, S, hd), f) == (0.1390, "operations")
    assert ms(R.attn_dq_ops(B, H, S, hd),
              R.attn_bwd_bytes(B, H, H, S, hd)) == (0.2085, "operations")
    assert ms(R.attn_dkv_ops(B, H, S, hd),
              R.attn_bwd_bytes(B, H, H, S, hd, dkv=True)) == (0.2780,
                                                              "operations")
    H = 8                                               # B.8 rank-0 shard
    assert ms(R.attn_fwd_ops(B, H, S, hd), f) == (0.0695, "operations")
    assert ms(R.attn_dq_ops(B, H, S, hd), 0) == (0.1043, "operations")


def test_flash_bounds_match_the_kernel_table():
    # K1 forward B=8 S=128 16 x 128 (bytes)
    B, H, S, hd = 8, 16, 128, 128
    assert ms(R.attn_fwd_ops(B, H, S, hd),
              R.attn_fwd_bytes(B, H, H, S, hd)) == (0.0050, "bytes")
    # K1 with LSE, K2, K3 at the train shape B=8 S=1024 16 x 96
    B, S, hd = 8, 1024, 96
    assert ms(R.attn_fwd_ops(B, H, S, hd),
              R.attn_fwd_bytes(B, H, H, S, hd, lse=True)) == (0.0302, "bytes")
    assert ms(R.attn_dq_ops(B, H, S, hd),
              R.attn_bwd_bytes(B, H, H, S, hd)) == (0.0391, "operations")
    assert ms(R.attn_dkv_ops(B, H, S, hd),
              R.attn_bwd_bytes(B, H, H, S, hd, dkv=True)) == (0.0522,
                                                              "operations")
    # B.10 rank-0 shard B=4 S=1024 8 x 96
    B, H = 4, 8
    assert ms(R.attn_fwd_ops(B, H, S, hd),
              R.attn_fwd_bytes(B, H, H, S, hd, lse=True)) == (0.0076, "bytes")
    assert ms(R.attn_dq_ops(B, H, S, hd), 0) == (0.0098, "operations")
    assert ms(R.attn_dkv_ops(B, H, S, hd), 0) == (0.0130, "operations")


# K5 rows: (label, B, H, Hkv, max kv_len, table rows, straggler's peers'
# top kv_len or None, dtype, the table's bound in ms). The table drew
# kv_lens at random (in (max/2, max], or the straggler at max and its
# peers in [1, top]) with lane 1's first half-table aliased on lane 0's;
# the rows here are those draws' expected unique rows, so the bounds
# agree within the draws' spread.
K5 = [("main-path", 8, 16, 16, 256, 256, None, "bfloat16", 0.0037),
      ("flagship-2k", 8, 16, 16, 2048, 2048, None, "bfloat16", 0.0299),
      ("flagship-2k-f32", 8, 16, 16, 2048, 2048, None, "float32", 0.0525),
      ("gqa-2k", 8, 16, 4, 2048, 2048, None, "bfloat16", 0.0068),
      ("straggler-16k", 8, 16, 16, 16384, 16384, 1024, "bfloat16", 0.0478)]


@pytest.mark.parametrize("row", K5, ids=lambda r: r[0])
def test_paged_bounds_match_the_kernel_table(row):
    _, B, H, Hkv, max_len, table_rows, top, dtype, table_ms = row
    if top is None:
        mean = (max_len // 2 + 1 + max_len) / 2
        rows = B * mean - table_rows // 2
        kv_sum = B * mean
    else:
        peers = (B - 1) * (1 + top) / 2
        rows = max_len + peers - (1 + top) / 2     # lane 1 lies in lane 0's
        kv_sum = max_len + peers
    t, which = R.bound_s(R.paged_decode_ops(kv_sum, H, 128),
                         R.paged_decode_bytes(rows, B, H, Hkv, 128, dtype),
                         dtype)
    assert which == "bytes"
    assert t * 1e3 == pytest.approx(table_ms, rel=0.10)


def test_peaks_with_the_power_limit():
    assert R.CARD == "NVIDIA H100 SXM5 80GB" and R.POWER_LIMIT_W == 700.0
    assert R.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert R.HBM_BYTES_PER_S == 3.35e12
    assert R.share_pct(1.0, 0.0) is None and R.share_pct(0.0, 1.0) is None
    assert R.share_pct(1.0, 4.0) == 25.0
