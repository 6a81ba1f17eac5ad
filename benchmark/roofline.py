"""The yardstick's arithmetic: the card's peaks, the model FLOPs a step
or a served token needs, and the operations and bytes of the port's
attention kernels (K1-K3 flash, K5 paged decode, K6 splash).

Counts are the work the algorithm needs, whatever a kernel skips or
recomputes: causal attention counts each (query, key) pair at or below
the diagonal once, a matrix product two operations a multiply-add, a
tensor read or written once. Remat's recompute is not model work; a
kernel launch that recomputes is its own launch and counts its own
work.

Peaks: one NVIDIA H100 SXM5 80GB, NVIDIA's data sheet, dense rates
without sparsity, at the card's full 700 W power limit; a share is
stated against these, with the card's ``power.limit`` printed beside it
by the run.
"""

from __future__ import annotations

CARD = "NVIDIA H100 SXM5 80GB"
POWER_LIMIT_W = 700.0
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# model FLOPs (``m`` is benchmark.model.dims' dict)
# ---------------------------------------------------------------------------

def dense_flops_per_token(m: dict) -> int:
    """Projections and SwiGLU of every layer for one token."""
    D, F, L = m["d_model"], m["d_ff"], m["n_layers"]
    KD = m["kv_heads"] * m["head_dim"]
    return L * (4 * D * D + 4 * D * KD + 6 * D * F)


def attention_flops(m: dict, n_keys: int) -> int:
    """Scores and the weighted sum of one query over ``n_keys`` keys in
    every layer: 2 x hd operations each, per head."""
    return 4 * m["n_layers"] * m["n_heads"] * m["head_dim"] * n_keys


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def causal_pairs(seq: int) -> int:
    """(query, key) pairs of a causal sequence: sum of 1..seq."""
    return seq * (seq + 1) // 2


def forward_flops(m: dict, batch: int, seq: int) -> int:
    """One causal forward over (batch, seq) with logits at every
    position."""
    per_seq = seq * (dense_flops_per_token(m) + head_flops(m)) \
        + attention_flops(m, causal_pairs(seq))
    return batch * per_seq


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Forward plus backward (twice the forward): 3 x the forward."""
    return 3 * forward_flops(m, batch, seq)


def serve_request_flops(m: dict, prompt_len: int, n_out: int) -> int:
    """A served request: the prompt's tokens at positions 0..P-1 with
    logits at the last one, then each output token but the last fed
    back at its position with its logits (n_out logits in all)."""
    if n_out < 1:
        return (prompt_len * dense_flops_per_token(m)
                + attention_flops(m, causal_pairs(prompt_len)))
    fed = n_out - 1
    return ((prompt_len + fed) * dense_flops_per_token(m)
            + attention_flops(m, causal_pairs(prompt_len + fed))
            + n_out * head_flops(m))


# ---------------------------------------------------------------------------
# kernel operations and bytes
# ---------------------------------------------------------------------------

def attn_fwd_ops(B: int, H: int, S: int, hd: int) -> int:
    """K1 / K6 forward, causal: QK^T and PV over the causal pairs."""
    return 4 * B * H * hd * causal_pairs(S)


def attn_dq_ops(B: int, H: int, S: int, hd: int) -> int:
    """K2 / K6-dq: S = QK^T again, dP = dO V^T, dQ = dS K."""
    return 6 * B * H * hd * causal_pairs(S)


def attn_dkv_ops(B: int, H: int, S: int, hd: int) -> int:
    """K3 / K6-dkv: S again, dV = P^T dO, dP = dO V^T, dK = dS^T Q."""
    return 8 * B * H * hd * causal_pairs(S)


def attn_fwd_bytes(B: int, H: int, Hkv: int, S: int, hd: int,
                   dtype: str = "bfloat16", lse: bool = False) -> int:
    """q, k, v read once, o written once (and the fp32 LSE)."""
    e = ITEMSIZE[dtype]
    n = B * S * hd * (2 * H + 2 * Hkv) * e
    return n + (B * H * S * 4 if lse else 0)


def paged_decode_bytes(kv_rows: int, lanes: int, H: int, Hkv: int,
                       hd: int, dtype: str = "bfloat16") -> int:
    """K5: every distinct K and V row of the lanes read once (shared
    pages once), each lane's q read and o written once."""
    e = ITEMSIZE[dtype]
    return kv_rows * Hkv * hd * 2 * e + lanes * H * hd * 2 * e


def paged_decode_ops(kv_len_sum: int, H: int, hd: int) -> int:
    return 4 * H * hd * kv_len_sum


def bound_s(ops: float, n_bytes: float, dtype: str = "bfloat16"
            ) -> tuple[float, str]:
    """Least time the card could take, and which of the two bounds it."""
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(work_s: float, measured_s: float) -> float | None:
    """A share of a peak or a roofline in percent; None where nothing
    was measured (never 0 for a share that was not read)."""
    if measured_s <= 0 or work_s <= 0:
        return None
    return 100.0 * work_s / measured_s


def attn_bwd_bytes(B: int, H: int, Hkv: int, S: int, hd: int,
                   dtype: str = "bfloat16", dkv: bool = False) -> int:
    """K2 / K6-dq (``dkv=False``): q, k, v, dO, the fp32 LSE and delta
    read, dQ written; K3 / K6-dkv: the same read, dK and dV written."""
    e = ITEMSIZE[dtype]
    q_like, kv_like = B * S * H * hd * e, B * S * Hkv * hd * e
    reads = 2 * q_like + 2 * kv_like + 2 * B * H * S * 4
    return reads + (2 * kv_like if dkv else q_like)
