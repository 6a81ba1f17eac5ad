"""K6 (``splash_fwd.cu``, ``splash_bwd.cu``): the operations bound of
every traced forward, dQ and dK/dV launch (causal pairs, at the step's
shape) over their profiled time."""

from benchmark.records import roofline_pct
from benchmark.roofline import (attn_bwd_bytes, attn_dkv_ops, attn_dq_ops,
                                attn_fwd_bytes, attn_fwd_ops)


def read(rec):
    if rec.get("kind") != "train":
        return None
    m, mix = rec["m"], rec["mix"]
    B, S = int(mix["batch"]), int(mix["seq"])
    H, Hkv, hd = m["n_heads"], m["kv_heads"], m["head_dim"]
    return roofline_pct(rec, [
        ("splash_fwd", ("splash_fwd",), attn_fwd_ops(B, H, S, hd),
         attn_fwd_bytes(B, H, Hkv, S, hd, lse=True)),
        ("splash_bwd_dq", ("splash_bwd_dq",), attn_dq_ops(B, H, S, hd),
         attn_bwd_bytes(B, H, Hkv, S, hd)),
        ("splash_bwd_dkv", ("splash_bwd_dkv",), attn_dkv_ops(B, H, S, hd),
         attn_bwd_bytes(B, H, Hkv, S, hd, dkv=True))])
