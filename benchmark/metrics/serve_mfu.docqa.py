"""The served model FLOPs of every request (its prompt, and each
output token but the last fed back, causal attention at each token's
position) over the run's span and the card's bf16 peak."""

from benchmark.records import peak_share_pct
from benchmark.roofline import serve_request_flops


def read(rec):
    if rec.get("kind") != "serve":
        return None
    flops = sum(serve_request_flops(rec["m"], len(r["prompt"]),
                                    len(r["output"]))
                for r in rec["requests"] if r["output"])
    return peak_share_pct(rec, flops, rec["span_s"])
