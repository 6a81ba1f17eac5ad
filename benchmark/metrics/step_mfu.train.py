"""The whole training step's share of the card's bf16 peak: 3 x the
causal forward's FLOPs a step (remat's recompute not counted) times
the steps of the traced window, over its seconds."""

from benchmark.records import peak_share_pct, traced
from benchmark.roofline import train_step_flops


def read(rec):
    if rec.get("kind") != "train" or traced(rec) is None:
        return None
    mix = rec["mix"]
    flops = rec["steps"] * train_step_flops(rec["m"], int(mix["batch"]),
                                            int(mix["seq"]))
    return peak_share_pct(rec, flops, rec["window_s"])
