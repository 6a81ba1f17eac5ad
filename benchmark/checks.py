"""The numbers that decide ``correct``: the program's readings against
the plain reference's. Each number has its limit in the cell file."""

from __future__ import annotations

import statistics

# a leaf whose reference gradient norm is under this share of the
# median leaf's moves under AdamW by round-off alone: it is left out of
# the change comparison
NOUGHT_GRAD = 1e-3


def leaf_gap(prog: dict[str, float], ref: dict[str, float],
             names=None) -> tuple[float, str]:
    """Worst leaf's |prog norm - ref norm| over max(ref norm of that
    leaf, the median leaf's ref norm), and that leaf's name."""
    names = list(ref) if names is None else list(names)
    floor = statistics.median(ref[n] for n in ref)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the worst step's |loss - ref loss| / ref loss;
    ``grad_norm_gap``: the worst leaf's first-gradient norm gap;
    ``change_norm_gap``: the worst leaf's change gap after the steps the
    reference followed, leaves with a nought reference gradient left
    out."""
    n = len(ref["losses"])
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"][:n], ref["losses"]))
    gn, gn_at = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    floor = statistics.median(ref["grad_norms"].values())
    moving = [k for k, v in ref["grad_norms"].items()
              if v >= NOUGHT_GRAD * floor]
    cn, cn_at = leaf_gap(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": loss_gap, "grad_norm_gap": gn,
            "change_norm_gap": cn, "_grad_norm_leaf": gn_at,
            "_change_norm_leaf": cn_at,
            "_left_out": sorted(set(ref["grad_norms"]) - set(moving))}
