"""Admission waves' wall (prefill chunks, page install, the wave's
first-token sync) per thousand prompt tokens admitted, over the run."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["waves"]:
        return None
    wall = sum(t1 - t0 for t0, t1, _ in rec["waves"])
    tokens = sum(n for _, _, n in rec["waves"])
    return 1e6 * wall / tokens
