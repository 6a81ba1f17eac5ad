"""Decode chunks' wall (dispatch to the end of the harvest) per token
kept, over the run: every lane's tokens of a chunk share its wall."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["chunks"]:
        return None
    wall = sum(t1 - t0 for t0, t1, _ in rec["chunks"])
    tokens = sum(n for _, _, n in rec["chunks"])
    return 1e3 * wall / tokens if tokens else None
