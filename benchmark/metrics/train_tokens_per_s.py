"""Tokens trained a second: every step completed in the window times
the tokens of a step, over the window's seconds (ending on a
synchronize)."""


def read(rec):
    if rec.get("kind") != "train" or rec["window_s"] <= 0:
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
