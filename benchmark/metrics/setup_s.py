"""Set-up: process start to the window's start (weights, engine or
optimizer state, warm-up, the first steps)."""


def read(rec):
    return rec["setup_s"]
