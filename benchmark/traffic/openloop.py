"""Open-loop request traffic: independent users send on a schedule
whatever the server's state.

Arrival instants come from a Poisson process with bursts (thinning, as
``tpushare_torch/workloads/traffic.py``'s ``_poisson_times``, copied
here), and prompt and answer lengths from clipped lognormals. Both are
drawn from the mix's own ``shape_seed``: every run seed gets the same
arrivals with the same lengths, so seeds do not change the work a run
holds or when it comes (which length lands in a burst decides much of
a tail). The run's seed draws every prompt's token ids (uniform over
the vocabulary, no shared prefix). Requests are greedy and stop at
``max_new`` (no end-of-sequence token)."""

from __future__ import annotations

import math
import random

import torch

from benchmark.weights import leaf_seed


def poisson_times(rng: random.Random, rate_rps: float, duration_s: float,
                  diurnal: float = 0.0, burst_factor: float = 1.0,
                  burst_frac: float = 0.0) -> list[float]:
    """Arrival instants in [0, duration_s) of a Poisson process of
    ``rate_rps`` by thinning: ``diurnal`` modulates the rate by a sine
    over the duration, and inside the ``burst_frac`` head of each
    quarter of the duration the rate is ``burst_factor`` times higher."""
    lam_max = rate_rps * (1.0 + abs(diurnal)) * max(1.0, burst_factor)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(lam_max)
        if t >= duration_s:
            return out
        lam = rate_rps * (1.0 + diurnal * math.sin(
            2.0 * math.pi * t / duration_s))
        if burst_factor > 1.0 and (t / duration_s * 4.0) % 1.0 < burst_frac:
            lam *= burst_factor
        if rng.random() < lam / lam_max:
            out.append(t)


def clipped_lognormal(rng: random.Random, spec: dict, n: int) -> list[int]:
    mu = math.log(float(spec["median"]))
    lo, hi = int(spec["min"]), int(spec["max"])
    return [min(hi, max(lo, int(round(rng.lognormvariate(mu,
                                                         spec["sigma"])))))
            for _ in range(n)]


def make_requests(mix: dict, seed: int, seconds: float, rate_rps: float,
                  vocab: int) -> list[dict]:
    """``[{"due_s", "prompt", "max_new"}]`` in arrival order."""
    shape = random.Random(int(mix["shape_seed"]))
    arr = mix["arrivals"]
    due = poisson_times(shape, rate_rps, seconds,
                        diurnal=float(arr.get("diurnal", 0.0)),
                        burst_factor=float(arr.get("burst_factor", 1.0)),
                        burst_frac=float(arr.get("burst_frac", 0.0)))
    plens = clipped_lognormal(shape, mix["prompt"], len(due))
    alens = clipped_lognormal(shape, mix["answer"], len(due))
    ids = torch.Generator()
    ids.manual_seed(leaf_seed(seed, "traffic-ids"))
    out = []
    for t, p, a in zip(due, plens, alens):
        prompt = torch.randint(0, vocab, (p,), generator=ids).tolist()
        out.append({"due_s": t, "prompt": prompt, "max_new": a})
    return out
