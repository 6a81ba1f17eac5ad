"""The generators: one seed gives the same bytes, another seed other
bytes; every seed gets the same arrivals and the same multiset of
sizes; seeds beyond 32 bits work."""

import json

import pytest
import torch

from benchmark import traffic
from benchmark.weights import leaf_seed, make_params, param_shapes

DOCQA = traffic.load_mix("docqa")
TRAIN = traffic.load_mix("train_s4096")
BIG = 2 ** 31 + 12345
HUGE = 2 ** 40 + 3


def _requests(seed, seconds=30.0, rate=2.5, vocab=32768):
    return traffic.generator(DOCQA).make_requests(DOCQA, seed, seconds, rate,
                                                  vocab)


def test_openloop_byte_identical_for_a_seed():
    a, b = _requests(BIG), _requests(BIG)
    assert json.dumps(a).encode() == json.dumps(b).encode()


def test_openloop_differs_across_seeds():
    a, b = _requests(BIG), _requests(HUGE)
    assert json.dumps(a) != json.dumps(b)
    assert [r["prompt"][:8] for r in a] != [r["prompt"][:8] for r in b]


def test_openloop_same_work_for_every_seed():
    a, b = _requests(BIG), _requests(HUGE)
    assert [(r["due_s"], len(r["prompt"]), r["max_new"]) for r in a] == \
        [(r["due_s"], len(r["prompt"]), r["max_new"]) for r in b]


def test_openloop_sizes_within_the_mix():
    reqs = _requests(BIG, seconds=50.0)
    assert len(reqs) > 50
    p = DOCQA["prompt"]
    a = DOCQA["answer"]
    assert all(p["min"] <= len(r["prompt"]) <= p["max"] for r in reqs)
    assert all(a["min"] <= r["max_new"] <= a["max"] for r in reqs)
    assert all(0 <= t < 32768 for r in reqs for t in r["prompt"])
    due = [r["due_s"] for r in reqs]
    assert due == sorted(due) and due[-1] < 50.0


def test_poisson_rate_and_bursts():
    import random
    gen = traffic.generator(DOCQA)
    t = gen.poisson_times(random.Random(1), 4.0, 2000.0, burst_factor=3.0,
                          burst_frac=0.15)
    # mean rate: 4 x (0.85 + 0.15 x 3) = 5.2 a second
    assert abs(len(t) / 2000.0 - 5.2) < 0.3
    in_burst = sum(1 for x in t if (x / 2000.0 * 4.0) % 1.0 < 0.15)
    assert abs(in_burst / len(t) - 0.45 * 4.0 / 5.2) < 0.05


@pytest.mark.parametrize("seed", [0, BIG, HUGE])
def test_token_batches_fixed_per_step_and_seed(seed):
    gen = traffic.generator(TRAIN)
    mix = {**TRAIN, "seq": 64}
    i0, t0 = gen.make_batch(mix, seed, 0, 1000, "cpu")
    i0b, _ = gen.make_batch(mix, seed, 0, 1000, "cpu")
    i1, _ = gen.make_batch(mix, seed, 1, 1000, "cpu")
    assert torch.equal(i0, i0b) and not torch.equal(i0, i1)
    assert i0.shape == (1, 64) and torch.equal(i0[:, 1:], t0[:, :-1])
    assert gen.tokens_per_step(mix) == 64


def test_weights_redrawn_leaf_for_leaf():
    m = {"vocab": 64, "d_model": 32, "n_heads": 4, "kv_heads": 2,
         "head_dim": 8, "n_layers": 2, "d_ff": 48}
    a = make_params(BIG, m, torch.bfloat16, "cpu")
    b = make_params(BIG, m, torch.bfloat16, "cpu")
    c = make_params(HUGE, m, torch.bfloat16, "cpu")
    shapes = param_shapes(m)
    assert a["layers"]["wk"].shape == shapes["layers.wk"] == (2, 32, 16)
    for name in ("embed", "out"):
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    assert torch.equal(a["layers"]["ln1"], torch.ones(2, 32,
                                                      dtype=torch.bfloat16))
    # the port's scaling: embed by the model width, matrices by fan-in
    assert abs(a["embed"].float().std().item() - 32 ** -0.5) < 0.03
    assert abs(a["layers"]["w2"].float().std().item() - 48 ** -0.5) < 0.03
    assert leaf_seed(BIG, "embed") != leaf_seed(HUGE, "embed")
    assert 0 <= leaf_seed(2 ** 64 + 1, "x") < 2 ** 63
