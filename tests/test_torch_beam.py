"""The port's ``beam_search`` held against the reference's on the CPU
(the reference's ``tests/test_beam.py``): f32 sequences identical and
scores within 1e-5 at several widths, beam 1 equal to greedy
``generate``, the score equal to the sequence's logprob under a full
forward, the exhaustive optimum at W = vocab over two steps, and beams
over an int8 slot cache (``cfg.kv_int8``) moving both planes."""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import beam as jbeam  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch.workloads import bridge  # noqa: E402
from tpushare_torch.workloads.beam import beam_search  # noqa: E402
from tpushare_torch.workloads.decode import generate  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402

JCFG = jt.TransformerConfig(vocab=16, d_model=32, n_heads=2, n_layers=2,
                            d_ff=64, max_seq=64, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")
PROMPT = [int(t) for t in np.random.default_rng(1).integers(0, 16, 5)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(steps, width):
    toks, score = beam_search(PARAMS, torch.tensor([PROMPT]), CFG, steps,
                              beam_width=width)
    jtoks, jscore = jbeam.beam_search(JPARAMS,
                                      jnp.asarray([PROMPT], jnp.int32),
                                      JCFG, steps, beam_width=width)
    return toks, score, np.asarray(jtoks), float(jscore)


@pytest.mark.parametrize("steps,width", [(8, 1), (6, 2), (6, 4), (3, 16),
                                         (5, 20)])
def test_beam_matches_reference(steps, width):
    toks, score, jtoks, jscore = run_both(steps, width)
    assert toks.tolist() == jtoks.tolist()
    assert score.dtype == torch.float32
    assert abs(float(score) - jscore) <= 1e-5
    if width == 1:
        want = generate(PARAMS, torch.tensor([PROMPT]), CFG, steps)
        assert torch.equal(toks, want)


def seq_logprobs(conts):
    """Total logprob of each continuation after PROMPT, by one batched
    full forward — the scoring oracle."""
    batch = torch.tensor([PROMPT + list(c) for c in conts])
    logp = torch.log_softmax(tt.forward(PARAMS, batch, CFG).float(), dim=-1)
    P = len(PROMPT)
    cols = torch.tensor(conts)
    rows = torch.arange(len(conts))[:, None]
    pos = P - 1 + torch.arange(cols.shape[1])[None, :]
    return logp[rows, pos, cols].sum(dim=1)


def test_beam_score_is_the_sequences_logprob_and_beats_greedy():
    toks, score = beam_search(PARAMS, torch.tensor([PROMPT]), CFG, 6,
                              beam_width=4)
    assert abs(float(score) - float(seq_logprobs([toks[0].tolist()])[0])) \
        < 1e-4
    _, s1 = beam_search(PARAMS, torch.tensor([PROMPT]), CFG, 6, beam_width=1)
    assert float(score) >= float(s1) - 1e-5


def test_beam_finds_the_exhaustive_optimum_over_two_steps():
    toks, score = beam_search(PARAMS, torch.tensor([PROMPT]), CFG, 2,
                              beam_width=CFG.vocab)
    conts = list(itertools.product(range(CFG.vocab), repeat=2))
    totals = seq_logprobs(conts)
    assert tuple(toks[0].tolist()) == conts[int(torch.argmax(totals))]
    assert abs(float(score) - float(totals.max())) < 1e-4


def test_beam_over_an_int8_cache_and_bad_arguments():
    cfg8 = dataclasses.replace(CFG, kv_int8=True)
    toks, _ = beam_search(PARAMS, torch.tensor([PROMPT]), cfg8, 6,
                          beam_width=1)
    assert torch.equal(toks, generate(PARAMS, torch.tensor([PROMPT]), cfg8,
                                      6))
    with pytest.raises(ValueError, match="one prompt"):
        beam_search(PARAMS, torch.zeros(2, 4, dtype=torch.int64), CFG, 4)
    with pytest.raises(ValueError, match="beam_width"):
        beam_search(PARAMS, torch.tensor([PROMPT]), CFG, 4, beam_width=0)
    with pytest.raises(ValueError, match="steps"):
        beam_search(PARAMS, torch.tensor([PROMPT]), CFG, 0)
