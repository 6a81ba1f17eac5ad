"""The port's KV-cache decode held against the JAX reference on the CPU:
greedy ``generate`` and ``chunked_generate`` token-identical on an f32
preset with bridged weights, the sampling transforms equal on the same
logits, and the chunk-step overflow guards."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads import decode as jdec  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare_torch.workloads import bridge  # noqa: E402
from tpushare_torch.workloads import decode as tdec  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402

JCFG = jt.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                  for f in dataclasses.fields(JCFG)},
                               "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
TPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")


def prompt(seed, n, batch=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab, (batch, n))


@pytest.mark.parametrize("batch,plen,steps", [(2, 7, 12), (1, 130, 6)])
def test_generate_greedy_token_identical(batch, plen, steps):
    p = prompt(10 + plen, plen, batch)
    ref = np.asarray(jdec.generate(JPARAMS, jnp.asarray(p, jnp.int32), JCFG,
                                   steps))
    got = tdec.generate(TPARAMS, torch.from_numpy(p), TCFG, steps)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("plen", [5, 40])
def test_chunked_generate_token_identical(plen):
    p = prompt(20 + plen, plen)
    kw = dict(buckets=(8, 32), max_seq=96)
    ref = np.asarray(jdec.chunked_generate(
        JPARAMS, jnp.asarray(p, jnp.int32), JCFG, 10, **kw))
    got = tdec.chunked_generate(TPARAMS, torch.from_numpy(p), TCFG, 10, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chunk_step_logits_match_reference():
    p = prompt(3, 12, 2)
    jc = jdec.init_cache(JCFG, 2, 32)
    tc = tdec.init_cache(TCFG, 2, 32, device="cpu")
    jl, jc = jdec.chunk_step(JPARAMS, jnp.asarray(p, jnp.int32), jc, JCFG)
    tl, tc = tdec.chunk_step(TPARAMS, torch.from_numpy(p), tc, TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)
    assert tc["length"] == int(jc["length"]) == 12


def test_chunk_step_overflow_guards_raise():
    cache = tdec.init_cache(TCFG, 1, 16, device="cpu")
    cache = {**cache, "length": 14}
    with pytest.raises(ValueError, match="KV cache overflow"):
        tdec.chunk_step(TPARAMS, torch.zeros((1, 3), dtype=torch.int64),
                        cache, TCFG)
    rope = tt.rope_tables(TCFG, 15)
    with pytest.raises(ValueError, match="rope table overflow"):
        tdec.chunk_step(TPARAMS, torch.zeros((1, 2), dtype=torch.int64),
                        cache, TCFG, rope=rope)


@pytest.mark.parametrize("top_k", [0, 1, 5, 1000])
def test_truncate_top_k_matches(top_k):
    logits = np.random.default_rng(top_k).standard_normal(
        (3, 64)).astype(np.float32)
    ref = jdec.truncate_top_k(jnp.asarray(logits), top_k)
    got = tdec.truncate_top_k(torch.from_numpy(logits), top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, [0.5, 1.0, 0.2]])
def test_truncate_top_p_matches(top_p):
    logits = np.random.default_rng(7).standard_normal(
        (3, 64)).astype(np.float32) * 3
    jp = jnp.asarray(top_p, jnp.float32) if isinstance(top_p, list) else top_p
    tp = torch.tensor(top_p) if isinstance(top_p, list) else top_p
    ref = jdec.truncate_top_p(jnp.asarray(logits), jp)
    got = tdec.truncate_top_p(torch.from_numpy(logits), tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampling_is_seeded_and_respects_truncation():
    logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 64)).astype(np.float32))
    draws = [tdec.sample_token(logits, torch.Generator().manual_seed(3),
                               temperature=0.8, top_k=3) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(draws[0][b]) in top3[b].tolist() for b in range(4))
    assert torch.equal(tdec.sample_token(logits, None),
                       torch.argmax(logits, dim=-1))


@pytest.mark.parametrize("plen,buckets", [(5, (8, 32)), (32, (8, 32)),
                                          (70, (8, 32)), (9, (16,))])
def test_prefill_chunk_layout_matches(plen, buckets):
    assert tdec.prefill_chunk_layout(plen, buckets) == \
        jdec.prefill_chunk_layout(plen, buckets)


def test_windowed_generate_matches_reference():
    """A sliding-window model decodes with the reference's banded mask:
    the cached core bands by ``cfg.attn_window`` (ring arithmetic over
    the cache rows), so decode logits match within 1e-4 and greedy
    tokens are identical over 24 steps — past the window, where an
    unbanded mask diverges at the first step."""
    jcfg = dataclasses.replace(JCFG, attn_window=16)
    tcfg = dataclasses.replace(TCFG, attn_window=16)
    p = np.random.default_rng(1).integers(0, JCFG.vocab, (2, 40))
    jp = jnp.asarray(p, jnp.int32)
    jc = jdec.init_cache(jcfg, 2, 128)
    tc = tdec.init_cache(tcfg, 2, 128, device="cpu")
    jl, jc = jdec.prefill(JPARAMS, jp, jcfg, jc)
    tl, tc = tdec.prefill(TPARAMS, torch.from_numpy(p), tcfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    jl, _ = jdec.decode_step(JPARAMS, jnp.asarray(tok, jnp.int32), jc, jcfg)
    tl, _ = tdec.decode_step(TPARAMS, torch.from_numpy(tok), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    ref = np.asarray(jdec.generate(JPARAMS, jp, jcfg, 24))
    got = tdec.generate(TPARAMS, torch.from_numpy(p), tcfg, 24)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_prefill_logit_pos_matches_reference():
    """``prefill(logit_pos=)`` returns the logits at that position (the
    reference's bucket-padded admission reads the true last token)."""
    p = prompt(4, 20, 2)
    jc = jdec.init_cache(JCFG, 2, 32)
    tc = tdec.init_cache(TCFG, 2, 32, device="cpu")
    jl, _ = jdec.prefill(JPARAMS, jnp.asarray(p, jnp.int32), JCFG, jc,
                         logit_pos=jnp.int32(13))
    tl, _ = tdec.prefill(TPARAMS, torch.from_numpy(p), TCFG, tc, logit_pos=13)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
