"""Helpers for holding the port's int8 KV paths against the reference.

An int8 cache quantizes every K/V row it stores, so a difference in the
last bit of an fp32 value that lands on a rounding boundary moves one
stored element by a whole step (``s = absmax / 127``). The two packages
round such ties differently now and then (XLA's jitted ``round(x / s)``
is not torch's), which moves logits by ~1e-4-1e-3 and may break a
greedy near-tie. So the int8 engines are compared through
teacher-forced logits: within a stated tolerance at every step, and
greedy tokens equal wherever the reference's top-2 logit gap exceeds
that tolerance.

``replay_logits`` works on either package's ``decode`` module: both
expose ``init_cache``, ``prefill_chunk_layout``, ``chunk_step``,
``decode_step`` and ``kv_quantize`` with the same meaning.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def replay_logits(dec, params, cfg, prompt, tokens, buckets, max_seq, *,
                  to_arr, quantize_prefill=True, prefix=(),
                  **cache_kw) -> np.ndarray:
    """Logits (len(tokens), vocab) that predict each of ``tokens`` after
    ``prompt``, fed the tokens themselves (teacher forcing). A ``prefix``
    is prefilled first, as the slot engine registers one, and the
    prompt's chunks follow it.

    ``quantize_prefill=True`` is the slot engine's int8 semantics
    (``cfg.kv_int8``: the bucket-padded admission chunks write and read
    the int8 cache). ``False`` is the paged engine's: the chunks run on a
    dense scratch in the model dtype, which is then quantized into the
    pool, and decode writes and reads int8. ``to_arr`` turns a list of
    ids into the package's (1, n) token array."""
    bs = tuple(sorted(b for b in buckets if b <= max_seq))
    pcfg = cfg if quantize_prefill else dataclasses.replace(cfg,
                                                            kv_int8=False)
    cache = dec.init_cache(pcfg, 1, max_seq, **cache_kw)
    if prefix:
        _, cache = dec.prefill(params, to_arr(list(prefix)), pcfg, cache)
    off = len(prefix)
    logits = None
    for start, piece, padded in dec.prefill_chunk_layout(len(prompt), bs):
        toks = list(prompt[start:start + piece]) + [0] * (padded - piece)
        cache = {**cache, "length": off + start}
        logits, cache = dec.chunk_step(params, to_arr(toks), cache, pcfg,
                                       logit_pos=piece - 1)
    if not quantize_prefill:
        cache = {"k": dec.kv_quantize(cache["k"]),
                 "v": dec.kv_quantize(cache["v"])}
    cache = {**cache, "length": off + len(prompt)}
    rows = [np.asarray(logits[0], np.float32)]
    for t in tokens[:-1]:
        lg, cache = dec.decode_step(params, to_arr([t])[0], cache, pcfg)
        rows.append(np.asarray(lg[0], np.float32))
    return np.stack(rows)


def top2_gaps(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_logits_agree(got: np.ndarray, want: np.ndarray,
                        tol: float) -> None:
    """Teacher-forced logits within ``tol``, and the greedy choice equal
    wherever the reference's top-2 gap exceeds it."""
    err = np.abs(got - want).max()
    assert err <= tol, f"logits differ by {err} > {tol}"
    clear = top2_gaps(want) > tol
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def assert_transcripts_agree(got: list, want: list, want_logits: np.ndarray,
                             tol: float) -> int:
    """Greedy transcripts equal up to the first step where they part, and
    they may part only where the reference's top-2 gap is within ``tol``
    (after that the histories differ and nothing more is compared).
    Returns the number of steps compared."""
    gaps = top2_gaps(want_logits)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert gaps[i] <= tol, (f"step {i}: {a} != {b} with the "
                                    f"reference's top-2 gap {gaps[i]}")
            return i
    assert len(got) == len(want)
    return len(want)


class JittedDecode:
    """The reference's ``decode`` entry points that ``replay_logits``
    uses, with ``chunk_step`` and ``decode_step`` under ``jax.jit``
    (static config): called eagerly, each call would trace and compile
    its layer scan anew."""

    def __init__(self, jdec):
        import jax
        self.init_cache = jdec.init_cache
        self.prefill = jdec.prefill
        self.prefill_chunk_layout = jdec.prefill_chunk_layout
        self.kv_quantize = jdec.kv_quantize
        self.chunk_step = jax.jit(jdec.chunk_step, static_argnames=("cfg",))
        self.decode_step = jax.jit(jdec.decode_step,
                                   static_argnames=("cfg",))
