"""The port's flash backward twins against the JAX reference on the CPU,
the differentiable front door on CPU tensors, and the registry's banded
row. (The CUDA kernels are held against these twins in
tests/test_torch_kernels.py and by chip_smoke.py, on a GPU.)

- ``flash_attention_plain``'s LSE against the reference's
  ``_flash_fwd_rows(with_lse=True)``, and ``flash_attention_bwd_plain``
  against ``jax.vjp`` of the reference's Pallas ``flash_attention`` in
  interpret mode (32-wide blocks): MHA, GQA 4:2 (grouped dK/dV), a
  window of 48 and full attention, in fp32 within 2e-5;
- the autograd Function (``flash_attention`` on tensors that require
  grad) against autograd through the plain forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.ops import attention as jattn  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.ops import attention as tattn  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402

# fp32: the reference's tiled kernels and the twins' einsums differ in
# summation order only
ATOL = 2e-5

CASES = {  # B, S, H, Hkv, hd, causal, window
    "mha": (2, 64, 4, 4, 32, True, None),
    "gqa": (1, 64, 4, 2, 32, True, None),
    "window": (1, 128, 4, 2, 32, True, 48),
    "full": (1, 64, 4, 4, 32, False, None),
}


def inputs(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)

    def draw(heads):
        return rng.standard_normal((B, S, heads, hd)).astype(np.float32)
    return draw(H), draw(Hkv), draw(Hkv), draw(H)      # q, k, v, dO


def rows(x):
    """(B, S, h, hd) -> the reference kernels' (B*h, S, hd) rows."""
    B, S, h, hd = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, S, hd)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lse_matches_the_reference_kernel(case):
    B, S, H, Hkv, hd, causal, window = CASES[case]
    q, k, v, _ = inputs(0, B, S, H, Hkv, hd)
    ref_o, ref_lse = jattn._flash_fwd_rows(
        rows(q), rows(k), rows(v), causal=causal, block_q=32, block_k=32,
        interpret=True, with_lse=True, window=window)
    o, lse = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.reshape(B * H, S, 1).numpy(),
                               np.asarray(ref_lse), atol=ATOL)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(ref_o).reshape(B, H, S, hd).transpose(
            0, 2, 1, 3), atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    B, S, H, Hkv, hd, causal, window = CASES[case]
    q, k, v, do = inputs(1, B, S, H, Hkv, hd)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=causal, block_q=32, block_k=32, interpret=True,
        window=window), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal,
                                         window=window, with_lse=True)
    got = tattn.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=causal, window=window)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert tuple(g.shape) == r.shape, name      # dK/dV grouped
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_autograd_of_the_plain_forward(case):
    B, S, H, Hkv, hd, causal, window = CASES[case]
    q, k, v, do = inputs(2, B, S, H, Hkv, hd)

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, causal=causal, window=window)
        return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))

    out, got = grads(tattn.flash_attention)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want_out, want = grads(tattn.flash_attention_plain)
    torch.testing.assert_close(out, want_out, atol=ATOL, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_inference_call_skips_the_function_and_the_lse():
    q, k, v, _ = inputs(3, 1, 16, 2, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = tattn.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    plain = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert plain.grad_fn is None
    torch.testing.assert_close(out, plain)


def test_cpu_backward_never_reaches_the_kernel_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(build, "library", refuse)
    before = dict(build.LAUNCHES)
    q, k, v, do = inputs(4, 1, 24, 4, 2, 16)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*leaves, window=5)
    out.backward(torch.from_numpy(do))
    assert all(t.grad is not None for t in leaves)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("kw", [dict(causal=False, window=8),
                                dict(causal=True, window=0)])
def test_window_validation_matches_the_reference(kw):
    x = torch.zeros((1, 8, 2, 16))
    for fn in (tattn.flash_attention, tattn.flash_attention_plain):
        with pytest.raises(ValueError, match="causal|window"):
            fn(x, x, x, **kw)


# ---------------------------------------------------------------------------
# registry: the banded row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,expect", [
    (dict(seq=1024, window=256, n_heads=16, head_dim=96),
     ("flash", "window:flash-banded")),
    (dict(seq=4096, window=256, n_heads=16, head_dim=128),
     ("flash", "window:flash-banded")),
    (dict(seq=128, window=32, impl="kernel"),
     ("flash", "window:flash-banded")),
    (dict(seq=128, window=32, impl="flash"), ("flash", "explicit:flash")),
])
def test_window_rows_run_the_banded_kernel(kw, expect):
    assert registry.decide(registry.KIND_PREFILL,
                           **{"platform": "cuda", **kw}) == expect


def test_banded_choice_is_the_differentiable_kernel_with_its_window():
    registry.reset_fallbacks()
    choice = registry.select_attention(registry.KIND_PREFILL, seq=128,
                                       window=32, platform="cuda")
    assert (choice.impl, choice.reason) == ("flash", "window:flash-banded")
    assert choice.fn.func is tattn.flash_attention
    assert choice.fn.keywords == {"causal": True, "window": 32}
    assert registry.fallback_counts() == {}
