"""The port's attention twins against the JAX reference on the CPU, and
the port's kernel registry rows (the CUDA kernels themselves are held
against these twins in tests/test_torch_kernels.py, on a GPU).

- ``flash_attention_plain`` against the reference's Pallas
  ``flash_attention`` in interpret mode (MHA and GQA, fp32, 2e-5);
- ``xla_paged_read`` against the reference's ``xla_paged_read`` on random
  pools with aliased table entries and ragged lengths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.ops import attention as jattn  # noqa: E402
from tpushare.workloads.ops import paged_attention as jpaged  # noqa: E402
from tpushare_torch.workloads.ops import attention as tattn  # noqa: E402
from tpushare_torch.workloads.ops import paged_attention as tpaged  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402

# fp32 reduction-order noise between the kernel's tiled online softmax
# and the einsum twin
FLASH_ATOL = 2e-5


def qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,Hkv,hd", [(2, 64, 4, 4, 32),
                                          (1, 128, 4, 2, 32)])
def test_flash_plain_matches_interpret_pallas(B, S, H, Hkv, hd):
    q, k, v = qkv(0, B, S, H, Hkv, hd)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, block_q=32,
                                block_k=32, interpret=True)
    got = tattn.flash_attention_plain(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=FLASH_ATOL)


def paged_case(seed, B=4, P=6, ps=8, H=4, Hkv=2, hd=16, n_pages=40):
    """Random pool + tables where lane 1's first two entries ALIAS lane
    0's (the shared-prefix splice) and lengths are ragged."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Hkv, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    tables[1, :2] = tables[0, :2]
    kv_lens = np.array([P * ps, 13, 1, 29][:B], np.int32)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    return q, kp, vp, tables.astype(np.int32), kv_lens


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4)])
def test_xla_paged_read_matches_reference(H, Hkv):
    q, kp, vp, tables, kv_lens = paged_case(1, H=H, Hkv=Hkv)
    ref = jpaged.xla_paged_read(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(kv_lens), H, Hkv)
    got = tpaged.xla_paged_read(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp),
                                torch.from_numpy(tables),
                                torch.from_numpy(kv_lens), H, Hkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_gather_pages_matches_reference():
    _, kp, _, tables, _ = paged_case(2)
    ref = jpaged.gather_pages(jnp.asarray(kp), jnp.asarray(tables))
    got = tpaged.gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# registry rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,expect", [
    (dict(seq=128, n_heads=16, head_dim=128), ("flash", "cuda:flash")),
    (dict(seq=512, n_heads=16, n_kv_heads=4, head_dim=128),
     ("flash", "cuda:flash")),
    (dict(seq=4096, n_heads=16, head_dim=128),
     ("flash", "longctx:flash-for-splash")),
    (dict(seq=4096, n_heads=16, head_dim=64), ("flash", "cuda:flash")),
    # no Pallas block rule: an untiled S runs the kernel, never plain
    (dict(seq=100, n_heads=16, head_dim=128), ("flash", "cuda:flash")),
    (dict(seq=32, n_heads=16, n_kv_heads=4, head_dim=128),
     ("flash", "cuda:flash")),
    (dict(seq=128, platform="cpu"), ("xla", "platform:cpu")),
    (dict(seq=128, window=32, platform="cpu"), ("xla", "platform:cpu")),
    (dict(seq=128, impl="xla"), ("xla", "explicit:xla")),
    (dict(seq=128, window=32, impl="xla"), ("xla", "explicit:xla")),
    (dict(seq=100, impl="kernel", n_heads=4), ("flash", "cuda:flash")),
    (dict(seq=100, impl="flash"), ("flash", "explicit:flash")),
])
def test_prefill_rows(kw, expect):
    kw = {"platform": "cuda", **kw}
    assert registry.decide(registry.KIND_PREFILL, **kw) == expect


@pytest.mark.parametrize("kw,expect", [
    (dict(platform="cuda"), ("paged", "auto:paged")),
    (dict(platform="cuda", impl="paged"), ("paged", "explicit:paged")),
    (dict(platform="cpu"), ("xla", "platform:cpu")),
    (dict(platform="cpu", impl="xla"), ("xla", "explicit:xla")),
])
def test_paged_rows(kw, expect):
    assert registry.decide(registry.KIND_PAGED, **kw) == expect


@pytest.mark.parametrize("kind,kw", [
    ("prefill", dict(impl="splash", seq=4096, platform="cuda")),
    ("prefill", dict(impl="flash", platform="cpu")),
    ("prefill", dict(impl="splash", window=8, platform="cuda")),
    ("prefill", dict(impl="kernel", window=8, platform="cpu")),
    ("prefill", dict(impl="paged", platform="cuda")),
    ("paged", dict(impl="paged", platform="cpu")),
    ("paged", dict(impl="flash", platform="cuda")),
])
def test_explicit_impls_that_cannot_run_raise(kind, kw):
    with pytest.raises(registry.KernelUnavailable):
        registry.decide(kind, **kw)


def test_windowed_config_on_cuda_raises_under_auto():
    """The plain path never runs on the card unasked: a window the flash
    kernels cannot honour (one without causal masking) raises under auto
    instead of degrading, and counts nothing; a causal window runs the
    banded kernel."""
    registry.reset_fallbacks()
    with pytest.raises(ValueError, match="causal"):
        registry.select_attention(registry.KIND_PREFILL, seq=128, window=8,
                                  platform="cuda", causal=False)
    choice = registry.select_attention(registry.KIND_PREFILL, seq=128,
                                       window=8, platform="cuda")
    assert (choice.impl, choice.reason) == ("flash", "window:flash-banded")
    assert registry.fallback_counts() == {}


def test_auto_degradation_is_counted_under_existing_labels():
    registry.reset_fallbacks()
    choice = registry.select_attention(registry.KIND_PREFILL, seq=64,
                                       platform="cpu")
    assert choice.impl == "xla"
    tpaged.resolve_paged_impl("auto", "cpu")
    counts = registry.fallback_counts()
    assert counts == {("flash", "platform:cpu"): 1,
                      ("paged", "platform:cpu"): 1}
    from tpushare_torch import consts
    assert all(impl in consts.KERNEL_IMPLS for impl, _ in counts)
    registry.reset_fallbacks()
