"""The port's ring attention (``ops/ring_attention``) on the CPU: the
reference's ``tests/test_ring_attention.py`` cases at sp 2 and 4 —
forward and gradients against plain attention (contiguous, zigzag,
GQA under tp, banded at several windows), bf16 inputs, the layout
helpers, ``banded_hops`` and the validation errors — and the forward
against the reference's ring on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpushare.workloads.ops import ring_attention as jring  # noqa: E402
from tpushare.workloads.parallel.mesh import make_mesh as jmake  # noqa: E402
from tpushare_torch.workloads.ops import ring_attention as ring  # noqa: E402
from tpushare_torch.workloads.ops.attention import (  # noqa: E402
    flash_attention_plain)
from tpushare_torch.workloads.parallel.mesh import make_mesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op threads add only their
    synchronisation, and in the suite's xdist run six workers share the
    cores (the module's tests ran ~10x slower there on 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(dp=1, sp=2, tp=1):
    return make_mesh(dp=dp, tp=tp, sp=sp, devices=["cpu"] * (dp * sp * tp))


def qkv(seed, b=4, s=64, h=4, hkv=None, hd=16, dtype=torch.float32,
        grad=False):
    g = np.random.default_rng(seed)
    hkv = hkv or h
    out = []
    for heads in (h, hkv, hkv):
        x = torch.from_numpy(g.standard_normal((b, s, heads, hd)).astype(
            np.float32)).to(dtype)
        out.append(x.requires_grad_(grad))
    return out


def plain(q, k, v, causal=True, window=None):
    return flash_attention_plain(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_plain_attention(sp, causal):
    q, k, v = qkv(0)
    got = ring.make_ring_attention(mesh(dp=8 // sp // 2, sp=sp),
                                   causal=causal)(q, k, v)
    torch.testing.assert_close(got, plain(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_grads_match_plain_attention(zigzag):
    q, k, v = qkv(1, grad=True)
    r = ring.make_ring_attention(mesh(dp=2, sp=4), causal=True,
                                 zigzag=zigzag)
    g_ring = torch.autograd.grad(torch.tanh(r(q, k, v)).sum(), (q, k, v))
    g_ref = torch.autograd.grad(torch.tanh(plain(q, k, v)).sum(), (q, k, v))
    for a, b in zip(g_ring, g_ref):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("tp", [1, 2])
def test_ring_gqa_matches_plain_attention(zigzag, tp):
    q, k, v = qkv(2, s=128, h=4, hkv=2, grad=True)
    r = ring.make_ring_attention(mesh(sp=4, tp=tp), causal=True,
                                 zigzag=zigzag)
    got = r(q, k, v)
    want = plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    g_ring = torch.autograd.grad(got.square().sum(), (q, k, v))
    g_ref = torch.autograd.grad(want.square().sum(), (q, k, v))
    for a, b in zip(g_ring, g_ref):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("sp,window", [(2, 1), (2, 20), (2, 33),
                                       (4, 8), (4, 16), (4, 40), (4, 64)])
def test_banded_ring_matches_plain_attention(sp, window):
    q, k, v = qkv(3)
    r = ring.make_ring_attention(mesh(sp=sp), causal=True, window=window)
    torch.testing.assert_close(r(q, k, v), plain(q, k, v, window=window),
                               rtol=2e-5, atol=2e-5)


def test_banded_ring_grads_match_plain_attention():
    q, k, v = qkv(4, grad=True)
    r = ring.make_ring_attention(mesh(sp=4), causal=True, window=24)
    g_ring = torch.autograd.grad(torch.tanh(r(q, k, v)).sum(), (q, k, v))
    g_ref = torch.autograd.grad(
        torch.tanh(plain(q, k, v, window=24)).sum(), (q, k, v))
    for a, b in zip(g_ring, g_ref):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


def test_banded_hops_equal_the_references():
    for window, s_local, sp in np.ndindex(70, 40, 9):
        if s_local and sp:
            assert ring.banded_hops(window, s_local, sp) == \
                jring.banded_hops(window, s_local, sp)


def test_out_of_band_hops_are_skipped_not_masked(monkeypatch):
    """window <= S/sp: one hop, whatever sp — the merges of the skipped
    hops never run."""
    merges = []
    real = ring._merge
    monkeypatch.setattr(ring, "_merge",
                        lambda *a, **kw: merges.append(1) or real(*a, **kw))
    q, k, v = qkv(5)
    ring.make_ring_attention(mesh(sp=4), causal=True, window=16)(q, k, v)
    # 4 diagonals + one hop into each of ranks 1..3
    assert len(merges) == 4 + 3


@pytest.mark.parametrize("kw,msg", [
    (dict(causal=False, zigzag=True), "zigzag scheduling only applies"),
    (dict(causal=False, window=8), "window requires causal"),
    (dict(window=0), "window must be >= 1"),
    (dict(window=8, zigzag=True), "zigzag must be off"),
])
def test_ring_validation_errors_are_the_references(kw, msg):
    with pytest.raises(ValueError, match=msg):
        ring.make_ring_attention(mesh(sp=2), **kw)
    jmesh = jmake(2, dp=1, tp=1, sp=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match=msg):
        jring.make_ring_attention(jmesh, **kw)


def test_seq_not_divisible_raises():
    q, k, v = qkv(6, s=60)
    with pytest.raises(ValueError, match="ring blocks"):
        ring.make_ring_attention(mesh(sp=4), zigzag=True)(q, k, v)
    with pytest.raises(ValueError, match="ring blocks"):
        ring.make_ring_attention(mesh(sp=8 // 1))(*qkv(6, s=60))


def test_zigzag_split_roundtrip_and_layout_equal_the_references():
    x = np.arange(2 * 32 * 3).reshape(2, 32, 3).astype(np.float32)
    for sp in (1, 2, 4, 8):
        got = ring.zigzag_split(torch.from_numpy(x), sp)
        want = np.asarray(jring.zigzag_split(jnp.asarray(x), sp))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(ring.zigzag_merge(got, sp), torch.from_numpy(x))
    pos = ring.zigzag_split(torch.arange(16), 2, axis=0)
    assert pos.tolist() == [0, 1, 2, 3, 12, 13, 14, 15, 4, 5, 6, 7,
                            8, 9, 10, 11]


def test_bf16_inputs():
    q, k, v = qkv(7, dtype=torch.bfloat16)
    got = ring.make_ring_attention(mesh(sp=4), zigzag=True)(q, k, v)
    assert got.dtype == torch.bfloat16
    want = plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kw", [dict(zigzag=True), dict(window=12),
                                dict(causal=False)])
def test_forward_equals_the_references_ring(kw):
    q, k, v = qkv(8, b=2, s=32)
    jm = jmake(8, dp=2, tp=2, sp=2, devices=jax.devices())
    want = jax.jit(jring.make_ring_attention(jm, **kw))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    got = ring.make_ring_attention(mesh(dp=2, sp=2, tp=2), **kw)(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_shards_form_keys_and_devices():
    """The step's form: dicts keyed (sp rank, tp rank), chunks already
    in the ring's layout, outputs on each chunk's device."""
    m = mesh(sp=2, tp=2)
    r = ring.make_ring_attention(m, zigzag=True, reorder=False)
    q, k, v = (ring.zigzag_split(x, 2) for x in qkv(9, b=2, s=32))
    split = [{(s, t): x[:, s * 16:(s + 1) * 16, t * 2:(t + 1) * 2]
              .contiguous() for s in range(2) for t in range(2)}
             for x in (q, k, v)]
    out = r.shards(*split)
    assert sorted(out) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    whole = r(q, k, v)
    for (s, t), o in out.items():
        assert o.device == m.device(sp=s, tp=t)
        assert torch.equal(o, whole[:, s * 16:(s + 1) * 16,
                                    t * 2:(t + 1) * 2])
