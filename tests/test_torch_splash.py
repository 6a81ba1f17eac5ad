"""The port's splash attention (K6) against the JAX reference on the CPU.

The reference runs its registry-built upstream splash kernel in Pallas
interpret mode (``platform="cpu"``), as its own tests do; the port runs
its plain twins (a CPU tensor never reaches a kernel). The CUDA kernels
are held against these twins in tests/test_torch_kernels.py and by
chip_smoke.py, on a GPU.

- schedules: the port's forward and dK/dV block schedules equal the
  upstream ``process_mask`` / ``process_mask_dkv`` block masks; the
  block edge equals the reference's ``_splash_block``;
- forward and LSE: ``splash_attention`` against the reference's splash
  (f32 within 2e-5, the reference's own parity tolerance; bf16 within
  1e-2 of max(|x|, 2^-8 x scale)), the LSE against the upstream kernel's
  residual within 1e-5;
- backward: autograd through the port's ``SplashAttention`` against
  ``jax.vjp`` of the reference's splash with the same cotangent (f32
  within 1e-4 of each gradient's scale, bf16 within 2e-2);
- registry: the port's ``decide`` equals the reference's on every row
  that involves splash, refusals included; the fallback attribution
  and the long untiled row (ROADMAP §C, PR 5);
- the slice: model logits, loss gradients and one train step through
  the splash op against the reference under ``attn_impl="splash"``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.splash_attention import (  # noqa: E402
    splash_attention_kernel as upstream)
from jax.experimental.pallas.ops.tpu.splash_attention import (  # noqa: E402
    splash_attention_mask as umask)
from jax.experimental.pallas.ops.tpu.splash_attention import (  # noqa: E402
    splash_attention_mask_info as uinfo)

from tpushare.workloads import train as jtrain  # noqa: E402
from tpushare.workloads.models import transformer as jt  # noqa: E402
from tpushare.workloads.ops import registry as jreg  # noqa: E402
from tpushare.workloads.parallel.mesh import make_mesh  # noqa: E402
from tpushare_torch.workloads import bridge, train  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.ops import registry  # noqa: E402
from tpushare_torch.workloads.ops import splash_attention as sa  # noqa: E402
from tpushare_torch.workloads.ops import splash_mask  # noqa: E402

# forward: f32 at the reference's own splash parity tolerance
# (tests/test_kernel_registry.py); bf16 one output rounding (2^-7 of the
# value) apart at most, held element by element above a floor of 2^-8 of
# the output's scale
FWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
FWD_FLOOR = 2 ** -8
# the LSE is fp32 from fp32 scores on both sides
LSE_TOL = 1e-5
# gradients as a share of each gradient's largest magnitude: f32 differs
# in summation order; bf16 in where the two frameworks round (both round
# p and ds to bf16, but from scores summed in another order)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the slice in f32: logits and gradients (share of each leaf's scale),
# loss; the train step's loss and params at tests/test_torch_train.py's
# f32 tolerance. Params after one AdamW step: the first Adam update is
# g / (|g| + eps), so an element whose gradient lies within summation
# noise of 0 may step elsewhere (5 of the 524,288 w1 elements here, at
# |g| ~ 3e-9 against a gradient scale of 0.036, up to 1.5e-4 apart): so
# every element within 2 lr and all but STEP_SHARE of them within
# STEP_TOL, chip_smoke.py's rule for its f32 train steps.
LOGIT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-4, 1e-4, 1e-5, 1e-5
STEP_SHARE, LR = 1e-4, 3e-4
HD = 128


def qkv_np(seed, B, S, H, hd=HD, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(n)]


def ref_splash(S, H):
    """The reference registry's splash op (interpret mode on the CPU)."""
    return jreg.select_attention("prefill", impl="splash", seq=S,
                                 n_heads=H, n_kv_heads=H, head_dim=HD,
                                 platform="cpu").fn


def to_jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def dense(sched):
    """The (n, n) kinds a schedule encodes, [row, block]."""
    offsets = sched.offsets.numpy()
    n = offsets.shape[0] - 1
    out = np.zeros((n, n), np.int8)
    for r in range(n):
        sl = slice(offsets[r], offsets[r + 1])
        out[r, sched.blocks.numpy()[sl]] = sched.kinds.numpy()[sl]
    return out


def test_splash_block_matches_the_reference():
    for S in range(128, 8192 + 1, 128):
        assert splash_mask.splash_block(S) == jreg._splash_block(S), S


@pytest.mark.parametrize("S", [384, 1024, 4224])
def test_schedules_match_upstream_mask_info(S):
    block = jreg._splash_block(S)
    mask = umask.MultiHeadMask([umask.CausalMask((S, S))] * 2)
    fwd_info, _ = uinfo.process_mask(mask, (block, block))
    dkv_info, _ = uinfo.process_mask_dkv(mask, (block, block))
    fwd = splash_mask.fwd_schedule(S, "cpu")
    dkv = splash_mask.dkv_schedule(S, "cpu")
    assert fwd.block == dkv.block == block
    # upstream deduplicates the identical head masks into one
    np.testing.assert_array_equal(dense(fwd),
                                  np.asarray(fwd_info.block_mask)[0])
    np.testing.assert_array_equal(dense(dkv).T,
                                  np.asarray(dkv_info.block_mask)[0])
    for sched in (fwd, dkv):
        offsets = sched.offsets.numpy()
        for r in range(len(offsets) - 1):
            blocks = sched.blocks.numpy()[offsets[r]:offsets[r + 1]]
            assert (np.diff(blocks) > 0).all()
        assert sched.offsets.dtype == sched.blocks.dtype == torch.int32
    assert splash_mask.fwd_schedule(S, "cpu") is fwd       # cached


# ---------------------------------------------------------------------------
# forward, LSE, backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [384, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(S, dtype):
    q, k, v = qkv_np(S, 2, S, 2)
    ref = as_np(ref_splash(S, 2)(*(to_jax(x, dtype) for x in (q, k, v))))
    got = sa.splash_attention(*(to_torch(x, dtype) for x in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    got = as_np(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=FWD_TOL[dtype],
                                   atol=FWD_TOL[dtype])
    else:
        floor = np.maximum(np.abs(ref), FWD_FLOOR * np.abs(ref).max())
        assert (np.abs(got - ref) / floor).max() <= FWD_TOL[dtype]


@pytest.mark.parametrize("S", [384, 1024])
def test_lse_matches_the_upstream_residual(S):
    q, k, v = qkv_np(S + 1, 2, S, 2)
    block = jreg._splash_block(S)
    kernel = upstream.make_splash_mha(
        umask.MultiHeadMask([umask.CausalMask((S, S))] * 2),
        head_shards=1, q_seq_shards=1, save_residuals=True, interpret=True,
        block_sizes=upstream.BlockSizes(block_q=block, block_kv=block,
                                        block_kv_compute=block))
    qs = sa.prescale(torch.from_numpy(q))
    _, (lse,) = jax.vmap(kernel)(
        *(jnp.asarray(x).transpose(0, 2, 1, 3)
          for x in (qs.numpy(), k, v)))
    _, got = sa.splash_attention_plain(qs, torch.from_numpy(k),
                                       torch.from_numpy(v), with_lse=True)
    assert got.shape == (2, 2, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(lse), atol=LSE_TOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_the_reference_vjp(dtype):
    S = 384
    q, k, v, do = qkv_np(7, 2, S, 2, n=4)
    ref_out, vjp = jax.vjp(ref_splash(S, 2),
                           *(to_jax(x, dtype) for x in (q, k, v)))
    ref_grads = vjp(to_jax(do, dtype))
    leaves = [to_torch(x, dtype).requires_grad_() for x in (q, k, v)]
    out = sa.splash_attention(*leaves)
    out.backward(to_torch(do, dtype))
    for name, leaf, ref in zip("qkv", leaves, ref_grads):
        assert leaf.grad.dtype == leaf.dtype
        ref = as_np(ref)
        err = np.abs(as_np(leaf.grad) - ref).max() / np.abs(ref).max()
        assert err <= BWD_TOL[dtype], (name, err)


def test_the_backward_twin_rounds_p_and_ds_to_the_input_dtype():
    """In bf16 the twin's dV is round(p)^T dO, as the upstream dkv kernel
    computes it, not p^T dO."""
    q, k, v, do = (to_torch(x, "bfloat16") for x in qkv_np(3, 1, 256, 2,
                                                            n=4))
    qs = sa.prescale(q)
    o, lse = sa.splash_attention_plain(qs, k, v, with_lse=True)
    _, _, dv = sa.splash_attention_bwd_plain(qs, k, v, o, lse, do)
    p = torch.exp(sa._scores(qs, k) - lse[..., None])
    rounded = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(),
                           do.float()).bfloat16()
    unrounded = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).bfloat16()
    assert torch.equal(dv, rounded)
    assert not torch.equal(dv, unrounded)


def test_cpu_tensors_never_load_a_splash_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(build, "library", refuse)
    before = dict(build.LAUNCHES)
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in qkv_np(4, 1, 256, 2)]
    sa.splash_attention(*leaves).sum().backward()
    with torch.no_grad():
        sa.splash_attention(*leaves)
    assert all(leaf.grad is not None for leaf in leaves)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("shape,what", [
    (dict(Hkv=1), "MHA only"),
    (dict(hd=64), "head_dim"),
    (dict(S=200), "does not tile"),
])
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(shape, what):
    B, S, H, Hkv, hd = 1, shape.get("S", 256), 2, shape.get("Hkv", 2), \
        shape.get("hd", HD)
    qs = torch.zeros((B, S, H, hd))
    kv = torch.zeros((B, S, Hkv, hd))
    with pytest.raises(ValueError, match=what):
        sa._kernel_shape(qs, kv, kv)


# ---------------------------------------------------------------------------
# registry rows
# ---------------------------------------------------------------------------

def _outcome(decide, **kw):
    try:
        return decide("prefill", **kw)
    except (jreg.KernelUnavailable, registry.KernelUnavailable) as e:
        return ("refused", e.impl, e.detail)


def _involves_splash(outcome, impl):
    return impl == "splash" or outcome[1] in ("longctx:splash",
                                              "shape:flash")


@pytest.mark.parametrize("seq", [4095, 4096, 4100, 4224, 8192])
def test_decide_matches_the_reference_on_the_splash_rows(seq):
    """Every grid point where the reference's answer involves splash
    (an explicit ``splash``, its refusals, ``longctx:splash``,
    ``shape:flash``): the port answers the same, "cuda" for "tpu"."""
    compared = 0
    for n_kv in (16, 4):
        for hd in (64, 128, 256):
            for window in (None, 128):
                for impl in ("auto", "kernel", "splash"):
                    kw = dict(seq=seq, n_heads=16, n_kv_heads=n_kv,
                              head_dim=hd, window=window, impl=impl)
                    ref = _outcome(jreg.decide, platform="tpu", **kw)
                    if not _involves_splash(ref, impl):
                        continue
                    got = _outcome(registry.decide, platform="cuda", **kw)
                    assert got == ref, kw
                    compared += 1
    assert compared


@pytest.mark.parametrize("kw,want", [
    (dict(seq=4096, head_dim=128), ("splash", "platform:cpu")),
    (dict(seq=8192, head_dim=256), ("splash", "platform:cpu")),
    (dict(seq=4096, head_dim=64), ("flash", "platform:cpu")),
    (dict(seq=4100, head_dim=128), ("flash", "platform:cpu")),
    (dict(seq=4096, head_dim=128, n_kv_heads=4), ("flash", "platform:cpu")),
    (dict(seq=2048, head_dim=128), ("flash", "platform:cpu")),
])
def test_auto_fallback_is_charged_like_the_reference(kw, want):
    """Fault 1 (ROADMAP §C, PR 5): an auto fallback at a shape splash can
    serve is charged to splash, as the reference charges it."""
    kw = {"n_heads": 16, "n_kv_heads": 16, **kw}
    jreg.reset_fallbacks()
    registry.reset_fallbacks()
    jreg.select_attention("prefill", platform="cpu", **kw)
    choice = registry.select_attention("prefill", platform="cpu", **kw)
    assert choice.impl == "xla"
    assert registry.fallback_counts() == jreg.fallback_counts() == {want: 1}
    jreg.reset_fallbacks()
    registry.reset_fallbacks()


def test_a_long_untiled_sequence_runs_flash_not_splash():
    """Fault 2 (ROADMAP §C, PR 5): the long-context row checks the splash
    tiling gate; seq 4100 is not a multiple of 128."""
    kw = dict(seq=4100, n_heads=16, n_kv_heads=16, head_dim=128,
              impl="kernel")
    assert registry.decide("prefill", platform="cuda", **kw) == \
        jreg.decide("prefill", platform="tpu", **kw) == ("flash",
                                                        "shape:flash")
    choice = registry.select_attention("prefill", platform="cuda", **kw)
    assert choice.fn.func is registry.flash_attention


def test_the_splash_row_returns_the_splash_op():
    choice = registry.select_attention("prefill", seq=4096, n_heads=16,
                                       n_kv_heads=16, head_dim=128,
                                       platform="cuda")
    assert (choice.impl, choice.reason) == ("splash", "longctx:splash")
    assert choice.fn is sa.splash_attention
    with pytest.raises(ValueError, match="causal attention only"):
        registry.select_attention("prefill", seq=4096, n_heads=16,
                                  head_dim=128, platform="cuda",
                                  causal=False)
    with pytest.raises(registry.KernelUnavailable, match="CUDA device"):
        registry.decide("prefill", seq=4096, n_heads=16, head_dim=128,
                        impl="splash", platform="cpu")


# ---------------------------------------------------------------------------
# the slice: model, loss gradients, one train step
# ---------------------------------------------------------------------------

SLICE = dict(vocab=256, d_model=512, n_heads=4, n_layers=2, d_ff=512,
             max_seq=384)
SLICE_B, SLICE_S = 1, 384


def slice_setup(seed):
    # the reference caches the splash kernel it builds inside the scanned
    # forward's trace, so a later trace must not reuse that build
    jreg.clear_build_cache()
    jcfg = jt.TransformerConfig(**SLICE, dtype=jnp.float32,
                                attn_impl="splash")
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    tcfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32,
                                   "attn_impl": None})
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, SLICE["vocab"], (SLICE_B, SLICE_S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def splash_core(q, k, v, cfg):
    """The port's attention core pinned to the splash op (on a CPU
    tensor: its twins), as the reference's ``attn_impl="splash"`` pins
    it; the port's registry refuses explicit splash on the CPU."""
    return sa.splash_attention(q, k, v)


def test_model_logits_match_the_reference():
    jcfg, tcfg, jparams, tparams, tokens = slice_setup(0)
    ref = np.asarray(jt.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tt.forward(tparams, torch.from_numpy(tokens), tcfg,
                     attn_fn=sa.splash_attention)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_loss_gradients_match_the_reference():
    jcfg, tcfg, jparams, tparams, tokens = slice_setup(1)
    targets = np.roll(tokens, -1, axis=1)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    leaves = train.tree_map(lambda p: p.requires_grad_(), tparams)
    loss = tt.loss_fn(leaves, torch.from_numpy(tokens),
                      torch.from_numpy(targets), tcfg,
                      attn_fn=sa.splash_attention)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * max(1.0,
                                                             float(jloss))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, ref in flat:
        node = leaves
        for key in path:
            node = node[key.key]
        ref = np.asarray(ref)
        err = np.abs(node.grad.numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_TOL, (path, err)


def test_one_train_step_matches_the_reference(monkeypatch):
    jcfg, tcfg, jparams, tparams, tokens = slice_setup(2)
    targets = np.roll(tokens, -1, axis=1)
    mesh = make_mesh(1, dp=1, tp=1, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jtrain.place_state(jtrain.init_state(jparams, jopt), mesh)
    jstate, jloss = jtrain.make_train_step(jcfg, jopt, mesh)(
        jstate, jnp.asarray(tokens), jnp.asarray(targets))
    monkeypatch.setattr(tt, "attention", splash_core)
    topt = train.make_optimizer(lr=LR)
    tstate, tloss = train.make_train_step(tcfg, topt, "cpu")(
        train.init_state(tparams, topt), torch.from_numpy(tokens),
        torch.from_numpy(targets))
    assert abs(tloss.item() - float(jloss)) <= STEP_TOL * max(
        1.0, float(jloss))
    flat = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    off = total = 0
    for path, ref in flat:
        node = tstate["params"]
        for key in path:
            node = node[key.key]
        ref = np.asarray(ref)
        diff = np.abs(node.numpy() - ref)
        assert diff.max() <= 2 * LR, path
        off += int((diff > STEP_TOL + STEP_TOL * np.abs(ref)).sum())
        total += ref.size
    assert off <= STEP_SHARE * total, off
