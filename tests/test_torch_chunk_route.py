"""The cached chunk's read: the registry's chunk kind and the routing of
``decode.make_cached_attn_core``, on the CPU.

On the card a chunk of Q >= 2 queries at one position for the batch,
over a dense bf16 cache with no window, at a head_dim the flash kernel
takes and grouped heads, runs the offset flash kernel; every other input
keeps the reference's einsum core. Here each rule is held to the route
it chooses and the reason the registry records, the core is run with
the registry's platform set to the CPU's and the kernel replaced by a
recorder (so the core's own inputs reach the rule), and the einsum core
is held bitwise to the code it replaced. The kernel itself is tested on
the card (``tests/test_torch_chunk_kernel.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads import decode  # noqa: E402
from tpushare_torch.workloads.models.transformer import (  # noqa: E402
    TransformerConfig)
from tpushare_torch.workloads.ops import attention  # noqa: E402
from tpushare_torch.workloads.ops import registry as R  # noqa: E402


@pytest.fixture(autouse=True)
def _no_fallbacks():
    R.reset_fallbacks()
    yield
    R.reset_fallbacks()


CHUNK = dict(seq=256, n_heads=32, n_kv_heads=8, head_dim=128,
             platform="cuda", dtype=torch.bfloat16)

# name: the rule's inputs over CHUNK -> (impl, reason, counted)
ROUTES = {
    "chunk": ({}, ("flash", "auto:flash-chunk", False)),
    "two-queries": ({"seq": 2}, ("flash", "auto:flash-chunk", False)),
    "single-token": ({"seq": 1}, ("xla", "chunk:single-token", False)),
    "per-row-pos": ({"seq": 1, "per_row": True},
                    ("xla", "pos:per-row", False)),
    "int8-cache": ({"codec": "int8"}, ("xla", "codec:int8", True)),
    "window": ({"window": 64}, ("xla", "window:ring-cache", True)),
    "f32": ({"dtype": torch.float32}, ("xla", "dtype:float32", True)),
    "f16": ({"dtype": torch.float16}, ("xla", "dtype:float16", True)),
    "cpu-tensor": ({"platform": "cpu"}, ("xla", "platform:cpu", False)),
    "odd-head-dim": ({"head_dim": 80}, ("xla", "head_dim:flash-set", True)),
    "ungrouped-heads": ({"n_heads": 6, "n_kv_heads": 4},
                        ("xla", "heads:ungrouped", True)),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_chunk_rule_picks_its_route_and_names_its_reason(name):
    over, (impl, reason, counted) = ROUTES[name]
    choice = R.select_attention(R.KIND_CHUNK, **{**CHUNK, **over})
    assert (choice.kind, choice.impl, choice.reason) == ("chunk", impl,
                                                         reason)
    assert R.decide(R.KIND_CHUNK, **{**CHUNK, **over}) == (impl, reason)
    if impl == "flash":
        assert choice.fn is attention.flash_chunk_attention
    else:
        assert choice.fn is None
    want = {f"flash:{reason}": 1} if counted else {}
    assert R.fallback_counts_flat() == want


def test_the_chunk_rule_takes_no_knob():
    for impl in ("flash", "kernel", "xla"):
        with pytest.raises(R.KernelUnavailable, match="inputs alone"):
            R.decide(R.KIND_CHUNK, impl=impl, **CHUNK)
    with pytest.raises(ValueError, match="codec"):
        R.decide(R.KIND_DECODE, codec="int8", seq=512, head_dim=128)


# ---------------------------------------------------------------------------
# the core's inputs reach the rule
# ---------------------------------------------------------------------------

CFG = TransformerConfig(vocab=64, d_model=128, n_heads=4, n_kv_heads=2,
                        n_layers=1, d_ff=64, max_seq=64,
                        dtype=torch.bfloat16)
ROWS = 48   # cache rows: past every chunk's pos + Q (a page-rounded scratch)


def plain_chunk(q, k, v, pos):
    """fp32 attention of q (B, Q, H, hd) at pos .. pos+Q-1 against the
    first pos + Q rows of k / v, key j kept for query i when
    j <= pos + i."""
    B, Q, H, hd = q.shape
    n = pos + Q
    kf, vf = (x[:, :n].float().repeat_interleave(H // x.shape[2], dim=2)
              for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    keep = torch.arange(n)[None, :] <= pos + torch.arange(Q)[:, None]
    p = torch.softmax(torch.where(keep, s, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def core_inputs(seed, cfg, B, Q, pos, int8=False):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    shape = (B, ROWS, cfg.kv_heads, cfg.head_dim)
    if int8:
        kc, vc = (decode.kv_quantize(randn(*shape)) for _ in range(2))
    else:
        kc, vc = (randn(*shape).to(cfg.dtype) for _ in range(2))
    q = randn(B, Q, cfg.n_heads, cfg.head_dim).to(cfg.dtype)
    k, v = (randn(B, Q, cfg.kv_heads, cfg.head_dim).to(cfg.dtype)
            for _ in range(2))
    return q, k, v, kc, vc


# name: (config over CFG, B, Q, pos (None: per-row), int8) -> kernel?
CORE_CASES = {
    "chunk-at-0": ({}, 1, 16, 0, False, True),
    "chunk-after-a-prefix": ({}, 2, 8, 21, False, True),
    "two-queries": ({}, 1, 2, 5, False, True),
    "single-token": ({}, 2, 1, 7, False, False),
    "per-row-pos": ({}, 3, 1, None, False, False),
    "int8-cache": ({}, 1, 16, 0, True, False),
    "window": ({"attn_window": 8}, 1, 16, 0, False, False),
    "f32": ({"dtype": torch.float32}, 1, 16, 0, False, False),
    "odd-head-dim": ({"d_model": 160}, 1, 16, 0, False, False),
}


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_the_core_hands_the_rule_its_own_inputs(monkeypatch, name):
    """The core routes by what its tensors and config show: with the
    registry's platform set to the CPU's, a chunk reaches the (recorded)
    kernel with the cache views themselves and its int ``pos``, and the
    result is what the einsum core gives; every other input runs the
    einsum core, charged to the kernel when it is a chunk."""
    over, B, Q, pos, int8, kernel = CORE_CASES[name]
    cfg = dataclasses.replace(CFG, **over)
    q, k, v, kc, vc = core_inputs(3, cfg, B, Q, pos, int8)
    if pos is None:
        pos = torch.tensor([3, 17, 40][:B])
    calls = []

    def recorder(q_, k_, v_, pos_):
        calls.append((k_ is kc, v_ is vc, pos_))
        return plain_chunk(q_, k_, v_, pos_)

    monkeypatch.setattr(R, "PLATFORM", "cpu")
    monkeypatch.setattr(R, "flash_chunk_attention", recorder)
    slot_ids = torch.arange(ROWS)
    got, _ = decode.make_cached_attn_core(kc, vc, pos, cfg, slot_ids)(q, k, v)
    want = decode.cached_attn_einsum(q, kc, vc, pos, cfg, slot_ids)
    if kernel:
        assert calls == [(True, True, pos)]
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert R.fallback_counts_flat() == {}
    else:
        assert calls == []
        assert torch.equal(got, want)
        reason = R.decide(
            R.KIND_CHUNK, seq=Q, window=cfg.attn_window,
            n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, platform="cpu",
            codec="int8" if int8 else None,
            dtype=decode.kv_data(kc).dtype, per_row=torch.is_tensor(pos))[1]
        counted = reason not in R.CHUNK_DECODE_STEPS
        assert R.fallback_counts_flat() == (
            {f"flash:{reason}": 1} if counted else {})


def test_a_cpu_tensor_counts_nothing():
    """Off the card the einsum core is the reference's own read, whose
    telemetry counts nothing: no fallback is recorded for any input."""
    for over, B, Q, pos, int8, _ in CORE_CASES.values():
        cfg = dataclasses.replace(CFG, **over)
        q, k, v, kc, vc = core_inputs(4, cfg, B, Q, pos, int8)
        if pos is None:
            pos = torch.tensor([3, 17, 40][:B])
        decode.make_cached_attn_core(kc, vc, pos, cfg,
                                     torch.arange(ROWS))(q, k, v)
    assert R.fallback_counts_flat() == {}


# ---------------------------------------------------------------------------
# the einsum core, bitwise as before
# ---------------------------------------------------------------------------

def einsum_core_before(kc, vc, pos, cfg, slot_ids):
    """``make_cached_attn_core`` as it was before the chunk kind, op for
    op: the bitwise yardstick of the einsum core on the CPU."""
    hd = cfg.head_dim
    G = cfg.n_heads // cfg.kv_heads
    per_row = torch.is_tensor(pos)
    quantized = isinstance(kc, dict)
    Rr = slot_ids.shape[0]
    ring = cfg.attn_window is not None

    def write(cache, new):
        Q = new.shape[1]
        wpos = pos % Rr if ring else pos
        if per_row:
            rows = torch.arange(new.shape[0], device=new.device)
            return decode.scatter_token_rows(cache, new, (rows, wpos))
        if wpos + Q > Rr:
            wrows = (pos + torch.arange(Q, device=new.device)) % Rr
            return decode.kv_store(cache, (slice(None), wrows), new)
        return decode.kv_store(cache, (slice(None), slice(wpos, wpos + Q)),
                               new)

    def attn_core(q, k, v):
        B, Q = q.shape[:2]
        write(kc, k)
        write(vc, v)
        if per_row:
            qpos = pos[:, None, None]
        else:
            qpos = (pos + torch.arange(Q, device=q.device))[None, :, None]
        if ring:
            p = qpos - ((qpos - slot_ids[None, None, :]) % Rr)
            mask = (p >= 0) & (p > qpos - cfg.attn_window)
        else:
            mask = slot_ids[None, None, :] <= qpos
        kmat, vmat = decode.kv_data(kc).float(), decode.kv_data(vc).float()
        qg = q.float().reshape(B, Q, kmat.shape[2], G, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmat) * (hd ** -0.5)
        if quantized:
            s = s * decode.kv_scale_bhgqk(kc["s"])
        s = torch.where(mask[:, None, None, :, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        if quantized:
            p = p * decode.kv_scale_bhgqk(vc["s"])
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vmat)
        return o.reshape(B, Q, cfg.n_heads, hd).to(q.dtype), (kc, vc)

    return attn_core


def _copy(leaf):
    if isinstance(leaf, dict):
        return {n: t.clone() for n, t in leaf.items()}
    return leaf.clone()


@pytest.mark.parametrize("name", sorted(CORE_CASES) + ["ring-wrap"])
def test_the_einsum_core_on_the_cpu_is_bitwise_as_before(name):
    """Every input, the kernel's chunks included, gives on the CPU
    exactly the bits and the cache writes the einsum core gave before."""
    if name == "ring-wrap":
        over, B, Q, pos, int8 = {"attn_window": 40}, 1, 8, 44, False
    else:
        over, B, Q, pos, int8, _ = CORE_CASES[name]
    cfg = dataclasses.replace(CFG, **over)
    q, k, v, kc, vc = core_inputs(5, cfg, B, Q, pos, int8)
    if pos is None:
        pos = torch.tensor([3, 17, 40][:B])
    slot_ids = torch.arange(ROWS)
    kc2, vc2 = _copy(kc), _copy(vc)
    got, _ = decode.make_cached_attn_core(kc, vc, pos, cfg, slot_ids)(q, k, v)
    want, _ = einsum_core_before(kc2, vc2, pos, cfg, slot_ids)(q, k, v)
    assert torch.equal(got, want)
    for a, b in ((kc, kc2), (vc, vc2)):
        for x, y in zip(decode.kv_planes(a), decode.kv_planes(b)):
            assert torch.equal(x, y)


SERVE_FLAGS = ["--device", "cpu", "--mode", "serve", "--steps", "6",
               "--requests", "3", "--seq", "40", "--slots", "2"]


SERVE_ENGINES = {"slot": [], "paged": ["--paged"],
                 "disaggregated-fleet": ["--paged", "--fleet", "2",
                                         "--disaggregate"]}


@pytest.mark.parametrize("engine", sorted(SERVE_ENGINES))
def test_serve_traffic_records_every_admission_chunk(engine):
    """``infer.serve_traffic`` returns the admission chunks of its warm-up
    request and of the run together (``prefill_chunks``): the count the
    smoke's serving phases hold the chunk kernel's launches to, a layer
    each."""
    from tpushare_torch.workloads import infer
    res = infer.run(infer.parse_args(SERVE_FLAGS + SERVE_ENGINES[engine]))
    eng = res["engine"]
    member = eng.engines[0] if hasattr(eng, "engines") else eng
    plen = len(res["requests"][0].prompt)
    per_prompt = len(member._prefill_chunks(plen))
    assert per_prompt >= 1
    assert res["prefill_chunks"] == (1 + len(res["requests"])) * per_prompt
