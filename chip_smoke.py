#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain-PyTorch twin at the shapes the main paths give
it, then drives the two main paths through the payload entry point at
the flagship preset's full width (1.2B parameters, random weights from a
seed):

- ``infer --mode forward`` (batch 8, seq 128) — flash-forward kernel;
- ``infer --mode decode`` (batch 8, a 32-token prompt) — the flash
  kernel on a prefill that fits no Pallas block;
- ``infer --mode serve --paged`` (16 requests, 8 lanes, prompt 128, up
  to 128 new tokens, greedy) — paged-decode kernel, one launch per layer
  per decode step;

with each kernel's launch count zeroed just before its path runs and
read just after, so the run shows the path went through the kernel.
It prints one line per phase, a ``{"kernels": [...]}`` JSON line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without a CUDA device, or outside the repo
checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain twin: bf16 outputs round once at the end of a tiled
# online softmax vs an einsum/softmax chain; fp32 only reorders sums
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# full-model logits, kernel path vs plain path, bf16: each layer's bf16
# rounding of the attention output compounds over 16 layers; held to a
# fraction of the logit scale. On an H100 the sound reading is 0.0140
# (flagship, seed 3, B=1, S=512; the same in every run: both paths are
# deterministic). The control — the kernel's output rounded to b
# significant bits where bf16 keeps 8 — read 0.0205 / 0.0232 / 0.0318 /
# 0.0592 at b = 7 / 6 / 5 / 4. The 5-bit control must land above the
# limit, which shows the check tells a kernel that loses precision.
LOGIT_TOL = 2e-2
CONTROL_BITS = 5


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call over ``reps`` back-to-back calls,
    from CUDA events between the calls. The stream is first held busy
    (``torch.cuda._sleep``) for longer than the host needs to enqueue
    every call, so the events time the device work and not the host's
    launch overhead, which at these sizes can exceed the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    # ~2 GHz SM clock: hold the stream for twice the enqueue time
    torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def bound_ms(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the dtype's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase(name: str, **fields) -> None:
    body = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in fields.items())
    print(f"phase {name}: {body}", flush=True)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(label: str, got, want, dtype: str) -> float:
    import torch
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{label}: {m}")
    return max_err(got, want)


# ---------------------------------------------------------------------------
# phase 2: flash kernel against its plain twin
# ---------------------------------------------------------------------------

def flash_cases(torch):
    from tpushare_torch.workloads.ops.attention import (flash_attention,
                                                        flash_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (label, B, S, H, Hkv, hd, dtype)
        ("main-path", 8, 128, 16, 16, 128, "bfloat16"),
        ("flagship", 2, 128, 16, 16, 128, "bfloat16"),
        ("flagship", 2, 512, 16, 16, 128, "bfloat16"),
        ("flagship", 2, 2048, 16, 16, 128, "bfloat16"),
        ("gqa", 2, 512, 16, 4, 128, "bfloat16"),
        ("hd64", 2, 512, 16, 16, 64, "bfloat16"),
        ("odd-S", 2, 300, 16, 16, 128, "bfloat16"),
        ("flagship", 2, 512, 16, 16, 128, "float32"),
        ("gqa-hd64-odd", 1, 77, 4, 2, 64, "float32"),
    ]
    rows = []
    for label, B, S, H, Hkv, hd, dtype in cases:
        dt = getattr(torch, dtype)

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rn(B, S, H, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = check_close(f"flash {label} {B}x{S}x{H}/{Hkv}x{hd} {dtype}",
                          got, flash_attention_plain(q, k, v), dtype)
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=Hkv != H))
        elem = q.element_size()
        n_bytes = elem * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
        flops = 4 * B * H * hd * S * (S + 1) // 2     # causal pairs only
        bms, by = bound_ms(n_bytes, flops, dtype)
        row = dict(case=label, B=B, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dtype,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=sdpa_ms, bound_ms=bms, bound_by=by)
        phase("flash-vs-plain", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3: paged kernel against its plain twin
# ---------------------------------------------------------------------------

def paged_cases(torch):
    from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                              xla_paged_read)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # (label, B, H, Hkv, hd, ps, table width, max kv_len, dtype)
        ("main-path", 8, 16, 16, 128, 32, 8, 256, "bfloat16"),
        ("flagship-2k", 8, 16, 16, 128, 32, 64, 2048, "bfloat16"),
        ("flagship-2k", 8, 16, 16, 128, 32, 64, 2048, "float32"),
        ("gqa-2k", 8, 16, 4, 128, 32, 64, 2048, "bfloat16"),
    ]
    rows = []
    for label, B, H, Hkv, hd, ps, P, max_len, dtype in cases:
        dt = getattr(torch, dtype)
        n_pages = B * P + 1

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        kp, vp = rn(n_pages, ps, Hkv, hd), rn(n_pages, ps, Hkv, hd)
        tables = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                  [:B * P].reshape(B, P) + 1).to(torch.int32)
        tables[1, :P // 2] = tables[0, :P // 2]     # aliased prefix pages
        kv_lens = torch.randint(max_len // 2 + 1, max_len + 1, (B,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
        q1 = rn(B, H, hd)
        got = paged_decode(q1, kp, vp, tables, kv_lens)
        torch.cuda.synchronize()

        def plain():
            return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                                  H, Hkv)[:, 0]
        err = check_close(f"paged {label} {dtype}", got, plain(), dtype)
        ms = time_ms(lambda: paged_decode(q1, kp, vp, tables, kv_lens))
        plain_ms = time_ms(plain)
        rows_read = int(kv_lens.sum().item())
        elem = q1.element_size()
        kv_bytes = 2 * rows_read * Hkv * hd * elem
        n_bytes = kv_bytes + 2 * q1.numel() * elem + tables.numel() * 4 \
            + kv_lens.numel() * 4
        flops = 4 * H * hd * rows_read
        bms, by = bound_ms(n_bytes, flops, dtype)
        row = dict(case=label, B=B, H=H, Hkv=Hkv, hd=hd, ps=ps, P=P,
                   dtype=dtype, kv_rows=rows_read, bytes_read=n_bytes,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bms, bound_by=by,
                   gb_per_s=n_bytes / (ms * 1e-3) / 1e9)
        phase("paged-vs-plain", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths at full width
# ---------------------------------------------------------------------------

def round_to_bits(torch, x, bits: int):
    """x rounded to ``bits`` significant bits (bf16 keeps 8)."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e).to(x.dtype)


def forward_rounded(torch, params, tokens, cfg, bits: int):
    """The flagship forward with each layer's kernel output rounded to
    ``bits`` significant bits: the control of the logits check."""
    from tpushare_torch.workloads.models.transformer import (
        attention, embed_lookup, layer_block, layer_params, lm_head,
        rope_tables)
    cos, sin = rope_tables(cfg, tokens.shape[1], tokens.device)

    def attn_core(q, k, v):
        return round_to_bits(torch, attention(q, k, v, cfg), bits), None

    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = layer_block(x, layer_params(params, i), cfg, cos, sin,
                           attn_core)
    return lm_head(params, x)


def forward_path(torch, build, infer):
    from tpushare_torch.workloads.models.transformer import forward
    build.reset_launches()
    res = infer.run(infer.parse_args(
        ["--mode", "forward", "--batch", "8", "--seq", "128", "--steps",
         "10", "--hbm-limit-mib", "80000", "--seed", "0"]))
    launches = dict(build.LAUNCHES)
    cfg, params, logits = res["cfg"], res["params"], res["logits"]
    if cfg.d_model != 2048 or cfg.n_layers != 16:
        raise RuntimeError(f"not the flagship preset: {cfg}")
    if logits.shape != (8, 128, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("forward logits not finite / wrong shape")
    if launches["flash_fwd"] != cfg.n_layers * 11:
        raise RuntimeError(f"flash launches {launches} != 16 layers x 11 "
                           "forwards: the forward did not run the kernel")
    phase("forward", tokens_per_s=res["tokens_per_s"],
          flash_launches=launches["flash_fwd"],
          paged_launches=launches["paged_decode"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                           device="cuda")
    kernel = forward(params, tokens, cfg)
    plain = forward(params, tokens,
                    dataclasses.replace(cfg, attn_impl="xla"))
    scale = plain.abs().max().item()
    err = max_err(kernel, plain)
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    controls = {f"control_rel_err_b{b}":
                max_err(forward_rounded(torch, params, tokens, cfg, b),
                        plain) / scale for b in (7, 6, CONTROL_BITS, 4)}
    phase("forward-logits", max_abs_err=err, logit_scale=scale,
          rel_err=err / scale, tol=LOGIT_TOL, argmax_agreement=agree,
          **controls)
    if not err <= LOGIT_TOL * scale:
        raise RuntimeError(f"kernel-path logits differ by {err} > "
                           f"{LOGIT_TOL} x {scale}")
    if not controls[f"control_rel_err_b{CONTROL_BITS}"] > LOGIT_TOL:
        raise RuntimeError(f"the {CONTROL_BITS}-bit control passes the "
                           "logits check: the limit cannot tell a kernel "
                           "that loses precision")
    return launches, params, cfg


def decode_path(torch, build, infer):
    """``infer --mode decode`` at the flagship: the prompt is seq // 4 =
    32 tokens, not a multiple of any Pallas block, and still prefills
    through the kernel — one launch per layer for each of the payload's
    two ``generate`` calls (warm-up and timed)."""
    build.reset_launches()
    res = infer.run(infer.parse_args(
        ["--mode", "decode", "--batch", "8", "--seq", "128", "--steps",
         "16", "--hbm-limit-mib", "80000", "--seed", "0"]))
    launches = dict(build.LAUNCHES)
    n_layers = infer.pick_config(80000).n_layers
    if launches["flash_fwd"] != 2 * n_layers:
        raise RuntimeError(f"decode flash launches {launches} != 2 "
                           f"generates x {n_layers} layers: the 32-token "
                           "prefill did not run the kernel")
    phase("decode", tokens_per_s=res["tokens_per_s"], prompt=32,
          flash_launches=launches["flash_fwd"],
          paged_launches=launches["paged_decode"])


def serve_path(torch, build, infer):
    build.reset_launches()
    res = infer.run(infer.parse_args(
        ["--mode", "serve", "--paged", "--requests", "16", "--slots", "4",
         "--seq", "512", "--steps", "128", "--hbm-limit-mib", "80000",
         "--seed", "0"]))
    launches = dict(build.LAUNCHES)
    eng, reqs = res["engine"], res["requests"]
    if eng.attn_impl != "paged" or eng.n_lanes != 8:
        raise RuntimeError(f"engine read {eng.attn_impl} lanes {eng.n_lanes}")
    bad = [r.status for r in reqs if r.status != "completed"
           or len(r.output) != r.max_new]
    if bad:
        raise RuntimeError(f"requests not all completed: {bad}")
    if eng.alloc.pages_in_use() != 0 or eng.alloc.leaked() != 0:
        raise RuntimeError("pages leaked after the serving run")
    # every decode step of the run (warm-up request included: the counts
    # were zeroed before it) reads the pool once per layer through the
    # kernel; admission runs chunk_step's einsums, never flash
    steps = res["warmup_decode_steps"] + res["decode_steps"]
    n_layers = eng.cfg.n_layers
    if launches["paged_decode"] != n_layers * steps:
        raise RuntimeError(f"paged launches {launches['paged_decode']} != "
                           f"{n_layers} layers x {steps} decode steps: "
                           "some step read through the plain twin")
    if launches["flash_fwd"]:
        raise RuntimeError(f"the paged engine launched flash: {launches}")
    ttft = res["ttft_s"]
    phase("serve", tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
          seconds=res["seconds"], ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
          ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
          paged_launches=launches["paged_decode"],
          flash_launches=launches["flash_fwd"],
          pages_in_use=eng.alloc.pages_in_use())
    return launches


def small_f32_identity(torch, build):
    """Small f32 config: the kernel-read engine and kernel-prefill
    generate (a 77-token prompt: no tiling needed) are
    greedy-token-identical to their plain-path twins."""
    import numpy as np
    from tpushare_torch.workloads.decode import generate
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=256,
                            dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = init_params(gen, cfg, "cuda")
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, cfg.vocab, int(rng.integers(5, 60))).tolist(),
              int(rng.integers(4, 40))) for _ in range(6)]
    outs = {}
    for impl in ("paged", "xla"):
        eng = PagedServingEngine(params, cfg, n_lanes=3, max_seq=128,
                                 n_pages=40, page_size=16,
                                 prompt_buckets=(16, 64), chunk=4,
                                 attn_impl=impl)
        reqs = [Request(prompt=p, max_new=n) for p, n in specs]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[impl] = [r.output for r in reqs]
    if outs["paged"] != outs["xla"]:
        raise RuntimeError("f32 engine: kernel read != plain read tokens")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 77))).cuda()
    before = build.LAUNCHES["flash_fwd"]
    g_kernel = generate(params, prompt, cfg, 16)
    prefill_launches = build.LAUNCHES["flash_fwd"] - before
    if prefill_launches != cfg.n_layers:
        raise RuntimeError(f"77-token prefill launched flash "
                           f"{prefill_launches} times, not {cfg.n_layers}")
    g_plain = generate(params, prompt,
                       dataclasses.replace(cfg, attn_impl="xla"), 16)
    if not torch.equal(g_kernel, g_plain):
        raise RuntimeError("f32 generate: flash prefill != plain prefill")
    phase("f32-identity", engine_requests=len(specs),
          engine_tokens=sum(len(o) for o in outs["paged"]),
          generate_tokens=int(g_kernel.numel()),
          prefill_flash_launches=prefill_launches, identical=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "tpushare_torch" / "workloads").is_dir():
        print(f"chip_smoke: no tpushare_torch package beside {__file__}; "
              "run it from the repository checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from tpushare_torch.workloads import infer
    from tpushare_torch.workloads.kernels import build

    # fp32 references run in full fp32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0),
          build_s=time.perf_counter() - t0,
          **{f"build_{k}_s": v for k, v in built.items()})

    flash_rows = flash_cases(torch)
    paged_rows = paged_cases(torch)
    fwd_launches, _, _ = forward_path(torch, build, infer)
    decode_path(torch, build, infer)
    serve_launches = serve_path(torch, build, infer)
    small_f32_identity(torch, build)

    def kernel_line(name, source, replaces, launches, row, checked_in):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "checked_in": checked_in,
                "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        kernel_line("flash_fwd", "tpushare_torch/workloads/kernels/flash_fwd.cu",
                    "tpushare/workloads/ops/attention.py:94",
                    fwd_launches["flash_fwd"], flash_rows[0],
                    "flash-vs-plain, forward-logits, decode, f32-identity"),
        kernel_line("paged_decode",
                    "tpushare_torch/workloads/kernels/paged_decode.cu",
                    "tpushare/workloads/ops/registry.py:617",
                    serve_launches["paged_decode"], paged_rows[0],
                    "paged-vs-plain, serve, f32-identity"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
