#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (flash forward, the cached chunk's
offset flash forward, flash backward dQ and dK/dV, paged decode and
ragged decode, each decode read with its int8 rung, splash forward, dQ
and dK/dV) from the sources in this checkout, holds each against its
plain-PyTorch twin at the shapes the main paths give it (phases
``flash-vs-plain``, ``chunk-vs-plain``, ``flash-bwd-vs-plain``,
``splash-vs-plain``, ``splash-bwd-vs-plain``, ``paged-vs-plain``,
``paged-int8-vs-plain``, ``ragged-vs-plain``, ``ragged-int8-vs-plain``),
then drives the main paths through their entry points at full width
(random weights from a seed):

- ``infer --mode forward`` at the flagship preset (1.2B; batch 8,
  seq 128) — flash-forward kernel;
- ``infer --mode decode`` (batch 8, a 32-token prompt) — the flash
  kernel on a prefill that fits no Pallas block;
- ``forward-longctx``: ``infer --mode forward --batch 2 --seq 4096`` —
  the splash forward, 16 launches per forward, no flash; then
  ``longctx-logits``, B=1 x S=4096 logits against the plain path;
- ``decode-longctx``: ``infer --mode decode --batch 2 --seq 16384`` (a
  4096-token prompt) — the splash forward in prefill, 16 per prefill;
- ``infer --mode serve --paged`` (16 requests, 8 lanes, prompt 128, up
  to 128 new tokens, greedy) — paged-decode kernel, one launch per layer
  per decode step;
- ``infer --mode serve`` (the slot engine: 16 requests, 4 slots, same
  traffic) — the dense einsum read, admission's chunks through the
  cached chunk's kernel, no other kernel; ``serve --ragged`` — the
  ragged-decode kernel, one launch per layer per decode step;
  ``serve --window 128 --ring-rows 256`` (8 requests of up to 384 new
  tokens) — a ring cache that wraps;
- ``infer --mode serve --paged --kv-codec int8`` (``serve-int8``: the
  serve traffic over an int8 pool sized to the same HBM, 62 pages
  against 32) — the paged kernel's int8 rung, one launch per layer per
  decode step, no bf16 launch;
- ``serve-ragged-int8``: the ``serve --ragged`` engine built with
  ``cfg.kv_int8`` (int8 slot caches; the payload has no flag for it) —
  the ragged kernel's int8 rung, one launch per layer per decode step;
  every serve phase runs ``infer``'s default admission controller;
- ``serve-traffic``: ``traffic.generate("bursty", seed=0, duration_s=20,
  rate_rps=4.0)`` (155 requests) replayed in real time through the
  ``serve --paged`` engine (8 lanes, 32 bf16 pages, K5) under the
  default SLO (TTFT 2 s, 0.1 s per token): offered and terminal counts,
  tokens/s, goodput, TTFT and decode p50 / p99, SLO verdicts by phase;
  ``serve-traffic-ragged``: ``agentic`` traffic (dependency chains)
  through ``serve --ragged`` (4 slots, K4);
- ``serve-traffic-chat``: ``chat`` traffic (seed 0, 20 s, rate_rps 4.0:
  26 sessions of 2-4 dependent turns) replayed in real time through the
  ``serve --paged`` engine with the ``sys0`` / ``sys1`` system prompts
  registered as shared-prefix pages (80 rows: two full pages shared, a
  16-row tail copied privately at each admission): K1 once a layer per
  registration, K5 every decode step over aliased tables, every
  admission a prefix hit, the pool empty after both prefixes drop;
- ``serve-spec``: ``serve --paged --draft-k 4 --draft-dmodel 0`` (the
  target drafts for itself) at the serve traffic — batched speculative
  rounds read both models through the plain gather, so K5 launches once
  a layer per non-spec decode step only; ``serve-spec-cost``, after the
  training phases, profiles a round's host wall and device busy time
  against a one-step chunk's on that engine (``torch.profiler``);
- ``serve-overload``: the reference's acceptance storm (dispatch OOM x
  3, a 0.6 s hang at the sync under a 0.1 s watchdog, a queue bound of
  4 against 16 requests, AIMD admission) on the flagship over a bf16
  and an int8 pool (K5, K5-int8): exact accounting, healthz seen
  degraded then ok, the watermark cut to 1 and reopened; then a genuine
  CUDA out-of-memory at a dispatch, survived;
- ``f32-identity``, ``slot-f32-identity``, ``int8-f32-identity``: small
  f32 configs whose kernel and plain reads give the same greedy tokens
  (bf16/f32 pools and caches, then int8 ones); ``prefix-f32-identity``:
  prefix subscribers on both pool codecs (K5, K5-int8) give the tokens
  of the prefix inlined in the prompt (and, on the bf16 pool, of the
  slot engine's copied prefix), the pinned pages bitwise unchanged;
  ``spec-f32-identity``: speculative output equals plain greedy output
  with a perfect and a garbage draft through ``spec_generate``, the
  slot engine, the paged engine on both codecs with prefix subscribers,
  and ``beam_search`` at width 1 equals ``generate``;
- ``train``: 6 steps of ``train.make_train_step`` at the reference's
  training preset (0.55B: d_model 1536, 16 heads of 96, 12 layers;
  batch 8 x seq 1024) — per step and layer one flash forward with LSE,
  one dQ and one dK/dV launch;
- ``train-remat``: the same preset at seq 2048 with ``remat``, 2 steps
  (two forward launches per layer per step);
- ``train-longctx``: 3 steps of ``train.make_train_step`` at the
  flagship's widths, batch 2 x seq 4096 — per step and layer one splash
  forward with LSE, one dQ and one dK/dV launch; ``train-longctx-f32-
  parity``: one f32 step through the splash kernels against the plain
  path (2 layers, 4 heads of 128, S=4096);
- ``train-payload``: ``train_payload.main`` for 6 steps with
  checkpoints, then a restart that resumes and trains to step 9 (the
  payload's own config, head_dim 16);
- int8 weights (``infer --int8``, ``quant.qmm`` over
  ``quant.quantize_params``' mirror): ``forward-w8`` (16 K1 a forward;
  the weight bytes summed from the tensors equal
  ``quantized_param_bytes``; logits within the logits rule of the f32
  forward over the same weights, the 5-bit control failing it),
  ``decode-w8`` (``qgenerate``), ``serve-w8`` (``serve --paged --int8``,
  16 K5 a decode step), ``serve-ragged-w8`` (16 K4 a step),
  ``w8-f32-identity`` (kernel == twin reads over int8 weights on both
  engines and both pool codecs, ``qgenerate``'s flash prefill == plain)
  and, with the profiler, ``serve-w8-cost`` (host wall and device busy
  a decode step against the bf16 weights');
- ``lora-train``: 3 LoRA steps (rank 16 on wq, wv) over the training
  preset's bf16 base, then 3 QLoRA steps over its int8 mirror: 12/12/12
  K1–K3 a step, step 0's loss the base model's, the base bitwise
  unchanged, QLoRA's peak memory at least 0.4 GiB below LoRA's;
- MoE at ``bench.py``'s MoE width (906M params, 8 experts, top-2):
  ``moe-forward`` (B=4 x S=512, 8 K1 a forward), ``moe-serve`` (the
  serve traffic through the paged engine, 8 K5 a decode step at
  head_dim 64, and the slot engine's einsum read), ``moe-train`` (3
  steps of ``train.make_moe_train_step``, 8/8/8 K1–K3 a step; its
  heads, 16 x 64, are rows ``moe-train-lse`` of ``flash-vs-plain`` and
  ``moe-hd64`` of ``flash-bwd-vs-plain``, each with its rounding
  control), ``moe-f32-identity`` (2-layer f32 MoEs, kernel == twin
  reads on both engines, ``moe_generate``'s flash prefill == plain) and
  ``moe-train-f32-parity`` (one step of a 2-layer f32 MoE at head_dim
  64 through the kernels against ``attn_impl="xla"``, at the f32 train
  step's tolerances);

- sharded serving over a serving mesh that names the card several
  times: ``mesh-vs-plain`` (B.9 and B.11: K5, K5-int8, K4, K4-int8 with
  heads over tp=2, the shards' outputs in rank order bitwise one
  unsharded launch, rank 0's shard against its twin and timed beside its
  bound at the shard's shape), ``serve-mesh`` (``serve --tp 2 --pp 2``
  on bf16 then int8 pools: 32 K5 / K5-int8 a decode step, tokens/s
  beside ``serve``), ``serve-ragged-mesh`` (``ServingEngine(mesh=)``,
  tp=2, ``--ragged`` on dense then int8 caches: 32 K4 / K4-int8 a
  step), ``mesh-f32-identity`` (2-layer f32 engines, tp2×pp2 paged with
  a mid-run join on both codecs and tp2 ragged on both caches, against
  the unsharded engines: tokens equal, paged logprobs within
  ``MESH_F32_LOGP_TOL``, ragged logprobs bitwise);
- the payload as a pod runs it, each in a child process reporting to a
  usage endpoint the smoke serves on 127.0.0.1: ``payload-cap``
  (``infer --mode serve --paged`` at ``TPUSHARE_HBM_LIMIT_MIB=32768``:
  the reference's fraction of the card, the final POST's allocator peak
  at or under the cap with the telemetry attached; a child capped at
  2048 MiB refused an allocation past it), ``payload-coresident`` (two
  36000 MiB pods serving at once, each under its own cap; the card's
  used memory), ``payload-drain`` (every POST answered ``{"drain":
  true}``: each of 48 requests ends in one terminal status, and the
  final POST carries the counters);
- training over a mesh that names the card up to four times (one card
  measures launches and copies, not links): ``mesh-train-vs-plain``
  (B.10: K1–K3 once per (dp, tp) shard at ``train``'s shape halved by
  dp2 x tp2; B.8: K6-fwd, -dq, -dkv once per tp shard at
  ``train-longctx``'s shape halved by tp2; the shards' outputs and
  gradients in rank order bitwise one unsharded launch, rank 0's shard
  against its twin and timed beside its bound, its twin and SDPA),
  ``train-mesh`` (the training preset at dp2 x tp2, 6 steps: 48 K1, 48
  K2, 48 K3 a step, replicas bitwise equal, step ms beside ``train``'s
  and the peak), ``train-longctx-mesh`` (flagship widths at tp2, B=2 x
  S=4096, 3 steps: 32 of each K6 a step, no flash), ``train-ring`` (the
  preset at sp2, B=4 x S=2048: the zigzag ring, then the banded ring at
  window 512, 3 steps each, no kernel launch), ``train-pp`` (pp2 x tp2,
  4 microbatches, 3 steps: 96 of each flash kernel a step),
  ``moe-train-ep`` (the MoE width at ep2, then pp2 x ep2), each first
  loss against the unsharded step's within ``MESH_LOSS_TOL``;
  ``train-mesh-f32-identity`` (2-layer f32 configs through every mesh
  form against the unsharded step on the card, losses and gradients
  within the f32 train tolerances); ``train-payload-mesh`` (the payload
  as a child over dp2 x tp2 under an HBM grant, SIGTERM-drained after
  its first step, resumed on dp2 x tp1, its last loss against an
  uninterrupted run's);
- training over a pod group, two child processes on the card brought up
  from the Allocate-shaped group envs, ``gloo`` over loopback between
  them: ``train-multihost`` (``train-mesh``'s run with dp2 across the
  processes and tp2 inside each, 3 steps: 24 of each K1–K3 a step on
  each rank, the ranks' losses bitwise equal, the first within
  ``MESH_LOSS_TOL`` of ``train-mesh``'s; step ms, gathered MiB a step,
  each rank's peak), ``multihost-f32-identity`` (2-layer f32 configs
  through dp x tp, pp x tp and MoE dp x ep with dp or pp across the
  processes, against the one-process run of the same global mesh:
  losses within ``MULTIHOST_LOSS_TOL``, params within
  ``MULTIHOST_PARAM_TOL`` of scale), ``train-payload-multihost`` (the
  training payload as a rank pair under an HBM grant: both ranks print
  ``distributed: rank r/2`` and the same final loss), ``cuda-backend``
  (the device backend the daemon's launcher advertises, NVML over
  ``ctypes``: one chip of NVML's MiB, its device nodes present, as many
  MiB devices, no health event in 2 s, ``close()`` within 2 s, and an
  enumerating child process with no CUDA context);

with the launch counts zeroed just before each path runs and read just
after, so the run shows each path went through its kernels. It prints
one line per phase, a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero; without a CUDA
device, or outside the repo checkout, it exits non-zero before printing
any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# paged kernel vs plain twin: bf16 outputs round once at the end of a
# tiled online softmax vs an einsum/softmax chain; fp32 only reorders sums.
# The paged rows are then also held element by element at FWD_TOL, with
# the rounding control below and, where a lane spans more than one chunk,
# the twin without that lane's first chunk as a second control: a long
# lane's |o| lies below TOL's absolute term, so only the element-wise
# check can tell a kernel that drops a chunk.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# flash and splash forwards vs plain twin, element by element as a share
# of max(|want|, FWD_FLOOR x the output's largest magnitude). The twin
# computes in fp32 and rounds once to the output dtype. The bf16 rungs
# run both products on tensor cores and keep P for P V as two bf16
# halves, hi = bf16(p) and lo = bf16(p - hi): about 16 bits, where P
# rounded once to bf16 would miss this limit about 20-fold near the
# floor (tests/test_torch_fwd_split_p.py). So a sound bf16 kernel differs
# by at most one bf16 ulp, 2^-7 of the value; fp32 only reorders sums.
# The control — the kernel's output rounded to
# CONTROL_BITS_FWD significant bits (bf16 keeps 8) — must land above
# the bf16 limit, which shows the check tells a kernel that loses
# precision anywhere in the output, not only at its largest entries.
FWD_TOL = {"bfloat16": 1e-2, "float32": 1e-3}
FWD_FLOOR = 2 ** -8
CONTROL_BITS_FWD = 6
# the forward's LSE is fp32 from the same fp32 scores on both sides
LSE_TOL = 1e-4
# backward kernels vs the plain backward, as a share of each gradient's
# largest magnitude: bf16 outputs round once (2^-9 relative) on both
# sides, fp32 only reorders sums. The control — the kernel's gradient
# rounded to CONTROL_BITS_BWD significant bits (bf16 keeps 8) — must
# land above the bf16 limit, which shows the check tells a kernel that
# loses precision.
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
CONTROL_BITS_BWD = 4
# the reference's training preset (bench.py) and its batch
TRAIN_PRESET = dict(vocab=32768, d_model=1536, n_heads=16, n_layers=12,
                    d_ff=6144, max_seq=1024)
TRAIN_B, TRAIN_S = 8, 1024
# f32 train step, kernels vs plain attention: loss relative, gradients as
# a share of each leaf's largest magnitude. Params after one AdamW step:
# the first Adam update is g / (|g| + eps), so an element whose gradient
# lies within summation-order noise of 0 may step the other way — two
# runs then sit up to 2 lr apart there (7.2e-5 seen at lr 3e-4 on an
# H100, with the gradients within 1.3e-6). So: every element within
# 2 lr, and all but F32_PARAM_SHARE of them within F32_PARAM_TOL.
F32_LOSS_TOL, F32_GRAD_TOL = 1e-5, 1e-4
F32_PARAM_TOL, F32_PARAM_SHARE = 1e-6, 1e-4
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
# the int8 rungs vs their twins: the rung folds k_s into the score and
# v_s into the probability where the twin dequantizes first (K5) or
# walks the rows in another order (K4), so the two differ in fp32
# rounding and then in the output's one rounding. Held to K5's limits
# (TOL, absolute + relative) and element by element (elem_rel_err) to
# INT8_TOL; tests/test_torch_kernels.py holds the rungs to the same
# limits. The control — the rung's output rounded to INT8_CONTROL_BITS
# significant bits, 8 being bf16's precision for the fp32 rows — must
# fail the element-wise check. Sound readings on an H100: bf16 rows
# <= 0.0077 (one output rounding), fp32 rows 8.49e-5 (K5, kv_len 2k)
# and 1.0021e-4 (K4, S = 4096: fp32 summation order at elements near
# the 2^-8 floor); controls >= 0.0154 (6 bits) and >= 3.8e-3 (8 bits).
INT8_TOL = {"bfloat16": 1e-2, "float32": 2e-4}
INT8_CONTROL_BITS = {"bfloat16": 6, "float32": 8}


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


CHUNK_KERNEL = "flash_fwd_chunk"


def without_chunks(label: str, launches: dict, chunks: int,
                   per_chunk: int) -> dict:
    """``launches`` without the cached chunk's kernel, which must have run
    exactly ``per_chunk`` times (once a layer, or once a layer per tp
    shard on a sharded prefill; 0 where the chunks keep the einsum core)
    for each of the ``chunks`` admission chunks the engines recorded
    (``stats["prefill_chunks"]``). Raises on any other count: a chunk
    routed back to the einsum, or a launch twice."""
    n = launches.get(CHUNK_KERNEL, 0)
    if n != chunks * per_chunk:
        raise RuntimeError(f"{label}: {n} {CHUNK_KERNEL} launches != "
                           f"{per_chunk} x {chunks} admission chunks")
    return {k: c for k, c in launches.items() if k != CHUNK_KERNEL}


def only_codec_chunk_fallbacks(fallbacks: dict) -> bool:
    """The one fallback an int8 slot cache's admission counts on the card:
    its chunks keep the einsum core (``flash:codec:int8``)."""
    return set(fallbacks) == {("flash", "codec:int8")}


def elem_rel_err(got, want) -> float:
    """Largest |got - want| as a share of max(|want|, FWD_FLOOR x the
    largest |want|)."""
    import torch
    want = want.float()
    floor = FWD_FLOOR * want.abs().max()
    return ((got.float() - want).abs()
            / torch.maximum(want.abs(), floor)).max().item()


def check_close(label: str, got, want, dtype: str) -> float:
    import torch
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{label}: {m}")
    return max_err(got, want)


# ---------------------------------------------------------------------------
# phase 2: flash kernel against its plain twin
# ---------------------------------------------------------------------------

def live_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps: the work a flash kernel must
    do on these inputs."""
    if not causal:
        return S * S
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def sdpa_mask(torch, S, window):
    """The banded causal mask as SDPA's boolean ``attn_mask``."""
    ids = torch.arange(S, device="cuda")
    return (ids[None, :] <= ids[:, None]) & (ids[None, :] > ids[:, None]
                                             - window)


def flash_cases(torch):
    from tpushare_torch.workloads.ops.attention import (flash_attention_fwd,
                                                        flash_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (label, B, S, H, Hkv, hd, dtype, window, with_lse)
        ("main-path", 8, 128, 16, 16, 128, "bfloat16", None, False),
        ("flagship", 2, 128, 16, 16, 128, "bfloat16", None, False),
        ("flagship", 2, 512, 16, 16, 128, "bfloat16", None, False),
        ("flagship", 2, 2048, 16, 16, 128, "bfloat16", None, False),
        ("gqa", 2, 512, 16, 4, 128, "bfloat16", None, False),
        ("hd64", 2, 512, 16, 16, 64, "bfloat16", None, False),
        ("odd-S", 2, 300, 16, 16, 128, "bfloat16", None, False),
        ("flagship", 2, 512, 16, 16, 128, "float32", None, False),
        ("gqa-hd64-odd", 1, 77, 4, 2, 64, "float32", None, False),
        ("train-lse", 8, 1024, 16, 16, 96, "bfloat16", None, True),
        ("train-window", 8, 1024, 16, 16, 96, "bfloat16", 256, True),
        ("train-gqa", 8, 1024, 16, 4, 96, "bfloat16", None, True),
        ("train-f32", 2, 1024, 16, 16, 96, "float32", None, True),
        ("train-remat", 8, 2048, 16, 16, 96, "bfloat16", None, True),
        ("payload-hd16", 8, 64, 8, 8, 16, "bfloat16", None, True),
        ("hd96", 2, 512, 16, 16, 96, "bfloat16", None, False),
        # moe-train's heads (16 x 64) at its batch, with LSE
        ("moe-train-lse", 4, 512, 16, 16, 64, "bfloat16", None, True),
    ]
    rows = []
    for label, B, S, H, Hkv, hd, dtype, window, with_lse in cases:
        dt = getattr(torch, dtype)

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rn(B, S, H, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd)

        def kernel():
            return flash_attention_fwd(q, k, v, window=window,
                                       with_lse=with_lse)

        def plain():
            return flash_attention_plain(q, k, v, window=window,
                                         with_lse=with_lse)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        extra = {}
        if with_lse:
            (got, lse), (want, want_lse) = got, want
            lse_err = max_err(lse, want_lse)
            if not lse_err <= LSE_TOL:
                raise RuntimeError(f"flash {label}: lse differs by "
                                   f"{lse_err} > {LSE_TOL}")
            extra = dict(lse_max_abs_err=lse_err)
        tol = FWD_TOL[dtype]
        rel = elem_rel_err(got, want)
        if not rel <= tol:
            raise RuntimeError(f"flash {label} {B}x{S}x{H}/{Hkv}x{hd} "
                               f"{dtype}: {rel} of the value > {tol}")
        if dtype == "bfloat16":
            for b in (7, CONTROL_BITS_FWD):
                extra[f"control_rel_err_b{b}"] = elem_rel_err(
                    round_to_bits(torch, got, b), want)
            if not extra[f"control_rel_err_b{CONTROL_BITS_FWD}"] > tol:
                raise RuntimeError(f"flash {label}: the {CONTROL_BITS_FWD}"
                                   "-bit control passes the forward check")
        err = max_err(got, want)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(torch, S, window) if window else None
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=Hkv != H))
        elem = q.element_size()
        n_bytes = elem * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
        if with_lse:
            n_bytes += 4 * B * H * S
        flops = 4 * B * H * hd * live_pairs(S, True, window)
        bms, by = bound_ms(n_bytes, flops, dtype)
        row = dict(case=label, B=B, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dtype,
                   window=window, lse=with_lse, max_abs_err=err,
                   rel_err=rel, tol=tol, **extra,
                   ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                   bound_ms=bms, bound_by=by,
                   tflops=flops / (ms * 1e-3) / 1e12, over_bound=ms / bms,
                   over_library=ms / sdpa_ms)
        phase("flash-vs-plain", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# flash backward (K2 dQ, K3 dK/dV) against its plain twin
# ---------------------------------------------------------------------------

BWD_CASES = [  # (label, B, S, H, Hkv, hd, dtype, causal, window)
    ("main-path", TRAIN_B, TRAIN_S, 16, 16, 96, "bfloat16", True, None),
    ("gqa-16:4", TRAIN_B, TRAIN_S, 16, 4, 96, "bfloat16", True, None),
    ("window-256", TRAIN_B, TRAIN_S, 16, 16, 96, "bfloat16", True, 256),
    ("train-remat", TRAIN_B, 2 * TRAIN_S, 16, 16, 96, "bfloat16", True,
     None),
    ("full", 2, TRAIN_S, 16, 16, 96, "bfloat16", False, None),
    ("f32", 2, TRAIN_S, 16, 16, 96, "float32", True, None),
    ("odd-S", 2, 300, 16, 16, 96, "bfloat16", True, None),
    ("payload-hd16", 8, 64, 8, 8, 16, "bfloat16", True, None),
    # the flagship's heads (16 x 128), trained through flash below S=4096
    ("hd128", 2, 2 * TRAIN_S, 16, 16, 128, "bfloat16", True, None),
    # moe-train's heads (16 x 64) at its batch
    ("moe-hd64", 4, 512, 16, 16, 64, "bfloat16", True, None),
]
# the rows whose 4-bit rounding control must fail the check
BWD_CONTROL_CASES = ("main-path", "moe-hd64")


# the cached chunk's kernel at the document-QA model's heads (Mistral-7B,
# 32:8 of 128): a 2048-token admission chunk at pos 0 (the median
# prompt's bucket) and at pos 4096 (the last chunk at the 6144 clip)
CHUNK_CASES = [  # (label, Q, pos, H, Hkv, hd)
    ("docqa-median", 2048, 0, 32, 8, 128),
    ("docqa-clip", 2048, 4096, 32, 8, 128),
]


def chunk_cases(torch):
    """The cached chunk's kernel (``attention.flash_chunk_attention``)
    against its plain twin, the einsum core (``decode.cached_attn_einsum``),
    on the same bf16 cache view: layer 1 of a two-layer scratch whose
    rows are pos + Q rounded up to the 32-row page, random everywhere
    (the rows past pos + Q are the scratch's stale tail, which the einsum
    masks and the kernel never reads). Each element within FWD_TOL of
    max(|einsum|, FWD_FLOOR x its largest |value|), and of a plain fp32
    reference; the output rounded to CONTROL_BITS_FWD bits, and the
    einsum with the diagonal one key late, must fail that check. Times kernel, einsum and SDPA with the offset's boolean
    mask over the first pos + Q rows; the bound is the larger of the
    causal operations over the bf16 peak and the bytes (q, o, the K/V
    rows read) over HBM bandwidth."""
    from tpushare_torch.workloads.decode import cached_attn_einsum, kv_view
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.ops.attention import flash_chunk_attention
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype, tol = "bfloat16", FWD_TOL["bfloat16"]
    rows_out = []
    for label, Q, pos, H, Hkv, hd in CHUNK_CASES:
        n = pos + Q
        rows = -(-n // 32) * 32
        q = torch.randn((1, Q, H, hd), generator=gen,
                        device="cuda").bfloat16()
        kc, vc = (torch.randn((2, 1, rows, Hkv, hd), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        k, v = kv_view(kc, 1), kv_view(vc, 1)
        cfg = TransformerConfig(d_model=H * hd, n_heads=H, n_kv_heads=Hkv,
                                max_seq=rows, dtype=torch.bfloat16)
        slot_ids = torch.arange(rows, device="cuda")

        def kernel():
            return flash_chunk_attention(q, k, v, pos)

        def plain():
            return cached_attn_einsum(q, k, v, pos, cfg, slot_ids)
        keep = (torch.arange(n, device="cuda")[None, :]
                <= pos + torch.arange(Q, device="cuda")[:, None])
        qt = q.transpose(1, 2)
        kt, vt = (x[:, :n].transpose(1, 2) for x in (k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                  enable_gqa=Hkv != H)
        got, want = kernel(), plain()
        kf, vf = (x[:, :n].float().repeat_interleave(H // Hkv, dim=2)
                  for x in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
        ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            torch.where(keep, sc, -torch.inf), dim=-1), vf)
        del kf, vf, sc
        torch.cuda.synchronize()
        rel = elem_rel_err(got, want)
        ref_rel = elem_rel_err(got, ref)
        plain_ref_rel = elem_rel_err(want, ref)
        control = elem_rel_err(round_to_bits(torch, got, CONTROL_BITS_FWD),
                               want)
        # the diagonal one key late: the offset a wrong mask would give
        shifted = elem_rel_err(got, cached_attn_einsum(q, k, v, pos + 1, cfg,
                                                       slot_ids))
        if not (rel <= tol and ref_rel <= tol):
            raise RuntimeError(f"chunk {label} Q={Q} pos={pos}: {rel} of the "
                               f"einsum's value, {ref_rel} of the fp32 "
                               f"reference's > {tol}")
        if not (control > tol and shifted > tol):
            raise RuntimeError(f"chunk {label}: a control passes the check "
                               f"({CONTROL_BITS_FWD} bits {control}, the "
                               f"diagonal one key late {shifted})")
        err = max_err(got, want)
        del got, want, ref
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library)
        flops = 4 * H * hd * (Q * pos + Q * (Q + 1) // 2)
        n_bytes = q.element_size() * (2 * Q * H * hd + 2 * n * Hkv * hd)
        bms, by = bound_ms(n_bytes, flops, dtype)
        row = dict(case=label, B=1, Q=Q, pos=pos, rows=rows, H=H, Hkv=Hkv,
                   hd=hd, dtype=dtype, max_abs_err=err, rel_err=rel,
                   ref_rel_err=ref_rel, plain_ref_rel_err=plain_ref_rel,
                   tol=tol, **{f"control_rel_err_b{CONTROL_BITS_FWD}":
                               control}, control_rel_err_offset1=shifted,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=by,
                   tflops=flops / (ms * 1e-3) / 1e12, over_bound=ms / bms,
                   over_plain=ms / plain_ms, over_library=ms / library_ms)
        phase("chunk-vs-plain", **row)
        rows_out.append(row)
        del q, kc, vc, k, v, keep, qt, kt, vt
        torch.cuda.empty_cache()
    return rows_out


def bwd_inputs(torch, gen, B, S, H, Hkv, hd, dtype):
    """q, k, v, dO of one flash backward case on the card, from
    ``gen``."""
    dt = getattr(torch, dtype)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    return rn(B, S, H, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd), \
        rn(B, S, H, hd)


def bwd_cases(torch):
    """dQ and dK/dV kernels against ``flash_attention_bwd_plain`` (both
    fed the kernel forward's o and lse) and against autograd through
    ``flash_attention_plain``, at ``BWD_TOL`` of each gradient's scale
    (the bf16 kernels sum on tensor cores, P and dS as two bf16 halves,
    in another order than the twin); times each kernel alone, the plain
    backward, and SDPA's backward as the library yardstick, with each
    kernel's rate on the live pairs, its time over its bound, and the
    pair's time over SDPA's backward."""
    from tpushare_torch.workloads.ops.attention import (
        bwd_delta, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, B, S, H, Hkv, hd, dtype, causal, window in BWD_CASES:
        q, k, v, do = bwd_inputs(torch, gen, B, S, H, Hkv, hd, dtype)
        o, lse = flash_attention_fwd(q, k, v, causal, window, with_lse=True)
        delta = bwd_delta(do, o)

        def dq_kernel():
            return flash_bwd_dq(q, k, v, do, lse, delta, causal, window)

        def dkv_kernel():
            return flash_bwd_dkv(q, k, v, do, lse, delta, causal, window)

        def plain():
            return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             window)
        got = (dq_kernel(), *dkv_kernel())
        want = plain()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(
            flash_attention_plain(*leaves, causal=causal, window=window),
            leaves, do)
        torch.cuda.synchronize()
        tol = BWD_TOL[dtype]
        errs = {}
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
            scale = w.float().abs().max().item()
            rel = max_err(g, w) / scale
            rel_auto = max_err(g, a) / scale
            if not (rel <= tol and rel_auto <= tol):
                raise RuntimeError(
                    f"flash bwd {label} {name}: {rel} / {rel_auto} of scale "
                    f"{scale} vs the plain backward / autograd > {tol}")
            errs[name] = (rel, rel_auto, max_err(g, w))
        controls = {}
        if label in BWD_CONTROL_CASES:
            for b in (7, 6, 5, CONTROL_BITS_BWD):
                controls[f"control_rel_err_b{b}"] = max(
                    max_err(round_to_bits(torch, g, b), w)
                    / w.float().abs().max().item()
                    for g, w in zip(got, want))
            if not controls[f"control_rel_err_b{CONTROL_BITS_BWD}"] > tol:
                raise RuntimeError(f"flash bwd {label}: the "
                                   f"{CONTROL_BITS_BWD}-bit control passes "
                                   "the backward check")
        dq_ms = time_ms(dq_kernel)
        dkv_ms = time_ms(dkv_kernel)
        plain_ms = time_ms(plain, reps=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = sdpa_mask(torch, S, window) if window else None
        ot = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=Hkv != H)
        dot = do.transpose(1, 2)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        elem = q.element_size()
        q_bytes, kv_bytes = elem * B * S * H * hd, elem * B * S * Hkv * hd
        stat_bytes = 4 * B * H * S
        pairs = live_pairs(S, causal, window)
        product = 2 * B * H * hd * pairs          # one S x S x hd product
        # dq: reads q, k, v, dO, lse, delta, writes dq; q k^T, dO v^T, dS k
        dq_b = bound_ms(3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes,
                        3 * product, dtype)
        # dkv: the same reads, writes dk, dv; + P^T dO and dS^T q
        dkv_b = bound_ms(2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes,
                         4 * product, dtype)
        # the whole backward: reads q, k, v, o, dO, lse; writes dq, dk,
        # dv; five products at the least
        bwd_b = bound_ms(4 * q_bytes + 4 * kv_bytes + stat_bytes,
                         5 * product, dtype)
        # each kernel's rate on the live pairs, its time over its bound,
        # and the pair's time over SDPA's backward
        rates = dict(dq_tflops=3 * product / (dq_ms * 1e-3) / 1e12,
                     dkv_tflops=4 * product / (dkv_ms * 1e-3) / 1e12,
                     dq_over_bound=dq_ms / dq_b[0],
                     dkv_over_bound=dkv_ms / dkv_b[0],
                     pair_over_library=(dq_ms + dkv_ms) / sdpa_bwd_ms)
        row = dict(case=label, B=B, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dtype,
                   causal=causal, window=window, tol=tol,
                   dq_rel_err=errs["dq"][0], dk_rel_err=errs["dk"][0],
                   dv_rel_err=errs["dv"][0],
                   autograd_rel_err=max(e[1] for e in errs.values()),
                   dq_max_abs_err=errs["dq"][2],
                   dkv_max_abs_err=max(errs["dk"][2], errs["dv"][2]),
                   dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                   library_ms=sdpa_bwd_ms, dq_bound_ms=dq_b[0],
                   dq_bound_by=dq_b[1], dkv_bound_ms=dkv_b[0],
                   dkv_bound_by=dkv_b[1], bwd_bound_ms=bwd_b[0],
                   bwd_bound_by=bwd_b[1], **rates, **controls)
        phase("flash-bwd-vs-plain", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# splash (K6-fwd, K6-dq, K6-dkv) against its plain twins
# ---------------------------------------------------------------------------

SPLASH_CASES = [  # (label, B, S, H, hd, dtype, with_lse)
    ("longctx", 2, 4096, 16, 128, "bfloat16", False),
    ("longctx-lse", 2, 4096, 16, 128, "bfloat16", True),
    ("block-128", 1, 4224, 16, 128, "bfloat16", True),
    ("hd256", 1, 4096, 4, 256, "bfloat16", True),
    ("f32", 1, 4096, 4, 128, "float32", True),
]


def splash_inputs(torch, gen, B, S, H, hd, dtype, n=3):
    """``n`` (B, S, H, hd) draws of ``dtype`` from ``gen``; the first is
    returned pre-scaled, as ``splash_attention`` hands it to the
    kernels."""
    from tpushare_torch.workloads.ops.splash_attention import prescale
    dt = getattr(torch, dtype)
    xs = [torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
          for _ in range(n)]
    return [prescale(xs[0]), *xs[1:]]


def splash_cases(torch):
    """The splash forward against ``splash_attention_plain`` element by
    element (LSE too), with the 6-bit rounding control; timed beside its
    bound, the twin and SDPA (``is_causal``, ``scale=1.0`` on the
    pre-scaled q)."""
    from tpushare_torch.workloads.ops import splash_mask
    from tpushare_torch.workloads.ops.splash_attention import (
        splash_attention_plain, splash_fwd)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for label, B, S, H, hd, dtype, with_lse in SPLASH_CASES:
        qs, k, v = splash_inputs(torch, gen, B, S, H, hd, dtype)

        def kernel():
            return splash_fwd(qs, k, v, with_lse=with_lse)

        def plain():
            return splash_attention_plain(qs, k, v, with_lse=with_lse)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        extra = {}
        if with_lse:
            (got, lse), (want, want_lse) = got, want
            lse_err = max_err(lse, want_lse)
            if not lse_err <= LSE_TOL:
                raise RuntimeError(f"splash {label}: lse differs by "
                                   f"{lse_err} > {LSE_TOL}")
            extra = dict(lse_max_abs_err=lse_err)
        tol = FWD_TOL[dtype]
        rel = elem_rel_err(got, want)
        if not rel <= tol:
            raise RuntimeError(f"splash {label} {B}x{S}x{H}x{hd} {dtype}: "
                               f"{rel} of the value > {tol}")
        if dtype == "bfloat16":
            for b in (7, CONTROL_BITS_FWD):
                extra[f"control_rel_err_b{b}"] = elem_rel_err(
                    round_to_bits(torch, got, b), want)
            if not extra[f"control_rel_err_b{CONTROL_BITS_FWD}"] > tol:
                raise RuntimeError(f"splash {label}: the {CONTROL_BITS_FWD}"
                                   "-bit control passes the forward check")
        err = max_err(got, want)
        del got, want
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1.0))
        elem = qs.element_size()
        n_bytes = 4 * elem * B * S * H * hd + (4 * B * H * S if with_lse
                                               else 0)
        flops = 4 * B * H * hd * live_pairs(S, True, None)
        bms, by = bound_ms(n_bytes, flops, dtype)
        sched = splash_mask.fwd_schedule(S, "cuda")
        kinds = sched.kinds.tolist()
        row = dict(case=label, B=B, S=S, H=H, Hkv=H, hd=hd, dtype=dtype,
                   lse=with_lse, block=sched.block,
                   full_blocks=kinds.count(splash_mask.FULL),
                   partial_blocks=kinds.count(splash_mask.PARTIAL),
                   max_abs_err=err, rel_err=rel, tol=tol, **extra, ms=ms,
                   plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bms,
                   bound_by=by, tflops=flops / (ms * 1e-3) / 1e12,
                   over_bound=ms / bms, over_library=ms / sdpa_ms)
        phase("splash-vs-plain", **row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def splash_bwd_cases(torch):
    """The dQ and dK/dV kernels against ``splash_attention_bwd_plain``
    (both fed the kernel forward's o and lse) and against autograd through
    ``splash_attention_plain``, at ``BWD_TOL`` of each gradient's scale
    (the bf16 kernels sum on tensor cores in another order than the twin:
    ``*_differing_share`` counts the elements that differ at all); each
    kernel timed alone, beside the plain backward and SDPA's backward,
    with its rate on the live pairs, its time over its bound, and the
    pair's time over SDPA's backward."""
    from tpushare_torch.workloads.ops.attention import bwd_delta
    from tpushare_torch.workloads.ops.splash_attention import (
        splash_attention_bwd_plain, splash_attention_plain, splash_bwd_dkv,
        splash_bwd_dq, splash_fwd)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(10)
    # the bf16 row is train-longctx's shape (flagship heads, B=2 x S=4096)
    cases = [("train-longctx", 2, 4096, 16, 128, "bfloat16"),
             ("f32", 1, 4096, 4, 128, "float32")]
    rows = []
    for label, B, S, H, hd, dtype in cases:
        qs, k, v, do = splash_inputs(torch, gen, B, S, H, hd, dtype, n=4)
        o, lse = splash_fwd(qs, k, v, with_lse=True)
        di = bwd_delta(do, o)

        def dq_kernel():
            return splash_bwd_dq(qs, k, v, do, lse, di)

        def dkv_kernel():
            return splash_bwd_dkv(qs, k, v, do, lse, di)

        def plain():
            return splash_attention_bwd_plain(qs, k, v, o, lse, do)
        got = (dq_kernel(), *dkv_kernel())
        want = plain()
        leaves = [x.detach().requires_grad_() for x in (qs, k, v)]
        auto = torch.autograd.grad(splash_attention_plain(*leaves), leaves,
                                   do)
        torch.cuda.synchronize()
        tol = BWD_TOL[dtype]
        errs = {}
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
            if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
                raise RuntimeError(f"splash bwd {label} {name}: not finite")
            scale = w.float().abs().max().item()
            rel = max_err(g, w) / scale
            rel_auto = max_err(g, a) / scale
            if not (rel <= tol and rel_auto <= tol):
                raise RuntimeError(
                    f"splash bwd {label} {name}: {rel} / {rel_auto} of "
                    f"scale {scale} vs the plain backward / autograd > {tol}")
            errs[name] = (rel, rel_auto, max_err(g, w),
                          (g.float() != w.float()).float().mean().item())
        controls = {}
        if dtype == "bfloat16":
            for b in (7, 6, 5, CONTROL_BITS_BWD):
                controls[f"control_rel_err_b{b}"] = max(
                    max_err(round_to_bits(torch, g, b), w)
                    / w.float().abs().max().item()
                    for g, w in zip(got, want))
            if not controls[f"control_rel_err_b{CONTROL_BITS_BWD}"] > tol:
                raise RuntimeError(f"the {CONTROL_BITS_BWD}-bit control "
                                   "passes the splash backward check")
        del got, want, auto, leaves
        dq_ms = time_ms(dq_kernel, reps=10)
        dkv_ms = time_ms(dkv_kernel, reps=10)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (qs, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            scale=1.0)
        dot = do.transpose(1, 2)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        x_bytes = qs.element_size() * B * S * H * hd
        stat_bytes = 4 * B * H * S
        product = 2 * B * H * hd * live_pairs(S, True, None)
        # dq: reads q, k, v, dO, lse, di, writes dq; q k^T, dO v^T, dS k
        dq_b = bound_ms(5 * x_bytes + 2 * stat_bytes, 3 * product, dtype)
        # dkv: the same reads, writes dk, dv; q k^T, dO v^T, P^T dO, dS^T q
        dkv_b = bound_ms(6 * x_bytes + 2 * stat_bytes, 4 * product, dtype)
        rates = dict(dq_tflops=3 * product / (dq_ms * 1e-3) / 1e12,
                     dkv_tflops=4 * product / (dkv_ms * 1e-3) / 1e12,
                     dq_over_bound=dq_ms / dq_b[0],
                     dkv_over_bound=dkv_ms / dkv_b[0],
                     pair_over_library=(dq_ms + dkv_ms) / sdpa_bwd_ms)
        row = dict(case=label, B=B, S=S, H=H, Hkv=H, hd=hd, dtype=dtype,
                   tol=tol, **{f"{n}_rel_err": e[0] for n, e in errs.items()},
                   **{f"{n}_differing_share": e[3] for n, e in errs.items()},
                   autograd_rel_err=max(e[1] for e in errs.values()),
                   dq_max_abs_err=errs["dq"][2],
                   dkv_max_abs_err=max(errs["dk"][2], errs["dv"][2]),
                   dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                   library_ms=sdpa_bwd_ms, dq_bound_ms=dq_b[0],
                   dq_bound_by=dq_b[1], dkv_bound_ms=dkv_b[0],
                   dkv_bound_by=dkv_b[1], **rates, **controls)
        phase("splash-bwd-vs-plain", **row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: paged kernel against its plain twin
# ---------------------------------------------------------------------------

PAGED_CASES = [  # (label, B, H, Hkv, hd, ps, table width, max kv_len,
    #              short lanes' top kv_len or None, dtype)
    ("main-path", 8, 16, 16, 128, 32, 8, 256, None, "bfloat16"),
    # moe-serve's read: bench.py's MoE width, 16 heads of 64
    ("moe-hd64", 8, 16, 16, 64, 32, 8, 256, None, "bfloat16"),
    ("flagship-2k", 8, 16, 16, 128, 32, 64, 2048, None, "bfloat16"),
    ("flagship-2k", 8, 16, 16, 128, 32, 64, 2048, None, "float32"),
    ("gqa-2k", 8, 16, 4, 128, 32, 64, 2048, None, "bfloat16"),
    # a long-context request among short ones in one paged engine
    ("straggler-16k", 8, 16, 16, 128, 32, 512, 16384, 1024, "bfloat16"),
]


def paged_inputs(torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max,
                 dtype, int8=False):
    """One paged-read case on the card from ``gen``: q (B, H, hd); the K
    and V pools (B·P + 1 pages of ``dtype``, or ``{q, s}`` int8 pools
    quantized from the same fp32 draws); tables of distinct pages with
    lane 1's first P/2 entries aliased onto lane 0's (a shared prefix);
    kv_lens in (max_len/2, max_len], or, where ``short_max`` is given,
    lane 0 at max_len and the others in [1, short_max]."""
    dt = getattr(torch, dtype)
    n_pages = B * P + 1

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    kp, vp = rn(n_pages, ps, Hkv, hd), rn(n_pages, ps, Hkv, hd)
    tables = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
              [:B * P].reshape(B, P) + 1).to(torch.int32)
    tables[1, :P // 2] = tables[0, :P // 2]     # aliased prefix pages
    if short_max is not None:
        kv_lens = torch.randint(1, short_max + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
        kv_lens[0] = max_len
    else:
        kv_lens = torch.randint(max_len // 2 + 1, max_len + 1, (B,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
    q1 = rn(B, H, hd).to(dt)
    if int8:
        from tpushare_torch.workloads.decode import kv_quantize
        return q1, kv_quantize(kp), kv_quantize(vp), tables, kv_lens
    return q1, kp.to(dt), vp.to(dt), tables, kv_lens


def paged_unique_rows(torch, tables, kv_lens, ps: int) -> int:
    """Distinct (page, row in page) pairs under the lanes' live rows: a
    page that two tables share is read from memory once, so the bound
    counts its rows once."""
    r = torch.arange(tables.shape[1] * ps, device=tables.device)
    rows = tables.long()[:, r // ps] * ps + r % ps
    return int(torch.unique(rows[r[None, :] < kv_lens[:, None]]).numel())


def paged_split(torch, tables, kv_lens, ps: int, Hkv: int) -> dict:
    """How K5 cuts a case: rows per pass-1 CTA, pass 1's grid (chunks x
    kv heads x lanes, dead chunks included) and the longest lane's live
    rows."""
    from tpushare_torch.workloads.ops.paged_attention import (CHUNK_ROWS,
                                                              n_chunks)
    B, P = tables.shape
    return dict(chunk_rows=CHUNK_ROWS, ctas=n_chunks(P * ps) * Hkv * B,
                longest_lane_rows=int(kv_lens.clamp(max=P * ps).max()
                                      .item()))


def check_paged(label, got, want, dtype) -> dict:
    """K5 against its twin: TOL (absolute + relative), then element by
    element at FWD_TOL, with the CONTROL_BITS_FWD-bit rounding control
    that must fail the element-wise check."""
    import torch
    err = check_close(label, got, want, dtype)
    tol = FWD_TOL[dtype]
    rel = elem_rel_err(got, want)
    control = elem_rel_err(round_to_bits(torch, got, CONTROL_BITS_FWD), want)
    if not rel <= tol:
        raise RuntimeError(f"{label}: {rel} of the value > {tol}")
    if not control > tol:
        raise RuntimeError(f"{label}: the {CONTROL_BITS_FWD}-bit control "
                           "passes the check")
    return {"max_abs_err": err, "tol": TOL[dtype], "rel_err": rel,
            "rel_tol": tol, f"control_rel_err_b{CONTROL_BITS_FWD}": control}


def paged_lost_chunk(torch, label, q1, kp, vp, tables, kv_lens, ps, Hkv,
                     want, tol) -> dict:
    """The control for a kernel that drops one chunk of a lane: the twin's
    output with the longest lane's first CHUNK_ROWS rows left out (its
    table moved on by CHUNK_ROWS / ps pages, its kv_len cut by
    CHUNK_ROWS), which must miss the element-wise limit ``tol``. Empty
    where that lane fits in one chunk."""
    from tpushare_torch.workloads.ops.paged_attention import (CHUNK_ROWS,
                                                              xla_paged_read)
    P = tables.shape[1]
    lens = kv_lens.clamp(max=P * ps)
    b = int(lens.argmax().item())
    if int(lens[b].item()) <= CHUNK_ROWS:
        return {}
    assert CHUNK_ROWS % ps == 0, (CHUNK_ROWS, ps)
    shift = CHUNK_ROWS // ps
    cut_tables, cut_lens = tables.clone(), lens.clone()
    cut_tables[b, :P - shift] = tables[b, shift:]
    cut_lens[b] -= CHUNK_ROWS
    lost = elem_rel_err(xla_paged_read(q1[:, None], kp, vp, cut_tables,
                                       cut_lens, q1.shape[1], Hkv)[:, 0],
                        want)
    if not lost > tol:
        raise RuntimeError(f"{label}: the twin without lane {b}'s first "
                           f"chunk passes the check ({lost} <= {tol})")
    return {"control_rel_err_lost_chunk": lost}


def gather_sdpa(torch, q1, kp, vp, tables, kv_lens):
    """A reference point, not a library call for this function (none
    reads a block-paged pool): ``gather_pages`` to a contiguous view in
    the pool's dtype, then SDPA with a boolean mask."""
    import torch.nn.functional as F
    from tpushare_torch.workloads.ops.paged_attention import gather_pages
    k, v = gather_pages(kp, tables), gather_pages(vp, tables)
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < kv_lens[:, None])[:, None, None, :]            # (B, 1, 1, R)
    return F.scaled_dot_product_attention(
        q1[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=k.shape[2] != q1.shape[1])[:, :, 0]


def paged_bitwise_rows(torch, phase_name, q1, kp, vp, tables, kv_lens, ps):
    """On the straggler case: the short lanes through the engine's
    power-of-two table rung over their longest live lane (a column
    slice) and through the whole table give the same bits; every lane
    of the batch reads the same bits as that lane read alone (B = 1)."""
    from tpushare_torch.workloads.ops.paged_attention import paged_decode
    B, P = tables.shape
    got = paged_decode(q1, kp, vp, tables, kv_lens)
    short = kv_lens[1:]
    width = 1 << (-(-int(short.max().item()) // ps) - 1).bit_length()
    narrow = paged_decode(q1[1:], kp, vp, tables[1:, :width], short)
    wide = paged_decode(q1[1:], kp, vp, tables[1:], short)
    torch.cuda.synchronize()
    if not (torch.equal(narrow, wide) and torch.equal(wide, got[1:])):
        raise RuntimeError(f"{phase_name} narrow-wide: the short lanes "
                           f"through {width} and {P} table pages differ "
                           f"({max_err(narrow, wide)})")
    phase(phase_name, case="narrow-wide", lanes=B - 1, narrow_pages=width,
          wide_pages=P, bitwise_equal=True,
          ms_narrow=time_ms(lambda: paged_decode(
              q1[1:], kp, vp, tables[1:, :width], short)),
          ms_wide=time_ms(lambda: paged_decode(q1[1:], kp, vp, tables[1:],
                                               short)))
    for b in range(B):
        alone = paged_decode(q1[b:b + 1], kp, vp, tables[b:b + 1],
                             kv_lens[b:b + 1])
        torch.cuda.synchronize()
        if not torch.equal(alone, got[b:b + 1]):
            raise RuntimeError(f"{phase_name} straggler-alone: lane {b} "
                               "read alone differs from the batch "
                               f"({max_err(alone, got[b:b + 1])})")
    phase(phase_name, case="straggler-alone", lanes=B,
          longest_lane_rows=int(kv_lens.max().item()), bitwise_equal=True)


def paged_cases(torch):
    from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                              xla_paged_read)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, B, H, Hkv, hd, ps, P, max_len, short_max, dtype in \
            PAGED_CASES:
        q1, kp, vp, tables, kv_lens = paged_inputs(
            torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max, dtype)
        got = paged_decode(q1, kp, vp, tables, kv_lens)
        torch.cuda.synchronize()

        def plain():
            return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                                  H, Hkv)[:, 0]
        want = plain()
        what = f"paged {label} {dtype}"
        checked = check_paged(what, got, want, dtype)
        checked.update(paged_lost_chunk(torch, what, q1, kp, vp, tables,
                                        kv_lens, ps, Hkv, want,
                                        FWD_TOL[dtype]))
        del want
        ms = time_ms(lambda: paged_decode(q1, kp, vp, tables, kv_lens))
        plain_ms = time_ms(plain)
        gather_sdpa_ms = time_ms(lambda: gather_sdpa(torch, q1, kp, vp,
                                                     tables, kv_lens))
        rows_read = int(kv_lens.sum().item())
        unique = paged_unique_rows(torch, tables, kv_lens, ps)
        elem = q1.element_size()
        kv_bytes = 2 * unique * Hkv * hd * elem
        n_bytes = kv_bytes + 2 * q1.numel() * elem + tables.numel() * 4 \
            + kv_lens.numel() * 4
        flops = 4 * H * hd * rows_read
        bms, by = bound_ms(n_bytes, flops, dtype)
        row = dict(case=label, B=B, H=H, Hkv=Hkv, hd=hd, ps=ps, P=P,
                   dtype=dtype, **paged_split(torch, tables, kv_lens, ps,
                                              Hkv),
                   kv_rows=rows_read, unique_kv_rows=unique,
                   bytes_read=n_bytes, **checked, ms=ms,
                   plain_ms=plain_ms, library_ms=None,
                   gather_sdpa_ms=gather_sdpa_ms, bound_ms=bms,
                   bound_by=by, gb_per_s=n_bytes / (ms * 1e-3) / 1e9)
        phase("paged-vs-plain", **row)
        rows.append(row)
        if short_max is not None:
            paged_bitwise_rows(torch, "paged-vs-plain", q1, kp, vp, tables,
                               kv_lens, ps)
        del q1, kp, vp, got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the ragged decode read (K4) against its plain twin
# ---------------------------------------------------------------------------

def ragged_lengths(torch, gen, label, B, S):
    """The rows' live lengths: uniform in [0, S) for the serve and f32
    rows; for the long-cache rows ~27% of S on average, as in the
    reference's probe, with one row at length 0 (one live row) and one
    at S - 1."""
    if label in ("long", "gqa"):
        lens = torch.randint(0, int(0.4 * S), (B,), generator=gen,
                             device="cuda")
        lens[0], lens[1] = 0, S - 1
    else:
        lens = torch.randint(0, S, (B,), generator=gen, device="cuda")
    return lens.to(torch.int32)


RAGGED_HD = 128
RAGGED_CASES = [  # (label, B, S, H, Hkv, dtype)
    ("serve", 4, 256, 16, 16, "bfloat16"),
    ("long", 8, 16384, 16, 16, "bfloat16"),
    ("gqa", 8, 16384, 16, 4, "bfloat16"),
    ("f32", 4, 4096, 16, 16, "float32"),
]


def ragged_inputs(torch, gen, label, B, S, H, Hkv, dtype, int8=False):
    """One ragged-read case on the card from ``gen``: q (B, H, 128); K
    and V caches (B, S, Hkv, 128) of ``dtype``, or ``{q, s}`` int8
    caches quantized from the same fp32 draws; the live lengths
    (``ragged_lengths``)."""
    dt = getattr(torch, dtype)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = rn(B, H, RAGGED_HD).to(dt)
    k, v = rn(B, S, Hkv, RAGGED_HD), rn(B, S, Hkv, RAGGED_HD)
    lens = ragged_lengths(torch, gen, label, B, S)
    if int8:
        from tpushare_torch.workloads.decode import kv_quantize
        return q, kv_quantize(k), kv_quantize(v), lens
    return q, k.to(dt), v.to(dt), lens


def ragged_split(torch, B, S, Hkv, lens) -> dict:
    """How K4 cuts a case: rows per pass-1 CTA, pass 1's grid (chunks x
    kv heads x slots, dead chunks included) and the longest slot's live
    rows."""
    from tpushare_torch.workloads.ops.ragged_decode import (CHUNK_ROWS,
                                                            n_chunks)
    return dict(chunk_rows=CHUNK_ROWS, ctas=n_chunks(S) * Hkv * B,
                longest_slot_rows=int((lens.long() + 1).clamp(max=S)
                                      .max().item()))


def ragged_cases(torch):
    """K4 against ``ragged_decode_plain`` at the ``serve --ragged`` shape
    and at long caches (element by element, with a rounding control),
    timed beside its bound, the twin and SDPA with a boolean mask; then
    the capacity row: the long row's live rows in a 4096-row and a
    16384-row cache give bitwise-equal outputs."""
    from tpushare_torch.workloads.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)
    hd = RAGGED_HD
    rows, long_inputs = [], None
    for label, B, S, H, Hkv, dtype in RAGGED_CASES:
        q, k, v, lens = ragged_inputs(torch, gen, label, B, S, H, Hkv,
                                      dtype)
        if label == "long":
            long_inputs = (q, k, v)

        def kernel():
            return ragged_decode_attention(q, k, v, lens)

        def plain():
            return ragged_decode_plain(q, k, v, lens)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        tol = FWD_TOL[dtype]
        rel = elem_rel_err(got, want)
        control = elem_rel_err(round_to_bits(torch, got, CONTROL_BITS_FWD),
                               want)
        if not rel <= tol:
            raise RuntimeError(f"ragged {label} {B}x{S}x{H}/{Hkv} {dtype}: "
                               f"{rel} of the value > {tol}")
        if not control > tol:
            raise RuntimeError(f"ragged {label}: the {CONTROL_BITS_FWD}-bit "
                               "control passes the check")
        mask = (torch.arange(S, device="cuda")[None, :]
                <= lens[:, None])[:, None, None, :]          # (B, 1, 1, S)
        qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != H))
        live = int((lens.long() + 1).clamp(max=S).sum().item())
        elem = q.element_size()
        kv_bytes = 2 * live * Hkv * hd * elem
        n_bytes = kv_bytes + 2 * q.numel() * elem + 4 * B
        bms, by = bound_ms(n_bytes, 4 * H * hd * live, dtype)
        row = dict(case=label, B=B, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dtype,
                   **ragged_split(torch, B, S, Hkv, lens),
                   live_rows=live, fill=live / (B * S), live_kv_bytes=kv_bytes,
                   max_abs_err=max_err(got, want), rel_err=rel, tol=tol,
                   control_rel_err_b6=control, ms=ms, plain_ms=plain_ms,
                   library_ms=sdpa_ms, bound_ms=bms, bound_by=by,
                   gb_per_s=n_bytes / (ms * 1e-3) / 1e9)
        phase("ragged-vs-plain", **row)
        rows.append(row)
    # capacity: every length < 4096, the same live rows in both caches
    q, k, v = long_inputs
    B, S = k.shape[:2]
    small = 4096
    lens = ragged_lengths(torch, gen, "serve", B, small)
    lens[0], lens[1] = 0, small - 1
    big_out = ragged_decode_attention(q, k, v, lens)
    k4, v4 = k[:, :small].contiguous(), v[:, :small].contiguous()
    small_out = ragged_decode_attention(q, k4, v4, lens)
    torch.cuda.synchronize()
    if not torch.equal(big_out, small_out):
        raise RuntimeError("ragged capacity: the same live rows in a 4096- "
                           "and a 16384-row cache differ "
                           f"({max_err(big_out, small_out)})")
    phase("ragged-vs-plain", case="capacity", B=B, S_small=small, S_big=S,
          bitwise_equal=True, max_len=int(lens.max().item()),
          rel_err_vs_plain=elem_rel_err(small_out,
                                        ragged_decode_plain(q, k4, v4, lens)),
          ms_small=time_ms(lambda: ragged_decode_attention(q, k4, v4, lens)),
          ms_big=time_ms(lambda: ragged_decode_attention(q, k, v, lens)))
    return rows


# ---------------------------------------------------------------------------
# the int8 rungs of the paged (K5) and ragged (K4) reads
# ---------------------------------------------------------------------------

def check_int8(label, got, want, dtype):
    """The rung against its twin: K5's absolute + relative limits, then
    element by element at INT8_TOL, with the rounding control that must
    fail the element-wise check."""
    import torch
    err = check_close(label, got, want, dtype)
    tol, bits = INT8_TOL[dtype], INT8_CONTROL_BITS[dtype]
    rel = elem_rel_err(got, want)
    control = elem_rel_err(round_to_bits(torch, got, bits), want)
    if not rel <= tol:
        raise RuntimeError(f"{label}: {rel} of the value > {tol}")
    if not control > tol:
        raise RuntimeError(f"{label}: the {bits}-bit control passes the "
                           "check")
    return {"max_abs_err": err, "tol": TOL[dtype], "rel_err": rel,
            "rel_tol": tol, f"control_rel_err_b{bits}": control}


def int8_rows_bytes(rows: int, Hkv: int, hd: int) -> int:
    """K and V bytes of ``rows`` int8 rows: hd int8 values and one fp32
    scale per row and kv head."""
    return 2 * rows * Hkv * (hd + 4)


def paged_int8_cases(torch):
    """K5's int8 rung against ``xla_paged_read`` on the same ``{q, s}``
    pool (the twin dequantizes the gathered pages), with the bf16 rung's
    time on a bf16 copy of the same pool beside it. No single PyTorch
    call reads int8 rows with per-row scales: no library time."""
    from tpushare_torch.workloads.decode import kv_dequantize
    from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                              xla_paged_read)
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for label, B, H, Hkv, hd, ps, P, max_len, short_max, dtype in \
            PAGED_CASES:
        dt = getattr(torch, dtype)
        q1, kp, vp, tables, kv_lens = paged_inputs(
            torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max, dtype,
            int8=True)

        def kernel():
            return paged_decode(q1, kp, vp, tables, kv_lens)

        def plain():
            return xla_paged_read(q1[:, None], kp, vp, tables, kv_lens,
                                  H, Hkv)[:, 0]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        what = f"paged-int8 {label} {dtype}"
        checked = check_int8(what, got, want, dtype)
        checked.update(paged_lost_chunk(torch, what, q1, kp, vp, tables,
                                        kv_lens, ps, Hkv, want,
                                        INT8_TOL[dtype]))
        kb, vb = kv_dequantize(kp, dt), kv_dequantize(vp, dt)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bf16_rung_ms = time_ms(lambda: paged_decode(q1, kb, vb, tables,
                                                    kv_lens))
        gather_sdpa_ms = time_ms(lambda: gather_sdpa(torch, q1, kb, vb,
                                                     tables, kv_lens))
        del kb, vb
        rows_read = int(kv_lens.sum().item())
        unique = paged_unique_rows(torch, tables, kv_lens, ps)
        elem = q1.element_size()
        n_bytes = int8_rows_bytes(unique, Hkv, hd) \
            + 2 * q1.numel() * elem + tables.numel() * 4 + kv_lens.numel() * 4
        bms, by = bound_ms(n_bytes, 4 * H * hd * rows_read, dtype)
        row = dict(case=label, B=B, H=H, Hkv=Hkv, hd=hd, ps=ps, P=P,
                   dtype=dtype, **paged_split(torch, tables, kv_lens, ps,
                                              Hkv),
                   kv_rows=rows_read, unique_kv_rows=unique,
                   bytes_read=n_bytes,
                   **checked, ms=ms, plain_ms=plain_ms,
                   same_shape_dense_rung_ms=bf16_rung_ms, library_ms=None,
                   gather_sdpa_on_dequantized_copy_ms=gather_sdpa_ms,
                   bound_ms=bms, bound_by=by,
                   gb_per_s=n_bytes / (ms * 1e-3) / 1e9)
        phase("paged-int8-vs-plain", **row)
        rows.append(row)
        if short_max is not None:
            paged_bitwise_rows(torch, "paged-int8-vs-plain", q1, kp, vp,
                               tables, kv_lens, ps)
        del q1, kp, vp, got, want
        torch.cuda.empty_cache()
    return rows


def ragged_int8_cases(torch):
    """K4's int8 rung against ``ragged_decode_plain`` on the same codec
    caches at PR 3's shapes, timed beside its bound, its twin, the bf16
    (or fp32) rung on a dequantized copy, and SDPA with a boolean mask on
    that copy — a labelled reference point, not a library call for this
    function (none reads int8 rows with per-row scales); then the
    capacity row, bitwise."""
    from tpushare_torch.workloads.decode import kv_dequantize
    from tpushare_torch.workloads.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(22)
    hd = RAGGED_HD
    rows, long_inputs = [], None
    for label, B, S, H, Hkv, dtype in RAGGED_CASES:
        dt = getattr(torch, dtype)
        q, k, v, lens = ragged_inputs(torch, gen, label, B, S, H, Hkv,
                                      dtype, int8=True)
        if label == "long":
            long_inputs = (q, k, v)

        def kernel():
            return ragged_decode_attention(q, k, v, lens)

        def plain():
            return ragged_decode_plain(q, k, v, lens)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        checked = check_int8(f"ragged-int8 {label} {dtype}", got, want,
                             dtype)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        kd, vd = kv_dequantize(k, dt), kv_dequantize(v, dt)
        dense_ms = time_ms(lambda: ragged_decode_attention(q, kd, vd, lens))
        mask = (torch.arange(S, device="cuda")[None, :]
                <= lens[:, None])[:, None, None, :]          # (B, 1, 1, S)
        qt, kt, vt = q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != H))
        del kd, vd, kt, vt
        live = int((lens.long() + 1).clamp(max=S).sum().item())
        n_bytes = int8_rows_bytes(live, Hkv, hd) \
            + 2 * q.numel() * q.element_size() + 4 * B
        bms, by = bound_ms(n_bytes, 4 * H * hd * live, dtype)
        row = dict(case=label, B=B, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dtype,
                   **ragged_split(torch, B, S, Hkv, lens),
                   live_rows=live, fill=live / (B * S),
                   live_kv_bytes=int8_rows_bytes(live, Hkv, hd), **checked,
                   ms=ms, plain_ms=plain_ms,
                   same_shape_dense_rung_ms=dense_ms,
                   sdpa_on_dequantized_copy_ms=sdpa_ms, library_ms=None,
                   bound_ms=bms, bound_by=by,
                   gb_per_s=n_bytes / (ms * 1e-3) / 1e9)
        phase("ragged-int8-vs-plain", **row)
        rows.append(row)
    # capacity: every length < 4096, the same live rows in both caches
    q, k, v = long_inputs
    B, S = k["q"].shape[:2]
    small = 4096
    lens = ragged_lengths(torch, gen, "serve", B, small)
    lens[0], lens[1] = 0, small - 1
    big_out = ragged_decode_attention(q, k, v, lens)
    k4, v4 = ({p: leaf[p][:, :small].contiguous() for p in ("q", "s")}
              for leaf in (k, v))
    small_out = ragged_decode_attention(q, k4, v4, lens)
    torch.cuda.synchronize()
    if not torch.equal(big_out, small_out):
        raise RuntimeError("ragged-int8 capacity: the same live rows in a "
                           "4096- and a 16384-row cache differ "
                           f"({max_err(big_out, small_out)})")
    phase("ragged-int8-vs-plain", case="capacity", B=B, S_small=small,
          S_big=S, bitwise_equal=True, max_len=int(lens.max().item()),
          rel_err_vs_plain=elem_rel_err(small_out,
                                        ragged_decode_plain(q, k4, v4, lens)),
          ms_small=time_ms(lambda: ragged_decode_attention(q, k4, v4, lens)),
          ms_big=time_ms(lambda: ragged_decode_attention(q, k, v, lens)))
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths at full width
# ---------------------------------------------------------------------------

def round_to_bits(torch, x, bits: int):
    """x rounded to ``bits`` significant bits (bf16 keeps 8)."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e).to(x.dtype)


def forward_rounded(torch, params, tokens, cfg, bits: int, mm=None):
    """The flagship forward (through ``mm``) with each layer's kernel
    output rounded to ``bits`` significant bits: the control of the
    logits checks."""
    from tpushare_torch.workloads.models.transformer import (
        attention, embed_lookup, layer_block, layer_params, lm_head,
        rope_tables)
    cos, sin = rope_tables(cfg, tokens.shape[1], tokens.device)

    def attn_core(q, k, v):
        return round_to_bits(torch, attention(q, k, v, cfg), bits), None

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        x, _ = layer_block(x, layer_params(params, i), cfg, cos, sin,
                           attn_core, mm=mm)
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
    return launches


LONGCTX_B, LONGCTX_S = 2, 4096    # the reference's long-context batch


def forward_longctx_path(torch, build, infer):
    """``infer --mode forward --batch 2 --seq 4096`` at the flagship: the
    registry's ``longctx:splash`` row, exactly 16 splash launches per
    forward (warm-up and 3 timed), no flash launch, no fallback; then
    B=1, S=4096 logits through the kernels against the plain path, with
    the rounding controls."""
    from tpushare_torch.workloads.models.transformer import forward
    from tpushare_torch.workloads.ops import registry
    n = 3
    build.reset_launches()
    registry.reset_fallbacks()
    res = infer.run(infer.parse_args(
        ["--mode", "forward", "--batch", str(LONGCTX_B), "--seq",
         str(LONGCTX_S), "--steps", str(n), "--hbm-limit-mib", "80000",
         "--seed", "0"]))
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    cfg, params, logits = res["cfg"], res["params"], res["logits"]
    if cfg.d_model != 2048 or cfg.n_layers != 16:
        raise RuntimeError(f"not the flagship preset: {cfg}")
    if logits.shape != (LONGCTX_B, LONGCTX_S, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("long-context logits not finite / wrong shape")
    want = (n + 1) * cfg.n_layers
    if launches["splash_fwd"] != want or launches["flash_fwd"] or fallbacks:
        raise RuntimeError(f"forward-longctx launches {launches}, fallbacks "
                           f"{fallbacks}: want {want} splash_fwd (16 per "
                           "forward), no flash, no fallback")
    phase("forward-longctx", batch=LONGCTX_B, seq=LONGCTX_S,
          tokens_per_s=res["tokens_per_s"],
          splash_launches=launches["splash_fwd"],
          splash_per_forward=launches["splash_fwd"] / (n + 1),
          flash_launches=launches["flash_fwd"], fallbacks=len(fallbacks))
    del res, logits
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, LONGCTX_S), generator=gen,
                           device="cuda")
    kernel = forward(params, tokens, cfg)
    plain = forward(params, tokens,
                    dataclasses.replace(cfg, attn_impl="xla"))
    scale = plain.abs().max().item()
    err = max_err(kernel, plain)
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    del kernel
    controls = {f"control_rel_err_b{b}":
                max_err(forward_rounded(torch, params, tokens, cfg, b),
                        plain) / scale for b in (7, 6, CONTROL_BITS, 4)}
    phase("longctx-logits", seq=LONGCTX_S, max_abs_err=err,
          logit_scale=scale, rel_err=err / scale, tol=LOGIT_TOL,
          argmax_agreement=agree, **controls)
    if not err <= LOGIT_TOL * scale:
        raise RuntimeError(f"long-context logits differ by {err} > "
                           f"{LOGIT_TOL} x {scale}")
    if not controls[f"control_rel_err_b{CONTROL_BITS}"] > LOGIT_TOL:
        raise RuntimeError(f"the {CONTROL_BITS}-bit control passes the "
                           "long-context logits check")
    del params
    torch.cuda.empty_cache()
    return launches


def decode_longctx_path(torch, build, infer):
    """``infer --mode decode --batch 2 --seq 16384``: a 4096-token prompt
    whose prefill runs the splash kernel, 16 launches per prefill, for
    each of the payload's two ``generate`` calls; no flash launch."""
    from tpushare_torch.workloads.ops import registry
    build.reset_launches()
    registry.reset_fallbacks()
    res = infer.run(infer.parse_args(
        ["--mode", "decode", "--batch", str(LONGCTX_B), "--seq",
         str(4 * LONGCTX_S), "--steps", "16", "--hbm-limit-mib", "80000",
         "--seed", "0"]))
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    n_layers = infer.pick_config(80000).n_layers
    if launches["splash_fwd"] != 2 * n_layers or launches["flash_fwd"] \
            or fallbacks:
        raise RuntimeError(f"decode-longctx launches {launches}, fallbacks "
                           f"{fallbacks}: want 2 prefills x {n_layers} "
                           "splash_fwd, no flash, no fallback")
    phase("decode-longctx", tokens_per_s=res["tokens_per_s"],
          prompt=LONGCTX_S, splash_launches=launches["splash_fwd"],
          splash_per_prefill=launches["splash_fwd"] / 2,
          flash_launches=launches["flash_fwd"], fallbacks=len(fallbacks))
    torch.cuda.empty_cache()
    return launches


def paged_serve(torch, build, infer, extra):
    """One ``infer --mode serve --paged`` run at the serve traffic with
    the counts and fallbacks zeroed just before it: 8 lanes reading
    through the paged kernel, every request completed with its
    ``max_new`` tokens, no page leaked, no fallback, no flash launch,
    and the cached chunk's kernel once a layer per admission chunk."""
    from tpushare_torch.workloads.ops import registry
    build.reset_launches()
    registry.reset_fallbacks()
    res = infer.run(infer.parse_args(SERVE_ARGS + ["--paged"] + extra))
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    eng, reqs = res["engine"], res["requests"]
    if eng.attn_impl != "paged" or eng.n_lanes != 8:
        raise RuntimeError(f"engine read {eng.attn_impl} lanes {eng.n_lanes}")
    bad = [r.status for r in reqs if r.status != "completed"
           or len(r.output) != r.max_new]
    if bad:
        raise RuntimeError(f"requests not all completed: {bad}")
    if eng.alloc.pages_in_use() != 0 or eng.alloc.leaked() != 0:
        raise RuntimeError("pages leaked after the serving run")
    if fallbacks or launches["flash_fwd"]:
        raise RuntimeError(f"paged serve {extra} fell back {fallbacks} or "
                           f"launched flash: {launches}")
    without_chunks(f"paged serve {extra}", launches, res["prefill_chunks"],
                   eng.cfg.n_layers)
    steps = res["warmup_decode_steps"] + res["decode_steps"]
    ttft = res["ttft_s"]
    fields = dict(tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
                  seconds=res["seconds"],
                  ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
                  ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
                  peak_running=eng.stats["peak_running"],
                  n_pages=eng.alloc.n_pages, kv_codec=eng.kv_codec,
                  pool_mib=eng.pool_mib,
                  paged_launches=launches["paged_decode"],
                  flash_launches=launches["flash_fwd"],
                  pages_in_use=eng.alloc.pages_in_use(),
                  **{f"{k}_launches": n for k, n in launches.items()})
    return res, launches, steps, fields


def serve_path(torch, build, infer):
    """``serve --paged`` over a bf16 pool: every decode step of the run
    (the warm-up request's too) reads the pool once per layer through
    the kernel's bf16 rung."""
    res, launches, steps, fields = paged_serve(torch, build, infer, [])
    n_layers = res["engine"].cfg.n_layers
    if launches["paged_decode"] != n_layers * steps or \
            launches["paged_decode_int8"]:
        raise RuntimeError(f"paged launches {launches} != {n_layers} layers "
                           f"x {steps} decode steps on the bf16 rung")
    phase("serve", **fields)
    return launches, fields


def serve_int8_path(torch, build, infer, bf16_fields):
    """``serve --paged --kv-codec int8`` at the same traffic: the pool is
    sized to the same HBM under the int8 codec (62 pages against the
    bf16 pool's 32 at the flagship) and every decode step reads it once
    per layer through the int8 rung — no bf16 launch."""
    from tpushare_torch.workloads import paging
    res, launches, steps, fields = paged_serve(torch, build, infer,
                                               ["--kv-codec", "int8"])
    eng = res["engine"]
    cfg, n_layers = eng.cfg, eng.cfg.n_layers
    budget = paging.pool_hbm_mib(paging.pages_for_rows(4 * eng.max_seq, 32),
                                 32, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
    want_pages = paging.pages_for_hbm(budget, 32, cfg.n_layers, cfg.kv_heads,
                                      cfg.head_dim, codec="int8")
    if eng.kv_codec != "int8" or eng.alloc.n_pages != want_pages:
        raise RuntimeError(f"int8 pool {eng.kv_codec} of {eng.alloc.n_pages} "
                           f"pages, not int8 of {want_pages}")
    if launches["paged_decode_int8"] != n_layers * steps or \
            launches["paged_decode"]:
        raise RuntimeError(f"int8 paged launches {launches} != {n_layers} "
                           f"layers x {steps} decode steps on the int8 rung")
    phase("serve-int8", **fields,
          bf16_tokens_per_s=bf16_fields["tokens_per_s"],
          bf16_ttft_p50_ms=bf16_fields["ttft_p50_ms"],
          bf16_peak_running=bf16_fields["peak_running"],
          bf16_n_pages=bf16_fields["n_pages"],
          tokens_per_s_ratio=fields["tokens_per_s"]
          / bf16_fields["tokens_per_s"])
    return launches


SERVE_ARGS = ["--mode", "serve", "--requests", "16", "--slots", "4",
              "--seq", "512", "--steps", "128", "--hbm-limit-mib", "80000",
              "--seed", "0"]


def slot_serve(torch, build, infer, extra):
    """One ``infer --mode serve`` run of the slot engine with the counts
    and fallbacks zeroed just before it; every request must complete
    with its ``max_new`` tokens."""
    from tpushare_torch.workloads.ops import registry
    build.reset_launches()
    registry.reset_fallbacks()
    res = infer.run(infer.parse_args(SERVE_ARGS + extra))
    launches = dict(build.LAUNCHES)
    bad = [r.status for r in res["requests"] if r.status != "completed"
           or len(r.output) != r.max_new]
    if bad:
        raise RuntimeError(f"serve {extra}: requests not all completed: "
                           f"{bad}")
    steps = res["warmup_decode_steps"] + res["decode_steps"]
    ttft = res["ttft_s"]
    fields = dict(tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
                  seconds=res["seconds"],
                  ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
                  ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
                  attn_impl=res["engine"].attn_impl,
                  cache_rows=res["engine"].cache_rows,
                  **{f"{k}_launches": n for k, n in launches.items()})
    return res, launches, steps, registry.fallback_counts(), fields


def serve_slot_path(torch, build, infer):
    """The slot engine's dense read: the reference's einsum core on every
    decode step, and admission's chunks through the cached chunk's
    kernel — no other kernel launch, no fallback."""
    res, launches, _, fallbacks, fields = slot_serve(torch, build, infer, [])
    if res["engine"].attn_impl != "xla":
        raise RuntimeError(f"slot engine read {res['engine'].attn_impl}")
    others = without_chunks("serve-slot", launches, res["prefill_chunks"],
                            res["engine"].cfg.n_layers)
    if any(others.values()) or fallbacks:
        raise RuntimeError(f"the dense slot engine launched {launches}, "
                           f"fell back {fallbacks}")
    phase("serve-slot", **fields)
    return launches


def serve_ragged_path(torch, build, infer):
    """``serve --ragged``: every decode step (the warm-up request's too)
    reads each layer through the ragged kernel — exactly 16 launches per
    step — and nothing falls back or launches flash / paged."""
    res, launches, steps, fallbacks, fields = slot_serve(
        torch, build, infer, ["--ragged"])
    n_layers = res["engine"].cfg.n_layers
    if res["engine"].attn_impl != "ragged":
        raise RuntimeError(f"ragged engine read {res['engine'].attn_impl}")
    if launches["ragged_decode"] != n_layers * steps:
        raise RuntimeError(f"ragged launches {launches['ragged_decode']} != "
                           f"{n_layers} layers x {steps} decode steps")
    if launches["flash_fwd"] or launches["paged_decode"]:
        raise RuntimeError(f"serve --ragged launched {launches}")
    without_chunks("serve-ragged", launches, res["prefill_chunks"], n_layers)
    if fallbacks:
        raise RuntimeError(f"serve --ragged fell back: {fallbacks}")
    phase("serve-ragged", **fields, fallbacks=len(fallbacks))
    return launches, res


def serve_ragged_int8_path(torch, build, infer, ragged_res):
    """The ``serve --ragged`` engine built again with ``cfg.kv_int8``
    (int8 slot caches — the payload has no flag for it, as the
    reference's has none) on the same weights and traffic: every decode
    step reads each layer through the ragged kernel's int8 rung, exactly
    16 launches per step, and no other kernel runs."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.serving import ServingEngine
    base = ragged_res["engine"]
    cfg = dataclasses.replace(base.cfg, kv_int8=True)
    args = infer.parse_args(SERVE_ARGS + ["--ragged"])
    build.reset_launches()
    registry.reset_fallbacks()
    eng = ServingEngine(base.params, cfg, n_slots=base.n_slots,
                        max_seq=base.max_seq, prompt_buckets=base.buckets,
                        chunk=base.chunk, seed=args.seed, top_k=args.top_k)
    res = infer.serve_traffic(eng, args, cfg, torch.device("cuda"),
                              len(ragged_res["requests"][0].prompt),
                              base.max_seq, base.n_slots)
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    bad = [r.status for r in res["requests"] if r.status != "completed"
           or len(r.output) != r.max_new]
    if bad:
        raise RuntimeError(f"serve-ragged-int8: requests not all "
                           f"completed: {bad}")
    if eng.attn_impl != "ragged" or eng.slots["k"]["q"].dtype != torch.int8:
        raise RuntimeError("serve-ragged-int8 is not an int8 ragged engine")
    steps = res["warmup_decode_steps"] + res["decode_steps"]
    n_layers = cfg.n_layers
    others = {k: n for k, n in launches.items() if k != "ragged_decode_int8"}
    if launches["ragged_decode_int8"] != n_layers * steps or any(
            others.values()):
        raise RuntimeError(f"serve-ragged-int8 launches {launches} != "
                           f"{n_layers} layers x {steps} decode steps on "
                           "the int8 rung alone")
    if not only_codec_chunk_fallbacks(fallbacks):
        raise RuntimeError(f"serve-ragged-int8 fell back: {fallbacks} "
                           "(want only the int8 admission chunks')")
    ttft = res["ttft_s"]
    phase("serve-ragged-int8", tokens_per_s=res["tokens_per_s"],
          tokens=res["tokens"], seconds=res["seconds"],
          ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
          ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
          attn_impl=eng.attn_impl, cache_rows=eng.cache_rows,
          bf16_tokens_per_s=ragged_res["tokens_per_s"],
          **{f"{k}_launches": n for k, n in launches.items()},
          fallbacks=len(fallbacks))
    return launches


def serve_ring_path(torch, build, infer):
    """A windowed flagship in a 256-row ring while requests run to 512
    positions: the ring wraps, every request completes."""
    res, launches, _, _, fields = slot_serve(
        torch, build, infer, ["--window", "128", "--ring-rows", "256",
                              "--steps", "384", "--requests", "8"])
    eng = res["engine"]
    longest = max(len(r.prompt) + len(r.output) for r in res["requests"])
    if eng.cache_rows != 256 or eng.slots["k"].shape[2] != 256:
        raise RuntimeError(f"ring rows {eng.cache_rows}, not 256")
    if longest <= eng.cache_rows:
        raise RuntimeError(f"no request wrapped the ring ({longest} rows)")
    without_chunks("serve-ring", launches, res["prefill_chunks"], 0)
    phase("serve-ring", **fields, longest_request=longest)
    return launches


# ---------------------------------------------------------------------------
# the serving control plane: seeded traffic under the SLO, overload
# ---------------------------------------------------------------------------

# bursty (traffic.generate, seed 0, 20 s): rate_rps 4.0 offers 155
# requests (7.75 a second, bursts 6x) of 111.9 decode tokens a second —
# about half of `serve`'s 190-218 tokens/s (PERF.md)
TRAFFIC_RPS = 4.0
TRAFFIC_S = 20.0


def control_fields(report, eng, launches, name):
    """The control plane's figures of one replay: offered and terminal
    counts, throughput, goodput, TTFT and decode tails, SLO verdicts by
    phase, the admission watermark and the kernel's launches."""
    from tpushare_torch import consts
    snap = eng.telemetry.snapshot()
    viol = report["slo_violations"]
    return dict(
        offered=report["offered"], skipped=report["skipped_dependents"],
        **{f"n_{k}": n for k, n in sorted(report["statuses"].items())},
        tokens=report["tokens_out"], wall_s=report["wall_s"],
        tokens_per_s=report["tokens_out"] / report["wall_s"],
        window_tokens_per_s=report["tokens_per_s"],
        goodput_tokens_per_s=report["goodput_tokens_per_s"],
        ttft_p50_ms=snap[consts.TELEMETRY_TTFT_P50_MS],
        ttft_p99_ms=snap[consts.TELEMETRY_TTFT_P99_MS],
        decode_p50_ms=snap[consts.TELEMETRY_DECODE_P50_MS],
        decode_p99_ms=snap[consts.TELEMETRY_DECODE_P99_MS],
        slo_good=report["slo_good"],
        **{f"slo_violations_{p}": n for p, n in viol.items()},
        watermark=snap[consts.TELEMETRY_ADMISSION_WATERMARK],
        compiles=snap[consts.TELEMETRY_COMPILES],
        **{f"{name}_launches": launches[name]})


def check_accounted(label, report, events, eng):
    """Every offered request reached exactly one terminal status, and
    the engine's counters say the same."""
    from tpushare_torch.workloads import overload
    terminal = sum(report["statuses"].values())
    s = eng.stats
    counted = (s["completed"] + s["shed"] + s["deadline_exceeded"]
               + s["oom_quarantined"])
    if not (report["offered"] == terminal == counted > 0
            and report["offered"] + report["skipped_dependents"]
            == len(events)
            and set(report["statuses"]) <= set(overload.TERMINAL_STATUSES)
            and not eng.queue and not eng.running):
        raise RuntimeError(f"{label}: accounting broken: {report} stats {s}")


def replay_phase(torch, build, infer, label, extra, scenario, rate, name,
                 prefix_len=16):
    """``traffic.replay`` of one seeded scenario at time_scale 1.0 through
    ``infer``'s engine (admission on, the reference's default SLO), with
    the counts zeroed just before and read just after: every decode step
    reads each layer through ``name``; each prefix the replay registers
    (``prefix_len`` rows) prefills once through the flash forward, one
    launch a layer; admission chunks run the cached chunk's kernel; no
    other kernel runs, nothing falls back."""
    from tpushare_torch.workloads import traffic
    from tpushare_torch.workloads.ops import registry
    setup = infer.serve_engine(infer.parse_args(SERVE_ARGS + extra))
    eng, cfg = setup["engine"], setup["cfg"]
    events = traffic.generate(scenario, seed=0, duration_s=TRAFFIC_S,
                              **({"rate_rps": rate} if rate else {}))
    torch.cuda.synchronize()
    build.reset_launches()
    registry.reset_fallbacks()
    report = traffic.replay(eng, events, seed=0, time_scale=1.0,
                            vocab=cfg.vocab, max_wall_s=240.0,
                            prefix_len=prefix_len)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    check_accounted(label, report, events, eng)
    steps = eng.stats["lane_steps"] // setup["n_lanes"]
    want = {name: cfg.n_layers * steps,
            "flash_fwd": cfg.n_layers * len(eng.prefixes)}
    if any(n != want.get(k, 0) for k, n in without_chunks(
            label, launches, eng.stats["prefill_chunks"],
            cfg.n_layers).items()) or fallbacks:
        raise RuntimeError(f"{label}: launches {launches} != {cfg.n_layers} "
                           f"layers x {steps} decode steps of {name} and "
                           f"one flash prefill a layer per registered "
                           f"prefix, fallbacks {fallbacks}")
    fields = control_fields(report, eng, launches, name)
    return eng, launches, fields, steps


def serve_traffic_path(torch, build, infer):
    """``bursty`` traffic through ``serve --paged`` (8 lanes, 32 bf16
    pages, K5)."""
    eng, launches, fields, steps = replay_phase(
        torch, build, infer, "serve-traffic", ["--paged"], "bursty",
        TRAFFIC_RPS, "paged_decode")
    if eng.attn_impl != "paged" or eng.n_lanes != 8 or \
            eng.alloc.n_pages != 32:
        raise RuntimeError(f"serve-traffic engine {eng.attn_impl} "
                           f"{eng.n_lanes} lanes {eng.alloc.n_pages} pages")
    if eng.alloc.pages_in_use() != 0 or eng.alloc.leaked() != 0:
        raise RuntimeError("serve-traffic leaked pages")
    phase("serve-traffic", scenario="bursty", rate_rps=TRAFFIC_RPS,
          duration_s=TRAFFIC_S, **fields, decode_steps=steps,
          peak_running=eng.stats["peak_running"])
    return launches, eng


def serve_traffic_ragged_path(torch, build, infer):
    """``agentic`` traffic (dependency chains, no prefixes) through
    ``serve --ragged`` (4 slots, K4)."""
    eng, launches, fields, steps = replay_phase(
        torch, build, infer, "serve-traffic-ragged", ["--ragged"],
        "agentic", None, "ragged_decode")
    if eng.attn_impl != "ragged" or eng.n_slots != 4:
        raise RuntimeError(f"serve-traffic-ragged engine {eng.attn_impl}")
    phase("serve-traffic-ragged", scenario="agentic", rate_rps=2.0,
          duration_s=TRAFFIC_S, **fields, decode_steps=steps)
    return launches


# the reference's paged storm engine (tests/test_paged_serving.py: 3
# lanes, 25 pages of 8 rows, buckets 8 / 32, chunk 4) at flagship widths
# chat (traffic.generate, seed 0, 20 s, rate_rps 4.0): 26 sessions of 2-4
# dependent turns (83 requests, prompts 8-109) behind the sys0 / sys1
# prefixes; 80 rows each: two full 32-row pages shared by every
# subscriber, a 16-row tail each admission makes private (max_seq 256)
CHAT_PREFIX_LEN = 80


def serve_traffic_chat_path(torch, build, infer):
    """``chat`` traffic through ``serve --paged`` (8 lanes, 32 bf16 pages
    of 32 rows, K5) with both system prompts registered as shared-prefix
    pages: every admission a prefix hit with its tail page copied
    privately, K1 once a layer per registration, K5 on every decode step
    over tables whose prefix entries alias across lanes; after both
    prefixes drop, the pool is empty."""
    from tpushare_torch import consts
    eng, launches, fields, steps = replay_phase(
        torch, build, infer, "serve-traffic-chat", ["--paged"], "chat",
        TRAFFIC_RPS, "paged_decode", prefix_len=CHAT_PREFIX_LEN)
    snap = eng.telemetry.snapshot()
    hits, cow = eng.stats["prefix_hits"], eng.stats["cow_copies"]
    peak_shared = eng.stats["peak_shared_pages"]
    if eng.attn_impl != "paged" or eng.n_lanes != 8 or \
            eng.alloc.n_pages != 32 or sorted(eng.prefixes) != ["sys0",
                                                                "sys1"]:
        raise RuntimeError(f"serve-traffic-chat engine {eng.attn_impl} "
                           f"{eng.n_lanes} lanes {eng.alloc.n_pages} pages "
                           f"prefixes {sorted(eng.prefixes)}")
    if not (hits == snap[consts.TELEMETRY_ADMITTED] > 0 and cow >= hits
            and launches["flash_fwd"] == 2 * eng.cfg.n_layers
            and peak_shared > 0):
        raise RuntimeError(f"serve-traffic-chat: prefix_hits {hits} "
                           f"admitted {snap[consts.TELEMETRY_ADMITTED]} "
                           f"cow_copies {cow} flash {launches['flash_fwd']} "
                           f"peak shared {peak_shared}")
    pinned = eng.alloc.pages_in_use()
    for name in ("sys0", "sys1"):
        eng.drop_prefix(name)
    if eng.alloc.pages_in_use() != 0 or eng.alloc.leaked() != 0:
        raise RuntimeError("serve-traffic-chat: pages left after the drop")
    phase("serve-traffic-chat", scenario="chat", rate_rps=TRAFFIC_RPS,
          duration_s=TRAFFIC_S, prefix_len=CHAT_PREFIX_LEN, **fields,
          decode_steps=steps, peak_running=eng.stats["peak_running"],
          peak_shared_pages=peak_shared, pinned_pages=pinned,
          prefix_hits=hits, cow_copies=cow,
          flash_launches=launches["flash_fwd"])
    return launches


STORM_KW = dict(n_lanes=3, max_seq=64, n_pages=25, page_size=8,
                prompt_buckets=(8, 32), chunk=4)


class RealOOM:
    """A fault plan whose ``dispatch`` route, once, asks the card for
    more memory than it has free: a genuine CUDA out-of-memory. (The
    request is the card's whole memory and a GiB more: a request of
    just past ``mem_get_info()``'s free bytes can be served from the
    caching allocator's reserve, which ``mem_get_info`` counts as
    used.)"""

    def __init__(self, torch) -> None:
        self.torch, self.armed, self.caught = torch, True, None

    def fire(self, route: str) -> None:
        if route != "dispatch" or not self.armed:
            return
        self.armed = False
        free, total = self.torch.cuda.mem_get_info()
        self.asked = (total + (1 << 30), free)
        try:
            self.torch.empty(total + (1 << 30), dtype=self.torch.uint8,
                             device="cuda")
        except Exception as e:  # noqa: BLE001 — re-raised below
            self.caught = e
            raise
        raise RuntimeError("an allocation past the free memory succeeded")


def storm(torch, params, cfg, kv_codec, seed):
    """The reference's acceptance storm on one codec: dispatch OOM x 3,
    one 0.6 s hang at the sync under a 0.1 s watchdog, a queue bound of
    4 against 16 requests, AIMD admission with no cut cooldown; then two
    more requests on the same engine."""
    import threading
    import numpy as np
    from tpushare_torch.tpu.fake import WorkloadFault, WorkloadFaultPlan
    from tpushare_torch.workloads import overload
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    plan = WorkloadFaultPlan()
    plan.add("dispatch", WorkloadFault(times=3, kind="oom"))
    plan.add("sync", WorkloadFault(times=1, kind="hang", delay_s=0.6))
    ctl = overload.AdmissionController(STORM_KW["n_lanes"],
                                       md_cooldown_s=0.0, ai_step=0.5)
    eng = PagedServingEngine(params, cfg, **STORM_KW, kv_codec=kv_codec,
                             queue_limit=4, faults=plan, admission=ctl,
                             sync_timeout_s=0.1)
    rng = np.random.default_rng(seed)

    def mk(n, max_new):
        return Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                       max_new=max_new)
    reqs = [mk(4 + (i % 5), 6 + (i % 3)) for i in range(16)]
    unhealthy, done = [], threading.Event()

    def poll():
        while not done.is_set():
            if not eng.healthz()["ok"]:
                unhealthy.append(time.perf_counter())
            time.sleep(0.005)
    poller = threading.Thread(target=poll)
    poller.start()
    t0 = time.perf_counter()
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        done.set()
        poller.join()
    storm_s = time.perf_counter() - t0
    by = {s: sum(r.status == s for r in reqs)
          for s in overload.TERMINAL_STATUSES}
    s = eng.stats
    healthy_after = eng.healthz()["ok"]
    floor = ctl.floor_reached
    if not (all(r.done for r in reqs) and sum(by.values()) == 16
            and s["completed"] == by["completed"]
            and s["shed"] == by["shed"] == 12
            and s["oom_quarantined"] == by["oom_quarantined"]
            and s["deadline_exceeded"] == by["deadline_exceeded"] == 0
            and s["oom_recoveries"] == 3 and unhealthy and healthy_after
            and floor == 1):
        raise RuntimeError(f"storm {kv_codec}: {by} {s} unhealthy "
                           f"{len(unhealthy)} healthy after {healthy_after} "
                           f"floor {floor}")
    bad = [r for r in reqs if r.status == "completed"
           and len(r.output) != r.max_new]
    extras = [mk(5, 6), mk(6, 6)]
    for r in extras:
        eng.submit(r)
    eng.run()
    if bad or [r.status for r in extras] != ["completed"] * 2 or \
            ctl.watermark() != STORM_KW["n_lanes"] or \
            eng.alloc.pages_in_use() or \
            eng.alloc.leaked():
        raise RuntimeError(f"storm {kv_codec}: after the storm extras "
                           f"{[r.status for r in extras]} watermark "
                           f"{ctl.watermark()} floor {floor} pages "
                           f"{eng.alloc.pages_in_use()}")
    snap = eng.telemetry.snapshot()
    return eng, dict(storm_s=storm_s, completed=by["completed"],
                     shed=s["shed"], oom_quarantined=by["oom_quarantined"],
                     oom_recoveries=s["oom_recoveries"],
                     unhealthy_polls=len(unhealthy), floor=floor,
                     watermark_after=ctl.watermark(),
                     trips=eng.watchdog_trips,
                     degraded_after=snap["degraded"])


def serve_overload_path(torch, build, params, cfg):
    """The storm over a bf16 pool (K5) and an int8 pool (K5-int8), then
    one genuine CUDA out-of-memory at a dispatch of the bf16 engine: the
    port's OOM test matches it, the engine quarantines one victim and
    the next request completes."""
    from tpushare_torch.workloads import overload
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.serving import Request
    torch.cuda.synchronize()
    build.reset_launches()
    registry.reset_fallbacks()
    eng, bf16 = storm(torch, params, cfg, "bf16", 120)
    eng8, int8 = storm(torch, params, cfg, "int8", 121)
    real = RealOOM(torch)
    eng.faults = real
    before = eng.stats["oom_recoveries"]
    victims = [Request(prompt=[1, 2, 3, 4, 5], max_new=6),
               Request(prompt=[6, 7, 8, 9], max_new=6)]
    for r in victims:
        eng.submit(r)
    eng.run()
    nxt = Request(prompt=[3, 1, 4, 1, 5], max_new=6)
    eng.submit(nxt)
    eng.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    if not (real.caught is not None
            and isinstance(real.caught, torch.cuda.OutOfMemoryError)
            and overload.is_resource_exhausted(real.caught)
            and eng.stats["oom_recoveries"] == before + 1
            and sorted(r.status for r in victims)
            == ["completed", "oom_quarantined"]
            and nxt.status == "completed" and len(nxt.output) == 6):
        raise RuntimeError(f"real OOM: caught {real.caught!r}, victims "
                           f"{[r.status for r in victims]}, next "
                           f"{nxt.status}")
    steps = eng.stats["lane_steps"] // eng.n_lanes
    steps8 = eng8.stats["lane_steps"] // eng8.n_lanes
    others = {k: n for k, n in without_chunks(
        "serve-overload", launches, eng.stats["prefill_chunks"]
        + eng8.stats["prefill_chunks"], cfg.n_layers).items()
              if k not in ("paged_decode", "paged_decode_int8") and n}
    if launches["paged_decode"] != cfg.n_layers * steps or \
            launches["paged_decode_int8"] != cfg.n_layers * steps8 or \
            others or fallbacks or eng.attn_impl != "paged":
        raise RuntimeError(f"serve-overload launches {launches} != "
                           f"{cfg.n_layers} x ({steps}, {steps8}) decode "
                           f"steps, fallbacks {fallbacks}")
    phase("serve-overload", **{f"bf16_{k}": v for k, v in bf16.items()},
          **{f"int8_{k}": v for k, v in int8.items()},
          real_oom=type(real.caught).__name__,
          real_oom_asked_gib=real.asked[0] / 2 ** 30,
          real_oom_free_gib=real.asked[1] / 2 ** 30,
          real_oom_victims="+".join(sorted(r.status for r in victims)),
          next_request=nxt.status, decode_steps=steps,
          int8_decode_steps=steps8,
          paged_launches=launches["paged_decode"],
          paged_int8_launches=launches["paged_decode_int8"])
    return launches


SLOT_F32 = dict(vocab=512, d_model=512, n_heads=4, n_kv_heads=2,
                n_layers=2, d_ff=1024, max_seq=512)
PAGED_F32 = dict(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=512, max_seq=256)


def f32_setup(torch, kw, seed, n, max_prompt, new_range, moe=False):
    """A small f32 config (dense, or with ``moe`` a ``MoEConfig``), its
    weights and ``n`` (prompt, max_new) specs from ``seed``."""
    import numpy as np
    from tpushare_torch.workloads.models.moe import MoEConfig, init_moe_params
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if moe:
        cfg = MoEConfig(**kw, dtype=torch.float32)
        params = init_moe_params(gen, cfg, "cuda")
    else:
        cfg = TransformerConfig(**kw, dtype=torch.float32)
        params = init_params(gen, cfg, "cuda")
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab, int(rng.integers(5, max_prompt)))
              .tolist(), int(rng.integers(*new_range))) for _ in range(n)]
    return cfg, params, specs, rng


def served(eng, specs, prefix=None):
    """``specs`` through ``eng`` together; the finished requests."""
    from tpushare_torch.workloads.serving import Request
    reqs = [Request(prompt=p, max_new=n, prefix=prefix) for p, n in specs]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def transcripts(eng, specs, prefix=None):
    return [r.output for r in served(eng, specs, prefix)]


def weight_path(params, w8: bool):
    """(params, mm): as given, or the int8 mirror and ``quant.qmm``."""
    if not w8:
        return params, None
    from tpushare_torch.workloads.quant import qmm, quantize_params
    return quantize_params(params), qmm


def slot_identity(torch, build, kv_int8: bool, w8: bool = False,
                  setup=None):
    """The slot engine through the ragged kernel, through the einsum read
    and through the kernel engine's pipelined loop: token-identical
    greedy transcripts (over int8 weights with ``w8``; ``setup`` is
    another config's ``f32_setup``). Returns (requests, tokens, launches
    by run)."""
    from tpushare_torch.workloads.serving import ServingEngine
    cfg, params, specs, _ = setup or f32_setup(torch, SLOT_F32, 12, 6, 90,
                                               (8, 120))
    params, mm = weight_path(params, w8)
    name = "ragged_decode_int8" if kv_int8 else "ragged_decode"
    outs, launched = {}, {}
    for label, ragged, pipeline in (("kernel", True, False),
                                    ("einsum", False, False),
                                    ("kernel-pipelined", True, True)):
        before = dict(build.LAUNCHES)
        eng = ServingEngine(params, dataclasses.replace(
            cfg, ragged_decode=ragged, kv_int8=kv_int8), n_slots=3,
            max_seq=512, prompt_buckets=(16, 64), chunk=4, pipeline=pipeline,
            mm=mm)
        outs[label] = transcripts(eng, specs)
        launched[label] = {k: n - before[k] for k, n in build.LAUNCHES.items()
                           if n - before[k]}
    if not (launched["kernel"].get(name) and launched["kernel-pipelined"]
            .get(name)) or launched["einsum"] or any(
                set(launched[k]) - {name} for k in launched):
        raise RuntimeError(f"slot f32 launches {launched} (wanted {name})")
    if not outs["kernel"] == outs["einsum"] == outs["kernel-pipelined"]:
        raise RuntimeError(f"f32 slot engine (kv_int8={kv_int8}): kernel / "
                           "einsum / pipelined transcripts differ")
    return len(specs), sum(map(len, outs["kernel"])), launched


def paged_identity(torch, build, kv_codec: str, w8: bool = False,
                   setup=None):
    """The paged engine through the kernel and through the gather twin:
    token-identical greedy transcripts (over int8 weights with ``w8``;
    ``setup`` is another config's ``f32_setup``). Returns (params, cfg,
    rng, requests, tokens, kernel launches)."""
    from tpushare_torch.workloads.serving import PagedServingEngine
    cfg, params, specs, rng = setup or f32_setup(torch, PAGED_F32, 4, 6, 60,
                                                 (4, 40))
    params, mm = weight_path(params, w8)
    name = "paged_decode_int8" if kv_codec == "int8" else "paged_decode"
    outs, launched = {}, {}
    for impl in ("paged", "xla"):
        before = build.LAUNCHES[name]
        eng = PagedServingEngine(params, cfg, n_lanes=3, max_seq=128,
                                 n_pages=40, page_size=16,
                                 prompt_buckets=(16, 64), chunk=4,
                                 attn_impl=impl, kv_codec=kv_codec, mm=mm)
        outs[impl] = transcripts(eng, specs)
        launched[impl] = build.LAUNCHES[name] - before
    if not launched["paged"] or launched["xla"]:
        raise RuntimeError(f"f32 paged {kv_codec} launches {launched}")
    if outs["paged"] != outs["xla"]:
        raise RuntimeError(f"f32 engine ({kv_codec} pool): kernel read != "
                           "plain read tokens")
    return (params, cfg, rng, len(specs), sum(map(len, outs["paged"])),
            launched["paged"])


def slot_f32_identity(torch, build):
    n, tokens, launched = slot_identity(torch, build, kv_int8=False)
    phase("slot-f32-identity", requests=n, tokens=tokens,
          ragged_launches=launched["kernel"]["ragged_decode"],
          pipelined_launches=launched["kernel-pipelined"]["ragged_decode"],
          identical=True)


def small_f32_identity(torch, build):
    """Small f32 config: the kernel-read engine and kernel-prefill
    generate (a 77-token prompt: no tiling needed) are
    greedy-token-identical to their plain-path twins."""
    from tpushare_torch.workloads.decode import generate
    params, cfg, rng, n, tokens, _ = paged_identity(torch, build, "bf16")
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
    phase("f32-identity", engine_requests=n, engine_tokens=tokens,
          generate_tokens=int(g_kernel.numel()),
          prefill_flash_launches=prefill_launches, identical=True)


def int8_f32_identity(torch, build):
    """The int8 codec under the same identities: the paged engine over an
    int8 pool, K5's int8 rung against the gather twin; the slot engine
    with ``kv_int8``, K4's int8 rung against the einsum read and the
    pipelined loop. Both sides quantize with the same plain-PyTorch
    write, so only the reads differ."""
    _, _, _, pn, ptokens, plaunched = paged_identity(torch, build, "int8")
    sn, stokens, slaunched = slot_identity(torch, build, kv_int8=True)
    phase("int8-f32-identity", paged_requests=pn, paged_tokens=ptokens,
          paged_int8_launches=plaunched, slot_requests=sn,
          slot_tokens=stokens,
          ragged_int8_launches=slaunched["kernel"]["ragged_decode_int8"],
          pipelined_int8_launches=slaunched["kernel-pipelined"][
              "ragged_decode_int8"], identical=True)


def planes_at(torch, state, page_ids):
    """Copies of every plane of a pool's K and V at ``page_ids``."""
    from tpushare_torch.workloads.decode import kv_planes
    ids = torch.tensor(page_ids, device="cuda")
    return [p[:, ids].clone() for leaf in (state["k"], state["v"])
            for p in kv_planes(leaf)]


PREFIX_F32_KW = dict(n_lanes=3, max_seq=128, n_pages=40, page_size=16,
                     prompt_buckets=(16, 64), chunk=4, attn_impl="paged")
# int8 pool, a subscriber against its prompt with the prefix inlined: the
# subscriber's suffix attends over the prefix rows as the pool stores
# them (quantized), the inlined prompt over its dense prefill scratch —
# the reference's own semantics, whose int8 subscribers part from the
# inlined prompt too (tests/test_torch_prefix.py holds both packages to
# this rule). So the transcripts agree up to a near-tie: at most one
# request parts, never at its first token, and every chosen-token logprob
# up to the parting step is within this of the inlined run's. The phase's
# control serves the same suffixes behind another registered prefix and
# must fail the same check (on the CPU at these widths a codec step moved
# the logprobs by 0.008-0.017 and the other prefix by 0.47-0.72, parting
# every request at its first token).
INT8_PREFIX_LOGP_TOL = 5e-2


def agree_up_to_codec(got, want):
    """(requests whose transcripts part, the earliest first parting step
    or None, the largest |logprob| difference up to and including each
    first parting step)."""
    parted, first, worst = 0, None, 0.0
    for a, b in zip(got, want):
        n = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                  if x != y), None)
        upto = len(a.output) if n is None else n + 1
        if n is None and len(a.output) != len(b.output):
            return len(got), 0, math.inf
        if n is not None:
            parted += 1
            first = n if first is None else min(first, n)
        worst = max(worst, max(abs(x - y) for x, y in
                               zip(a.logprobs[:upto], b.logprobs[:upto])))
    return parted, first, worst


def codec_agrees(parted, first, worst) -> bool:
    """``agree_up_to_codec``'s reading within the int8 rule above."""
    return parted <= 1 and first != 0 and worst <= INT8_PREFIX_LOGP_TOL


def prefix_f32_identity(torch, build):
    """A 2-layer f32 config through the paged engine on both codecs, K5
    and K5-int8 on the card, with a 21-row prefix (its tail page copied
    privately at each admission). The registration's pinned pages are
    bitwise unchanged after serving; subscribers read through the kernel
    give the tokens of the same subscribers read through the gather twin.
    On the bf16 pool they give the tokens of the same requests with the
    prefix inlined in the prompt and of the slot engine's copied prefix;
    on the int8 pool they agree with the inlined prompts up to the codec
    (``codec_agrees``), and the same suffixes behind another registered
    prefix do not."""
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  ServingEngine)
    cfg, params, specs, rng = f32_setup(torch, PAGED_F32, 9, 5, 40, (4, 30))
    prefix = rng.integers(0, cfg.vocab, 21).tolist()
    fields = {}
    for codec in ("bf16", "int8"):
        name = "paged_decode_int8" if codec == "int8" else "paged_decode"
        before = dict(build.LAUNCHES)
        eng = PagedServingEngine(params, cfg, kv_codec=codec,
                                 **PREFIX_F32_KW)
        eng.register_prefix("sys", prefix)
        pinned = planes_at(torch, eng.state, eng.prefixes["sys"][1])
        subs = served(eng, specs, prefix="sys")
        launched = build.LAUNCHES[name] - before[name]
        flash = build.LAUNCHES["flash_fwd"] - before["flash_fwd"]
        twin = PagedServingEngine(params, cfg, kv_codec=codec,
                                  **{**PREFIX_F32_KW, "attn_impl": "xla"})
        twin.register_prefix("sys", prefix)
        twin_outs = transcripts(twin, specs, prefix="sys")
        inline = served(PagedServingEngine(params, cfg, kv_codec=codec,
                                           **PREFIX_F32_KW),
                        [(prefix + p, n) for p, n in specs])
        outs = [r.output for r in subs]
        parted, first, worst = agree_up_to_codec(subs, inline)
        agrees = (outs == [r.output for r in inline] if codec == "bf16"
                  else codec_agrees(parted, first, worst))
        same_pages = all(torch.equal(a, b) for a, b in zip(
            pinned, planes_at(torch, eng.state, eng.prefixes["sys"][1])))
        if outs != twin_outs or not agrees or not same_pages or \
                not launched or flash != cfg.n_layers or \
                eng.stats["prefix_hits"] != len(specs) or \
                eng.stats["cow_copies"] != len(specs):
            raise RuntimeError(f"prefix f32 ({codec} pool): kernel == twin "
                               f"{outs == twin_outs}, against the inlined "
                               f"prompts {parted} parted (first at "
                               f"{first}), |dlogp| {worst}, pinned pages "
                               f"unchanged {same_pages}, {name} "
                               f"{launched}, flash {flash}, stats "
                               f"{eng.stats}")
        if codec == "int8":
            # the control: the same suffixes behind another prefix
            eng.register_prefix("other",
                                rng.integers(0, cfg.vocab, 21).tolist())
            control = agree_up_to_codec(served(eng, specs, prefix="other"),
                                        inline)
            eng.drop_prefix("other")
            if codec_agrees(*control):
                raise RuntimeError(f"prefix f32 (int8 pool): another "
                                   f"prefix passes the codec check "
                                   f"{control}")
            fields.update(int8_control_parted=control[0],
                          int8_control_first_part=control[1],
                          int8_control_max_dlogp=control[2])
        if codec == "bf16":
            slot = ServingEngine(params, cfg, n_slots=3, max_seq=128,
                                 prompt_buckets=(16, 64), chunk=4)
            slot.register_prefix("sys", prefix)
            if transcripts(slot, specs, prefix="sys") != outs:
                raise RuntimeError("prefix f32: paged subscribers != the "
                                   "slot engine's copied prefix")
        eng.drop_prefix("sys")
        if eng.alloc.pages_in_use() or eng.alloc.leaked():
            raise RuntimeError(f"prefix f32 ({codec}): pages left")
        fields[f"{codec}_tokens"] = sum(map(len, outs))
        fields[f"{codec}_{name}_launches"] = launched
        fields[f"{codec}_inlined_parted"] = parted
        fields[f"{codec}_inlined_first_part"] = first
        fields[f"{codec}_inlined_max_dlogp"] = worst
    phase("prefix-f32-identity", requests=len(specs), prefix_len=len(prefix),
          **fields, kernel_equals_twin=True, pinned_unchanged=True)


SPEC_DRAFT_F32 = dict(vocab=512, d_model=64, n_heads=2, n_layers=1,
                      d_ff=128, max_seq=256)


def one_by_one(eng, specs):
    """Each request alone through ``eng`` (single occupancy)."""
    from tpushare_torch.workloads.serving import Request
    outs = []
    for p, n in specs:
        r = Request(prompt=p, max_new=n)
        eng.submit(r)
        eng.run()
        outs.append(r.output)
    return outs


def spec_f32_identity(torch, build):
    """A 2-layer f32 config: speculative output equals plain greedy
    output token for token, with a perfect draft (the target) and a
    garbage one (a random 1-layer model), through ``spec_generate``
    (against ``generate``), the slot engine at single occupancy, and the
    paged engine on both codecs with prefix subscribers (against the
    same engine without a draft; K5 on the card for the non-spec steps
    only, which a sampling subscriber forces); and ``beam_search`` at
    beam 1 against ``generate``."""
    from tpushare_torch.workloads.beam import beam_search
    from tpushare_torch.workloads.decode import generate
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  Request, ServingEngine)
    from tpushare_torch.workloads.spec import spec_generate
    cfg, params, specs, rng = f32_setup(torch, PAGED_F32, 10, 4, 40, (8, 30))
    dcfg = TransformerConfig(**SPEC_DRAFT_F32, dtype=torch.float32)
    dparams = init_params(torch.Generator(device="cuda").manual_seed(11),
                          dcfg, "cuda")
    drafts = {"perfect": (params, cfg), "garbage": (dparams, dcfg)}
    prefix = rng.integers(0, cfg.vocab, 21).tolist()
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 33))).cuda()
    # a sampling subscriber queued behind the greedy ones: while it runs
    # every step is a K5 chunk (rounds are greedy only), over tables that
    # the rounds' rejections truncated; its tokens are not compared
    sampler = rng.integers(0, cfg.vocab, 20).tolist()
    want = generate(params, prompt, cfg, 40)
    beam, _ = beam_search(params, prompt, cfg, 40, beam_width=1)
    if not torch.equal(beam, want):
        raise RuntimeError("f32 beam_search at width 1 != generate")
    slot_kw = dict(n_slots=2, max_seq=128, prompt_buckets=(16, 64), chunk=4)
    plain_slot = one_by_one(ServingEngine(params, cfg, **slot_kw), specs)

    def subscribers(eng):
        """``specs``, then the sampler, behind the prefix; the greedy
        transcripts."""
        eng.register_prefix("sys", prefix)
        *greedy, last = [Request(prompt=p, max_new=n, prefix="sys")
                         for p, n in specs] + [Request(
                             prompt=sampler, max_new=24, prefix="sys",
                             temperature=1.0)]
        for r in (*greedy, last):
            eng.submit(r)
        eng.run()
        if last.status != "completed" or len(last.output) != 24:
            raise RuntimeError(f"f32 paged spec: the sampler {last.status}")
        return [r.output for r in greedy]

    plain_paged = {codec: subscribers(PagedServingEngine(
        params, cfg, kv_codec=codec, **PREFIX_F32_KW))
        for codec in ("bf16", "int8")}
    fields = {}
    for label, (dp, dc) in drafts.items():
        got, st = spec_generate(params, dp, prompt, cfg, dc, 40, k=4)
        if not torch.equal(got, want):
            raise RuntimeError(f"f32 spec_generate ({label} draft) != "
                               "generate")
        fields[f"generate_{label}_accept"] = st["accepted"] / st["drafted"]
        eng = ServingEngine(params, cfg, draft=(dp, dc, 4), **slot_kw)
        if one_by_one(eng, specs) != plain_slot or \
                not eng.stats["spec_rounds"]:
            raise RuntimeError(f"f32 slot engine spec ({label} draft) != "
                               f"plain, rounds {eng.stats['spec_rounds']}")
        fields[f"slot_{label}_rounds"] = eng.stats["spec_rounds"]
        for codec in ("bf16", "int8"):
            name = "paged_decode_int8" if codec == "int8" else "paged_decode"
            before = build.LAUNCHES[name]
            eng = PagedServingEngine(params, cfg, kv_codec=codec,
                                     draft=(dp, dc, 4), **PREFIX_F32_KW)
            outs = subscribers(eng)
            steps = eng.stats["lane_steps"] // eng.n_lanes
            launched = build.LAUNCHES[name] - before
            s = eng.stats
            if outs != plain_paged[codec] or not s["spec_rounds"] or \
                    not launched or launched != cfg.n_layers * steps:
                raise RuntimeError(
                    f"f32 paged spec ({label} draft, {codec} pool): equal "
                    f"{outs == plain_paged[codec]}, rounds "
                    f"{s['spec_rounds']}, {name} {launched} != "
                    f"{cfg.n_layers} x {steps} non-spec steps")
            fields[f"paged_{codec}_{label}_rounds"] = s["spec_rounds"]
            fields[f"paged_{codec}_{label}_{name}_launches"] = launched
            fields[f"paged_{codec}_{label}_accept"] = (
                s["spec_accepted"] / s["spec_drafted"])
    phase("spec-f32-identity", requests=len(specs), **fields,
          beam1_equals_generate=True, identical=True)


def serve_spec_path(torch, build, infer, serve_fields):
    """``serve --paged --draft-k 4 --draft-dmodel 0`` (the target drafts
    for itself) at the serve traffic: every request completes, spec
    rounds run, and since a round reads both models through the plain
    gather, K5 launches once a layer per non-spec decode step only."""
    res, launches, steps, fields = paged_serve(
        torch, build, infer, ["--draft-k", "4", "--draft-dmodel", "0"])
    eng = res["engine"]
    s = eng.stats
    if eng.draft is None or eng.draft[2] != 4 or not s["spec_rounds"]:
        raise RuntimeError(f"serve-spec: no spec rounds ({s})")
    if launches["paged_decode"] != eng.cfg.n_layers * steps or \
            launches["paged_decode_int8"]:
        raise RuntimeError(f"serve-spec launches {launches} != "
                           f"{eng.cfg.n_layers} layers x {steps} non-spec "
                           "decode steps")
    skipped = "+".join(f"{k}:{n}" for k, n in
                       sorted(s["spec_rounds_skipped"].items())) or "none"
    phase("serve-spec", **fields, draft_k=4, self_draft=True,
          serve_tokens_per_s=serve_fields["tokens_per_s"],
          tokens_per_s_ratio=fields["tokens_per_s"]
          / serve_fields["tokens_per_s"],
          spec_rounds=s["spec_rounds"],
          accept_rate=s["spec_accepted"] / max(1, s["spec_drafted"]),
          spec_emitted=s["spec_emitted"], spec_rounds_skipped=skipped)
    return launches


# serve-spec-cost: lanes filled at once (prompt 128, 64 new tokens each;
# the pool holds them all with the rounds' k+1-row tails), one step to
# admit them, then steps timed under the profiler
COST_LANES, COST_STEPS = 4, 3


def profile_steps(torch, infer, extra):
    """Host wall and device busy time (``torch.profiler``: the sum of
    device-side kernel and copy times) of ``COST_STEPS`` engine steps of
    ``serve --paged`` with ``extra`` flags, ``COST_LANES`` greedy
    requests running; then the requests run to completion. Returns the
    per-step figures, the tokens kept per step and the lane rounds
    (``stats["spec_rounds"]``, one a lane a round) of the timed steps."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from tpushare_torch.workloads.serving import Request
    eng = infer.serve_engine(infer.parse_args(
        SERVE_ARGS + ["--paged"] + extra))["engine"]
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, eng.cfg.vocab, 128).tolist(),
                    max_new=64) for _ in range(COST_LANES)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    if len(eng.running) != COST_LANES or eng.queue:
        raise RuntimeError(f"serve-spec-cost {extra}: {len(eng.running)} "
                           f"of {COST_LANES} lanes admitted")
    torch.cuda.synchronize()
    kept, rounds = sum(len(r.output) for r in reqs), eng.stats["spec_rounds"]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(COST_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    out = {"wall_ms": wall * 1e3 / COST_STEPS,
           "device_busy_ms": busy / COST_STEPS,
           "tokens": (sum(len(r.output) for r in reqs) - kept) / COST_STEPS,
           "rounds": eng.stats["spec_rounds"] - rounds}
    eng.run()
    if any(r.status != "completed" or len(r.output) != r.max_new
           for r in reqs):
        raise RuntimeError(f"serve-spec-cost {extra}: requests "
                           f"{[r.status for r in reqs]}")
    return out


def serve_spec_cost(torch, infer):
    """What a batched spec round costs against a decode chunk: engine
    steps of the ``serve-spec`` engine (every timed step a round) and of
    the ``serve`` engine (every timed step a 16-step K5 chunk) over the
    same lanes, each engine built here and freed after it. Host wall
    (the profiler's own overhead included), device busy time and tokens
    kept, per step and per token."""
    spec = profile_steps(torch, infer,
                         ["--draft-k", "4", "--draft-dmodel", "0"])
    torch.cuda.empty_cache()
    chunk = profile_steps(torch, infer, [])
    torch.cuda.empty_cache()
    w8 = profile_steps(torch, infer, ["--int8"])
    torch.cuda.empty_cache()
    if spec["rounds"] != COST_STEPS * COST_LANES or chunk["rounds"]:
        raise RuntimeError(f"serve-spec-cost: {spec['rounds']} lane rounds "
                           f"in {COST_STEPS} spec steps of {COST_LANES} "
                           f"lanes, {chunk['rounds']} in the chunk steps")
    phase("serve-spec-cost", draft_k=4, lanes=COST_LANES,
          **{f"round_{k}": v for k, v in spec.items() if k != "rounds"},
          **{f"chunk_{k}": v for k, v in chunk.items() if k != "rounds"},
          round_wall_ms_per_token=spec["wall_ms"] / spec["tokens"],
          chunk_wall_ms_per_token=chunk["wall_ms"] / chunk["tokens"],
          round_busy_ms_per_token=spec["device_busy_ms"] / spec["tokens"],
          chunk_busy_ms_per_token=chunk["device_busy_ms"]
          / chunk["tokens"])
    # the same 16-step chunks over int8 weights: host wall and device
    # busy per decode step against the bf16 weights' (an engine step is
    # one chunk of 16 decode steps)
    per = 16
    phase("serve-w8-cost", lanes=COST_LANES,
          wall_ms_per_decode_step=w8["wall_ms"] / per,
          device_busy_ms_per_decode_step=w8["device_busy_ms"] / per,
          bf16_wall_ms_per_decode_step=chunk["wall_ms"] / per,
          bf16_device_busy_ms_per_decode_step=chunk["device_busy_ms"] / per,
          busy_ratio=w8["device_busy_ms"] / chunk["device_busy_ms"],
          wall_ratio=w8["wall_ms"] / chunk["wall_ms"],
          w8_tokens_per_step=w8["tokens"], tokens_per_step=chunk["tokens"])
    if w8["rounds"] or w8["tokens"] != chunk["tokens"]:
        raise RuntimeError(f"serve-w8-cost: {w8['tokens']} tokens a step "
                           f"against {chunk['tokens']}")


# ---------------------------------------------------------------------------
# the training paths
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def clone_state(torch, state):
    from tpushare_torch.workloads.train import tree_map
    return {"params": tree_map(torch.clone, state["params"]),
            "opt": {"mu": tree_map(torch.clone, state["opt"]["mu"]),
                    "nu": tree_map(torch.clone, state["opt"]["nu"]),
                    "count": state["opt"]["count"]},
            "step": state["step"]}


def train_setup(torch, cfg, seed, B, S):
    from tpushare_torch.workloads.models.moe import init_moe_params
    from tpushare_torch.workloads.models.transformer import init_params
    from tpushare_torch.workloads.train import init_state, make_optimizer
    gen = torch.Generator(device="cuda").manual_seed(seed)
    opt = make_optimizer()
    init = init_moe_params if hasattr(cfg, "n_experts") else init_params
    state = init_state(init(gen, cfg, "cuda"), opt)
    inputs = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    return opt, state, inputs, torch.roll(inputs, -1, dims=1)


def run_steps(torch, step, state, inputs, targets, n):
    """n steps; per-step host wall (each ended by a synchronize) and
    losses."""
    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = step(state, inputs, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return state, times, losses


def train_path(torch, build, smi):
    """6 steps of make_train_step at the reference's training preset:
    exactly 12 launches of each flash kernel per step, no fallback, a
    finite falling loss."""
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, forward_flops, param_count)
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.train import make_train_step
    cfg = TransformerConfig(**TRAIN_PRESET)
    opt, state, inputs, targets = train_setup(torch, cfg, 6, TRAIN_B,
                                              TRAIN_S)
    step = make_train_step(cfg, opt, "cuda")
    n = 6
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    registry.reset_fallbacks()
    state, times, losses = run_steps(torch, step, state, inputs, targets, n)
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    want = {k: n * cfg.n_layers for k in TRAIN_KERNELS}
    if {k: launches[k] for k in TRAIN_KERNELS} != want or \
            launches["paged_decode"]:
        raise RuntimeError(f"train launches {launches} != {want}: some "
                           "layer's attention missed the kernels")
    if fallbacks:
        raise RuntimeError(f"train path fell back: {fallbacks}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train losses not finite and falling: {losses}")
    step_s = statistics.median(times[1:])
    flops = 3 * forward_flops(cfg, TRAIN_B, TRAIN_S)
    phase("train", params_b=param_count(cfg) / 1e9, batch=TRAIN_B,
          seq=TRAIN_S, steps=n, first_loss=losses[0], last_loss=losses[-1],
          step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3,
          tokens_per_s=TRAIN_B * TRAIN_S / step_s,
          mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS},
          fallbacks=len(fallbacks), card=repr(smi))
    return launches, {"step_ms": step_s * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}


def train_remat_path(torch, build):
    """The same preset at seq 2048 with remat: the first loss equals a
    non-remat step's on the same batch, and the forward kernel runs twice
    per layer per step (forward + recompute)."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import make_train_step
    S = 2 * TRAIN_S
    cfg = TransformerConfig(**{**TRAIN_PRESET, "max_seq": S})
    rcfg = dataclasses.replace(cfg, remat=True)
    opt, state, inputs, targets = train_setup(torch, cfg, 7, TRAIN_B, S)
    torch.cuda.reset_peak_memory_stats()
    plain_state, _, plain_losses = run_steps(
        torch, make_train_step(cfg, opt, "cuda"), clone_state(torch, state),
        inputs, targets, 1)
    plain_peak = torch.cuda.max_memory_allocated()
    del plain_state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = 2
    build.reset_launches()
    state, times, losses = run_steps(
        torch, make_train_step(rcfg, opt, "cuda"), state, inputs, targets, n)
    launches = dict(build.LAUNCHES)
    want = {"flash_fwd": 2 * n * cfg.n_layers,
            "flash_bwd_dq": n * cfg.n_layers,
            "flash_bwd_dkv": n * cfg.n_layers}
    if {k: launches[k] for k in TRAIN_KERNELS} != want:
        raise RuntimeError(f"remat launches {launches} != {want}")
    if losses[0] != plain_losses[0]:
        raise RuntimeError(f"remat loss {losses[0]} != non-remat "
                           f"{plain_losses[0]} on the same batch")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"remat losses not finite: {losses}")
    phase("train-remat", batch=TRAIN_B, seq=S, steps=n, first_loss=losses[0],
          plain_first_loss=plain_losses[0], last_loss=losses[-1],
          step_ms=times[-1] * 1e3,
          tokens_per_s=TRAIN_B * S / times[-1],
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          plain_peak_mem_gib=plain_peak / 2 ** 30,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS})
    return launches


def train_f32_parity(torch, build, moe=False):
    """A 2-layer GQA f32 config at head_dim 96 (``train``'s heads) or,
    with ``moe``, a 2-layer GQA f32 MoE at head_dim 64 (``moe-train``'s
    heads; max_seq = S and capacity factor 1, so capacity drops tokens
    as in moe-train): one step through the kernels and one through
    ``attn_impl="xla"`` from the same state agree."""
    from tpushare_torch.workloads.models.moe import MoEConfig, moe_loss_fn
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, loss_fn)
    from tpushare_torch.workloads.train import (loss_and_grads,
                                                make_moe_train_step,
                                                make_train_step,
                                                tree_leaves)
    if moe:
        name, loss_of, make_step = ("moe-train-f32-parity", moe_loss_fn,
                                    make_moe_train_step)
        cfg = MoEConfig(**{**MOE_F32, "max_seq": 256,
                           "capacity_factor": 1.0}, dtype=torch.float32)
    else:
        name, loss_of, make_step = "train-f32-parity", loss_fn, \
            make_train_step
        cfg = TransformerConfig(vocab=512, d_model=384, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=768,
                                max_seq=256, dtype=torch.float32)
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    opt, state, inputs, targets = train_setup(torch, cfg, 8, 4, 256)
    before = dict(build.LAUNCHES)
    _, k_grads = loss_and_grads(state["params"], inputs, targets, cfg,
                                loss_of)
    _, p_grads = loss_and_grads(state["params"], inputs, targets, plain_cfg,
                                loss_of)
    grad_err = max(max_err(a, b) / b.abs().max().item() for a, b in
                   zip(tree_leaves(k_grads), tree_leaves(p_grads)))
    del k_grads, p_grads
    k_state, k_loss1 = make_step(cfg, opt, "cuda")(
        clone_state(torch, state), inputs, targets)
    p_state, p_loss1 = make_step(plain_cfg, opt, "cuda")(
        clone_state(torch, state), inputs, targets)
    kernel_launches = build.LAUNCHES["flash_bwd_dkv"] - before[
        "flash_bwd_dkv"]
    loss_err = abs(k_loss1.item() - p_loss1.item()) / abs(p_loss1.item())
    pairs = list(zip(tree_leaves(k_state["params"]),
                     tree_leaves(p_state["params"])))
    param_err = max(max_err(a, b) for a, b in pairs)
    off = sum(int(((a - b).abs() > F32_PARAM_TOL).sum()) for a, b in pairs)
    off_share = off / sum(a.numel() for a, _ in pairs)
    lr = opt.lr_at(0)
    phase(name, hd=cfg.head_dim, heads=f"{cfg.n_heads}:"
          f"{cfg.kv_heads}", loss=p_loss1.item(), loss_rel_err=loss_err,
          grad_rel_err=grad_err, param_max_abs_err=param_err,
          params_off_share=off_share, loss_tol=F32_LOSS_TOL,
          grad_tol=F32_GRAD_TOL, param_tol=F32_PARAM_TOL,
          param_share_tol=F32_PARAM_SHARE, param_max_tol=2 * lr,
          kernel_dkv_launches=kernel_launches)
    if kernel_launches != 2 * cfg.n_layers:
        raise RuntimeError(f"{name}: the f32 kernel step did not run the "
                           f"backward kernels ({kernel_launches} dK/dV "
                           "launches)")
    if not (loss_err <= F32_LOSS_TOL and grad_err <= F32_GRAD_TOL
            and param_err <= 2 * lr and off_share <= F32_PARAM_SHARE):
        raise RuntimeError(f"{name}: kernels and plain attention disagree "
                           "beyond the stated tolerances")


SPLASH_KERNELS = ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv")


def train_longctx_path(torch, build, infer, smi):
    """3 steps of make_train_step on the flagship preset's widths at
    B=2 x S=4096 (no remat): exactly 16 launches of each splash kernel
    per step, no flash launch, no fallback, a finite loss."""
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, forward_flops, param_count)
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.train import make_train_step
    cfg = TransformerConfig(**{**infer.PRESETS[-1][1], "max_seq": LONGCTX_S})
    opt, state, inputs, targets = train_setup(torch, cfg, 11, LONGCTX_B,
                                              LONGCTX_S)
    step = make_train_step(cfg, opt, "cuda")
    n = 3
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    registry.reset_fallbacks()
    state, times, losses = run_steps(torch, step, state, inputs, targets, n)
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    want = {k: n * cfg.n_layers for k in SPLASH_KERNELS}
    flash = sum(launches[k] for k in TRAIN_KERNELS)
    if {k: launches[k] for k in SPLASH_KERNELS} != want or flash:
        raise RuntimeError(f"train-longctx launches {launches} != {want} "
                           "and no flash: some layer missed the kernels")
    if fallbacks:
        raise RuntimeError(f"train-longctx fell back: {fallbacks}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"train-longctx losses not finite: {losses}")
    step_s = statistics.median(times[1:])
    flops = 3 * forward_flops(cfg, LONGCTX_B, LONGCTX_S)
    phase("train-longctx", params_b=param_count(cfg) / 1e9,
          batch=LONGCTX_B, seq=LONGCTX_S, steps=n, remat=False,
          first_loss=losses[0], last_loss=losses[-1],
          step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3,
          tokens_per_s=LONGCTX_B * LONGCTX_S / step_s,
          mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          **{f"{k}_per_step": launches[k] / n for k in SPLASH_KERNELS},
          flash_launches=flash, fallbacks=len(fallbacks), card=repr(smi))
    del state, step
    torch.cuda.empty_cache()
    return launches


def train_longctx_f32_parity(torch, build):
    """A 2-layer f32 MHA config with 128-wide heads at S=4096, B=1: one
    step through the splash kernels and one through ``attn_impl="xla"``
    from the same state agree within the ``F32_*`` limits."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import (loss_and_grads,
                                                make_train_step,
                                                tree_leaves)
    cfg = TransformerConfig(vocab=512, d_model=512, n_heads=4, n_layers=2,
                            d_ff=1024, max_seq=LONGCTX_S,
                            dtype=torch.float32)
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    opt, state, inputs, targets = train_setup(torch, cfg, 12, 1, LONGCTX_S)
    before = dict(build.LAUNCHES)
    _, k_grads = loss_and_grads(state["params"], inputs, targets, cfg)
    _, p_grads = loss_and_grads(state["params"], inputs, targets, plain_cfg)
    grad_err = max(max_err(a, b) / b.abs().max().item() for a, b in
                   zip(tree_leaves(k_grads), tree_leaves(p_grads)))
    del k_grads, p_grads
    k_state, k_loss1 = make_train_step(cfg, opt, "cuda")(
        clone_state(torch, state), inputs, targets)
    p_state, p_loss1 = make_train_step(plain_cfg, opt, "cuda")(
        clone_state(torch, state), inputs, targets)
    kernel_launches = {k: build.LAUNCHES[k] - before[k]
                       for k in SPLASH_KERNELS + TRAIN_KERNELS}
    loss_err = abs(k_loss1.item() - p_loss1.item()) / abs(p_loss1.item())
    pairs = list(zip(tree_leaves(k_state["params"]),
                     tree_leaves(p_state["params"])))
    param_err = max(max_err(a, b) for a, b in pairs)
    off = sum(int(((a - b).abs() > F32_PARAM_TOL).sum()) for a, b in pairs)
    off_share = off / sum(a.numel() for a, _ in pairs)
    lr = opt.lr_at(0)
    phase("train-longctx-f32-parity", hd=cfg.head_dim, heads=cfg.n_heads,
          seq=LONGCTX_S, loss=p_loss1.item(), loss_rel_err=loss_err,
          grad_rel_err=grad_err, param_max_abs_err=param_err,
          params_off_share=off_share, loss_tol=F32_LOSS_TOL,
          grad_tol=F32_GRAD_TOL, param_tol=F32_PARAM_TOL,
          param_share_tol=F32_PARAM_SHARE, param_max_tol=2 * lr,
          **{f"{k}_launches": v for k, v in kernel_launches.items()})
    want = {k: 2 * cfg.n_layers for k in SPLASH_KERNELS}
    if {k: kernel_launches[k] for k in SPLASH_KERNELS} != want or \
            any(kernel_launches[k] for k in TRAIN_KERNELS):
        raise RuntimeError("the f32 long-context kernel step did not run "
                           f"the splash kernels alone: {kernel_launches}")
    if not (loss_err <= F32_LOSS_TOL and grad_err <= F32_GRAD_TOL
            and param_err <= 2 * lr and off_share <= F32_PARAM_SHARE):
        raise RuntimeError("f32 long-context train step: splash kernels "
                           "and plain attention disagree beyond the stated "
                           "tolerances")
    del k_state, p_state, state
    torch.cuda.empty_cache()


def train_payload_path(torch, build):
    """``train_payload.main``: 6 steps with a checkpoint every 3, then a
    restart that resumes from step 6 and trains to 9 — the payload's own
    config (head_dim 16) through the kernels."""
    import contextlib
    import io
    import tempfile
    from tpushare_torch.workloads import train_payload
    build.reset_launches()
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for steps in ("6", "9"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_payload.main(["--checkpoint-dir", tmp, "--steps",
                                         steps, "--save-every", "3"])
            print(buf.getvalue(), end="", flush=True)
            if rc != 0:
                raise RuntimeError(f"train_payload exited {rc}")
            outs.append(buf.getvalue())
    launches = dict(build.LAUNCHES)
    if "resumed from step 6" not in outs[1] or "resumed" in outs[0]:
        raise RuntimeError("the payload restart did not resume from step 6")
    losses = [float(line.rsplit("=", 1)[1]) for out in outs
              for line in out.splitlines() if "final loss=" in line]
    n_layers = 4
    want = {k: 9 * n_layers for k in TRAIN_KERNELS}
    if {k: launches[k] for k in TRAIN_KERNELS} != want:
        raise RuntimeError(f"payload launches {launches} != {want}")
    if not losses[1] < losses[0]:
        raise RuntimeError(f"payload loss did not fall: {losses}")
    phase("train-payload", resumed_from=6, final_loss_6=losses[0],
          final_loss_9=losses[1],
          **{f"{k}_launches": launches[k] for k in TRAIN_KERNELS})
    return launches


# ---------------------------------------------------------------------------
# int8 weights, LoRA / QLoRA adapters and the MoE family
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    from tpushare_torch.workloads.infer import _tensor_bytes
    return sum(_tensor_bytes(tree))


def forward_w8_path(torch, build, infer, bf16_params):
    """``infer --mode forward --int8`` at the flagship: 16 flash launches
    per forward (warm-up and 10 timed), the weights on the card summed
    from the tensors equal to ``quant.quantized_param_bytes``; then B=1,
    S=512 logits through qmm against the port's f32 forward over
    ``dequantize_params`` of the same ``{q, s}`` (exact arithmetic over
    the same weights), at the smoke's logits rule (LOGIT_TOL x scale),
    with the 5-bit rounding control failing it. The bf16 forward over
    those weights is printed beside it (``bf16_dequantized_rel_err``),
    not used as the reference: it carries the same bf16 noise as the
    int8 path, and on an H100 sits about as far from the f32 forward as
    the rule allows."""
    from tpushare_torch.workloads.models.transformer import forward
    from tpushare_torch.workloads.quant import (dequantize_params,
                                                quantized_param_bytes)
    build.reset_launches()
    res = infer.run(infer.parse_args(
        ["--mode", "forward", "--batch", "8", "--seq", "128", "--steps",
         "10", "--hbm-limit-mib", "80000", "--seed", "0", "--int8"]))
    launches = dict(build.LAUNCHES)
    cfg, qparams, logits, mm = (res["cfg"], res["params"], res["logits"],
                                res["mm"])
    if mm is None or qparams["layers"]["wq"]["q"].dtype != torch.int8:
        raise RuntimeError("forward --int8 did not run int8 weights")
    if logits.shape != (8, 128, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("forward-w8 logits not finite / wrong shape")
    others = {k: n for k, n in launches.items() if k != "flash_fwd"}
    if launches["flash_fwd"] != cfg.n_layers * 11 or any(others.values()):
        raise RuntimeError(f"forward-w8 launches {launches} != 16 layers x "
                           "11 forwards of flash alone")
    w8_bytes, bf16_bytes = tree_bytes(qparams), tree_bytes(bf16_params)
    if w8_bytes != quantized_param_bytes(cfg):
        raise RuntimeError(f"int8 weights hold {w8_bytes} bytes, not "
                           f"quantized_param_bytes {quantized_param_bytes(cfg)}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                           device="cuda")
    with torch.no_grad():
        w8 = forward(qparams, tokens, cfg, mm=mm)
        exact = forward(dequantize_params(qparams, torch.float32), tokens,
                        dataclasses.replace(cfg, dtype=torch.float32))
        bf16_err = max_err(forward(dequantize_params(qparams), tokens, cfg),
                           exact)
        control = forward_rounded(torch, qparams, tokens, cfg,
                                  CONTROL_BITS, mm=mm)
    scale = exact.abs().max().item()
    err = max_err(w8, exact)
    control = max_err(control, exact) / scale
    agree = (w8.argmax(-1) == exact.argmax(-1)).float().mean().item()
    del exact
    phase("forward-w8", tokens_per_s=res["tokens_per_s"],
          flash_launches=launches["flash_fwd"], weight_bytes=w8_bytes,
          quantized_param_bytes=quantized_param_bytes(cfg),
          bf16_weight_bytes=bf16_bytes,
          weight_gib=w8_bytes / 2 ** 30, bf16_weight_gib=bf16_bytes / 2 ** 30,
          max_abs_err=err, logit_scale=scale, rel_err=err / scale,
          tol=LOGIT_TOL, argmax_agreement=agree,
          bf16_dequantized_rel_err=bf16_err / scale,
          **{f"control_rel_err_b{CONTROL_BITS}": control})
    if not err <= LOGIT_TOL * scale:
        raise RuntimeError(f"int8-weight logits differ from the f32 forward "
                           f"over the same weights by {err} > {LOGIT_TOL} "
                           f"x {scale}")
    if not control > LOGIT_TOL:
        raise RuntimeError(f"the {CONTROL_BITS}-bit control passes the "
                           "forward-w8 logits check")
    return launches


def decode_w8_path(torch, build, infer):
    """``infer --mode decode --int8``: ``qgenerate``, whose 32-token
    prefill runs the flash kernel once a layer per generate (warm-up and
    timed)."""
    build.reset_launches()
    res = infer.run(infer.parse_args(
        ["--mode", "decode", "--batch", "8", "--seq", "128", "--steps",
         "16", "--hbm-limit-mib", "80000", "--seed", "0", "--int8"]))
    launches = dict(build.LAUNCHES)
    n_layers = infer.pick_config(80000).n_layers
    others = {k: n for k, n in launches.items() if k != "flash_fwd"}
    if launches["flash_fwd"] != 2 * n_layers or any(others.values()):
        raise RuntimeError(f"decode-w8 launches {launches} != 2 generates x "
                           f"{n_layers} layers of flash alone")
    phase("decode-w8", tokens_per_s=res["tokens_per_s"], prompt=32,
          flash_launches=launches["flash_fwd"])
    return launches


def serve_w8_path(torch, build, infer, serve_fields):
    """``serve --paged --int8`` at the serve traffic: every decode step
    reads the bf16 pool once a layer through K5, admission runs qmm."""
    res, launches, steps, fields = paged_serve(torch, build, infer,
                                               ["--int8"])
    eng = res["engine"]
    if eng.mm is None or eng.params["out"]["q"].dtype != torch.int8:
        raise RuntimeError("serve-w8 engine is not over int8 weights")
    if launches["paged_decode"] != eng.cfg.n_layers * steps or \
            launches["paged_decode_int8"]:
        raise RuntimeError(f"serve-w8 launches {launches} != "
                           f"{eng.cfg.n_layers} layers x {steps} decode "
                           "steps on the bf16 rung")
    phase("serve-w8", **fields,
          bf16_weights_tokens_per_s=serve_fields["tokens_per_s"],
          tokens_per_s_ratio=fields["tokens_per_s"]
          / serve_fields["tokens_per_s"])
    return launches


def serve_ragged_w8_path(torch, build, infer, ragged_res):
    """``serve --ragged --int8``: every decode step reads each layer
    through K4, 16 launches a step, over int8 weights."""
    res, launches, steps, fallbacks, fields = slot_serve(
        torch, build, infer, ["--ragged", "--int8"])
    eng = res["engine"]
    others = {k: n for k, n in without_chunks(
        "serve-ragged-w8", launches, res["prefill_chunks"],
        eng.cfg.n_layers).items()
              if k != "ragged_decode"}
    if eng.attn_impl != "ragged" or eng.mm is None:
        raise RuntimeError("serve-ragged-w8 is not a ragged int8-weight "
                           "engine")
    if launches["ragged_decode"] != eng.cfg.n_layers * steps or any(
            others.values()) or fallbacks:
        raise RuntimeError(f"serve-ragged-w8 launches {launches} != "
                           f"{eng.cfg.n_layers} layers x {steps} decode "
                           f"steps (fallbacks {fallbacks})")
    phase("serve-ragged-w8", **fields,
          bf16_weights_tokens_per_s=ragged_res["tokens_per_s"],
          fallbacks=len(fallbacks))
    return launches


def w8_f32_identity(torch, build):
    """Int8 weights under the read identities, small f32 configs: the
    paged engine on both pool codecs (K5, K5-int8 against the gather
    twin), the slot engine (K4 against the einsum read and the pipelined
    loop) and ``qgenerate`` (a flash prefill against the plain one), each
    through qmm — greedy tokens equal."""
    from tpushare_torch.workloads.quant import qgenerate
    pk = {}
    for codec in ("bf16", "int8"):
        params, cfg, rng, n, tokens, pk[codec] = paged_identity(
            torch, build, codec, w8=True)
    sn, stokens, slaunched = slot_identity(torch, build, kv_int8=False,
                                           w8=True)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 77))).cuda()
    before = build.LAUNCHES["flash_fwd"]
    g_kernel = qgenerate(params, prompt, cfg, 16)
    prefill_launches = build.LAUNCHES["flash_fwd"] - before
    g_plain = qgenerate(params, prompt,
                        dataclasses.replace(cfg, attn_impl="xla"), 16)
    if prefill_launches != cfg.n_layers or not torch.equal(g_kernel,
                                                           g_plain):
        raise RuntimeError(f"f32 qgenerate: flash prefill ({prefill_launches}"
                           " launches) != plain prefill tokens")
    phase("w8-f32-identity", paged_requests=n, paged_tokens=tokens,
          paged_launches=pk["bf16"], paged_int8_launches=pk["int8"],
          slot_requests=sn, slot_tokens=stokens,
          ragged_launches=slaunched["kernel"]["ragged_decode"],
          qgenerate_tokens=int(g_kernel.numel()),
          prefill_flash_launches=prefill_launches, identical=True)


# lora-train: the reference's 0.55B training preset, rank 16 on the
# default targets, alpha 32 (scale 2)
LORA_RANK, LORA_SCALE = 16, 2.0
# QLoRA's peak must sit at least this far below LoRA's: the base is
# 1.03 GiB in bf16 and 0.52 GiB in int8, and a qmm that kept bf16 copies
# of the weights for the backward would hold the whole bf16 base again
QLORA_SAVING_GIB = 0.4


def lora_run(torch, build, cfg, base, mm, inputs, targets, n, seed):
    """``n`` adapter steps over the frozen ``base`` (dense, or int8 with
    ``mm=qmm``) with the counts and the peak zeroed first. Returns the
    per-step times and losses, the launches, the fallbacks, the peak
    bytes and the base model's own loss on the batch (no grad)."""
    from tpushare_torch.workloads import lora
    from tpushare_torch.workloads.models.transformer import loss_fn
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.train import (make_optimizer, tree_leaves,
                                                tree_map)
    with torch.no_grad():
        base_loss = loss_fn(base, inputs, targets, cfg, mm=mm).item()
    host = [t.cpu() for t in tree_leaves(base)]
    opt = make_optimizer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = lora.init_lora_state(lora.init_lora(gen, cfg, LORA_RANK), opt)
    step = lora.make_lora_train_step(cfg, opt, scale=LORA_SCALE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    registry.reset_fallbacks()
    _, times, losses = run_steps(
        torch, lambda s, i, t: step(s, base, i, t), state, inputs, targets,
        n)
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(base), host)):
        raise RuntimeError("lora-train: the frozen base changed")
    if not any(ab["b"].any() for ab in state["adapters"].values()):
        raise RuntimeError("lora-train: the adapters did not move")
    if tree_map(lambda t: t.requires_grad, base) != tree_map(
            lambda t: False, base):
        raise RuntimeError("lora-train: the base requires a gradient")
    return times, losses, launches, fallbacks, peak, base_loss


def lora_train_path(torch, build, smi):
    """3 LoRA steps over a bf16 base, then 3 QLoRA steps over its
    ``quantize_params`` (the bf16 base freed first), at the reference's
    training preset: 12/12/12 flash launches per step, step 0's loss the
    base model's, the base bitwise unchanged, QLoRA's peak at least
    QLORA_SAVING_GIB below LoRA's."""
    from tpushare_torch.workloads.lora import lora_param_count
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    from tpushare_torch.workloads.quant import qmm, quantize_params
    cfg = TransformerConfig(**TRAIN_PRESET)
    gen = torch.Generator(device="cuda").manual_seed(13)
    base = init_params(gen, cfg, "cuda")
    inputs = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S), generator=gen,
                           device="cuda")
    targets = torch.roll(inputs, -1, dims=1)
    n = 3
    want = {k: n * cfg.n_layers for k in TRAIN_KERNELS}
    runs, total = {}, {}
    for label in ("lora", "qlora"):
        mm = None
        if label == "qlora":
            base, mm = quantize_params(base), qmm
            torch.cuda.empty_cache()
        base_bytes = tree_bytes(base)
        times, losses, launches, fallbacks, peak, base_loss = lora_run(
            torch, build, cfg, base, mm, inputs, targets, n, 14)
        got = {k: launches[k] for k in TRAIN_KERNELS}
        if got != want or any(launches[k] for k in launches
                              if k not in TRAIN_KERNELS) or fallbacks:
            raise RuntimeError(f"{label} launches {launches} != {want} "
                               f"(fallbacks {fallbacks})")
        if not all(map(math.isfinite, losses)) or losses[0] != base_loss:
            raise RuntimeError(f"{label}: step 0 loss {losses[0]} is not the "
                               f"base model's {base_loss} ({losses})")
        total = {k: total.get(k, 0) + c for k, c in launches.items()}
        runs[label] = dict(step_ms=statistics.median(times[1:]) * 1e3,
                           first_loss=losses[0], last_loss=losses[-1],
                           peak_mem_gib=peak / 2 ** 30,
                           base_gib=base_bytes / 2 ** 30)
    saving = runs["lora"]["peak_mem_gib"] - runs["qlora"]["peak_mem_gib"]
    phase("lora-train", rank=LORA_RANK, targets="wq+wv", batch=TRAIN_B,
          seq=TRAIN_S, steps=n,
          adapter_params=lora_param_count(cfg, LORA_RANK),
          **{f"{label}_{k}": v for label, r in runs.items()
             for k, v in r.items()},
          qlora_peak_saving_gib=saving,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS},
          card=repr(smi))
    if not saving >= QLORA_SAVING_GIB:
        raise RuntimeError(f"QLoRA's peak is only {saving:.3f} GiB below "
                           f"LoRA's (< {QLORA_SAVING_GIB})")
    return total


# the MoE width of the reference's benchmark (bench.py's MoE payload):
# 906,052,608 params, B=4 x S=512
MOE_PRESET = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8,
                  d_ff=4096, max_seq=512, n_experts=8, expert_top_k=2)
MOE_B, MOE_S = 4, 512
# the f32 identity: head_dim 64 on the paged engine (moe-serve's K5 and
# K1 shapes), 128 on the slot engine (the ragged read's only width)
MOE_F32 = dict(vocab=512, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=512, max_seq=512, n_experts=4, expert_top_k=2)
MOE_F32_SLOT = {**MOE_F32, "n_heads": 2, "n_kv_heads": 1}


def moe_setup(torch):
    from tpushare_torch.workloads.models.moe import (MoEConfig,
                                                     init_moe_params,
                                                     moe_param_count)
    cfg = MoEConfig(**MOE_PRESET)
    params = init_moe_params(torch.Generator(device="cuda").manual_seed(5),
                             cfg, "cuda")
    if moe_param_count(cfg) != 906_052_608:
        raise RuntimeError(f"MoE preset holds {moe_param_count(cfg)} params")
    return cfg, params


def moe_forward_path(torch, build, cfg, params):
    """``moe_forward`` at B=4 x S=512, a warm-up and 5 timed: 8 flash
    launches per forward and nothing else, finite logits, the aux in
    range. B=1 logits against the plain-attention forward are reported,
    in bf16 and over an f32 copy of the weights, not held to a limit: a
    rounding in attention can flip a near-tied routing choice, and a
    flipped token moves every later token's capacity slot in its
    expert (the exact checks are K1's ``hd64`` and ``moe-train-lse``
    rows, K2 / K3's ``moe-hd64`` row, moe-f32-identity and
    moe-train-f32-parity)."""
    from tpushare_torch.workloads.models.moe import moe_forward
    from tpushare_torch.workloads.ops import registry
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), generator=gen,
                           device="cuda")
    n = 5
    build.reset_launches()
    registry.reset_fallbacks()
    with torch.no_grad():
        moe_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            logits, aux = moe_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        launches = dict(build.LAUNCHES)
        fallbacks = registry.fallback_counts()
        plain, _ = moe_forward(params, tokens[:1],
                               dataclasses.replace(cfg, attn_impl="xla"))
        kernel, _ = moe_forward(params, tokens[:1], cfg)
        f32 = {k: v.float() for k, v in params["layers"].items()}
        f32 = {"embed": params["embed"].float(), "layers": f32,
               "norm_f": params["norm_f"].float(),
               "out": params["out"].float()}
        fcfg = dataclasses.replace(cfg, dtype=torch.float32)
        f32_plain, _ = moe_forward(f32, tokens[:1],
                                   dataclasses.replace(fcfg, attn_impl="xla"))
        f32_kernel, _ = moe_forward(f32, tokens[:1], fcfg)
        del f32
    others = {k: c for k, c in launches.items() if k != "flash_fwd"}
    if launches["flash_fwd"] != cfg.n_layers * (n + 1) or any(
            others.values()) or fallbacks:
        raise RuntimeError(f"moe-forward launches {launches} != "
                           f"{cfg.n_layers} x {n + 1} forwards of flash alone "
                           f"(fallbacks {fallbacks})")
    if logits.shape != (MOE_B, MOE_S, cfg.vocab) or \
            not torch.isfinite(logits).all() or \
            not 0.9 < aux.item() < cfg.n_experts:
        raise RuntimeError(f"moe-forward logits / aux {aux.item()} wrong")
    scale = plain.abs().max().item()
    phase("moe-forward", params_b=906_052_608 / 1e9, batch=MOE_B, seq=MOE_S,
          ms=dt * 1e3, tokens_per_s=MOE_B * MOE_S / dt, aux=aux.item(),
          capacity=cfg.expert_capacity,
          flash_launches=launches["flash_fwd"],
          plain_rel_err=max_err(kernel, plain) / scale,
          plain_argmax_agreement=(kernel.argmax(-1) == plain.argmax(-1))
          .float().mean().item(),
          f32_plain_rel_err=max_err(f32_kernel, f32_plain)
          / f32_plain.abs().max().item(),
          f32_plain_argmax_agreement=(f32_kernel.argmax(-1)
                                      == f32_plain.argmax(-1))
          .float().mean().item())
    return launches


def moe_serve_path(torch, build, infer, cfg, params):
    """The serve traffic (16 requests, prompt 128, up to 128 new tokens)
    through the paged engine (8 lanes, K5 at head_dim 64: 8 launches per
    decode step) and the slot engine (4 slots, the einsum read: no
    decode kernel), admission's chunks through the cached chunk's
    kernel on both, every request completed, no page leaked, no
    fallback."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  ServingEngine)
    args = infer.parse_args(SERVE_ARGS)
    plen, max_seq = 128, 256
    fields = {}
    launched = {}
    for label in ("paged", "slot"):
        if label == "paged":
            eng = PagedServingEngine(params, cfg, n_lanes=8, max_seq=max_seq,
                                     n_pages=8 * (max_seq // 32) + 1,
                                     page_size=32, prompt_buckets=(plen,),
                                     chunk=16, seed=args.seed)
            lanes = 8
        else:
            eng = ServingEngine(params, cfg, n_slots=4, max_seq=max_seq,
                                prompt_buckets=(plen,), chunk=16,
                                seed=args.seed)
            lanes = 4
        build.reset_launches()
        registry.reset_fallbacks()
        res = infer.serve_traffic(eng, args, cfg, torch.device("cuda"), plen,
                                  max_seq, lanes)
        launches = dict(build.LAUNCHES)
        fallbacks = registry.fallback_counts()
        steps = res["warmup_decode_steps"] + res["decode_steps"]
        bad = [r.status for r in res["requests"] if r.status != "completed"
               or len(r.output) != r.max_new]
        if bad or fallbacks:
            raise RuntimeError(f"moe-serve {label}: {bad} (fallbacks "
                               f"{fallbacks})")
        want = ({"paged_decode": cfg.n_layers * steps} if label == "paged"
                else {})
        if {k: c for k, c in without_chunks(
                f"moe-serve {label}", launches, res["prefill_chunks"],
                cfg.n_layers).items()
                if c} != want:
            raise RuntimeError(f"moe-serve {label} launches {launches} != "
                               f"{want}")
        if label == "paged" and (eng.attn_impl != "paged"
                                 or eng.alloc.pages_in_use()):
            raise RuntimeError(f"moe-serve paged read {eng.attn_impl}, "
                               f"{eng.alloc.pages_in_use()} pages held")
        ttft = res["ttft_s"]
        fields.update({f"{label}_tokens_per_s": res["tokens_per_s"],
                       f"{label}_tokens": res["tokens"],
                       f"{label}_ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
                       f"{label}_decode_steps": steps,
                       f"{label}_launches": launches["paged_decode"]})
        launched[label] = launches
        del eng, res
        torch.cuda.empty_cache()
    phase("moe-serve", requests=16, prefill_capacity=cfg.capacity_for(plen),
          decode_capacity=cfg.capacity_for(1), **fields)
    return launched["paged"]


def moe_train_path(torch, build, cfg, params):
    """3 steps of ``make_moe_train_step`` at B=4 x S=512 (the params are
    trained in place: the last MoE phase): 8/8/8 flash launches per step,
    no fallback, a finite falling loss."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.train import (init_state,
                                                make_moe_train_step,
                                                make_optimizer)
    opt = make_optimizer()
    state = init_state(params, opt)
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), generator=gen,
                           device="cuda")
    targets = torch.roll(inputs, -1, dims=1)
    step = make_moe_train_step(cfg, opt, "cuda")
    n = 3
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    registry.reset_fallbacks()
    state, times, losses = run_steps(torch, step, state, inputs, targets, n)
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    want = {k: n * cfg.n_layers for k in TRAIN_KERNELS}
    if {k: launches[k] for k in TRAIN_KERNELS} != want or any(
            launches[k] for k in launches if k not in TRAIN_KERNELS) or \
            fallbacks:
        raise RuntimeError(f"moe-train launches {launches} != {want} "
                           f"(fallbacks {fallbacks})")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"moe-train losses not finite and falling: "
                           f"{losses}")
    step_s = statistics.median(times[1:])
    phase("moe-train", batch=MOE_B, seq=MOE_S, steps=n,
          first_loss=losses[0], last_loss=losses[-1], step_ms=step_s * 1e3,
          first_step_ms=times[0] * 1e3, tokens_per_s=MOE_B * MOE_S / step_s,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS})
    return launches


def moe_f32_identity(torch, build):
    """2-layer f32 MoEs: the paged engine through K5 (head_dim 64)
    against the gather twin, the slot engine through K4 (head_dim 128)
    against the einsum read and the pipelined loop, and ``moe_generate``
    (head_dim 64) with a flash prefill against the plain one — greedy
    tokens equal."""
    from tpushare_torch.workloads.moe_decode import moe_generate
    params, cfg, rng, pn, ptokens, plaunched = paged_identity(
        torch, build, "bf16",
        setup=f32_setup(torch, MOE_F32, 15, 6, 60, (4, 40), moe=True))
    sn, stokens, slaunched = slot_identity(
        torch, build, kv_int8=False,
        setup=f32_setup(torch, MOE_F32_SLOT, 16, 6, 90, (8, 120),
                        moe=True))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 77))).cuda()
    before = build.LAUNCHES["flash_fwd"]
    g_kernel = moe_generate(params, prompt, cfg, 16)
    prefill_launches = build.LAUNCHES["flash_fwd"] - before
    g_plain = moe_generate(params, prompt,
                           dataclasses.replace(cfg, attn_impl="xla"), 16)
    if prefill_launches != cfg.n_layers or not torch.equal(g_kernel,
                                                           g_plain):
        raise RuntimeError(f"f32 moe_generate: flash prefill "
                           f"({prefill_launches} launches) != plain prefill")
    phase("moe-f32-identity", paged_requests=pn, paged_tokens=ptokens,
          paged_launches=plaunched, slot_requests=sn, slot_tokens=stokens,
          ragged_launches=slaunched["kernel"]["ragged_decode"],
          generate_tokens=int(g_kernel.numel()),
          prefill_flash_launches=prefill_launches, identical=True)


# ---------------------------------------------------------------------------
# fleet serving: the router over co-resident paged engines, the page
# handoff, disaggregation, salvage, replication, the cross-process fleet
# ---------------------------------------------------------------------------

FLEET_F32_KW = dict(n_lanes=3, max_seq=128, n_pages=40, page_size=16,
                    prompt_buckets=(16, 64), chunk=4)
# manual probes: the phases open members themselves
FLEET_KNOBS = dict(probe_interval_s=1000.0, probe_timeout_s=0.5,
                   breaker_cooldown_s=0.05, half_open_probes=1)


def count_inside(build, obj, methods, into: dict) -> dict:
    """Wrap ``obj``'s ``methods`` so every kernel launch made inside one
    of them adds to ``into[kernel]``: one member's share of the
    process-wide counts."""
    for m in methods:
        fn = getattr(obj, m)

        def wrapped(*a, _fn=fn, **kw):
            before = dict(build.LAUNCHES)
            try:
                return _fn(*a, **kw)
            finally:
                for k, n in build.LAUNCHES.items():
                    if n != before[k]:
                        into[k] = into.get(k, 0) + n - before[k]
        setattr(obj, m, wrapped)
    return into


def live_page_ids(eng, lane) -> list:
    from tpushare_torch.workloads import paging
    return eng.alloc.table(lane)[:paging.pages_for_rows(
        eng._lengths[lane], eng.alloc.page_size)]


def planes_equal(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def handoff_bitwise(torch, make, prompt, max_new, codec):
    """(a) of ``fleet-f32-identity``: a request admitted and one chunk
    decoded on one engine, extracted and installed into another — its
    pages bitwise equal on the card, ``q`` and ``s`` under int8 — and
    finished there with the unmigrated engine's tokens. The controls must
    fail the same byte check: an install that drops the last page, and
    (int8) one that installs the pages dequantized to bf16 and quantized
    again. Returns the phase's fields."""
    from tpushare_torch.workloads.decode import kv_dequantize, kv_quantize
    from tpushare_torch.workloads.serving import Request
    src, dst = make(), make()
    q = Request(prompt=list(prompt), max_new=max_new)
    src.submit(q)
    src.step()                  # admission and one decode chunk
    lane = next(iter(src.running))
    before = planes_at(torch, src.state, live_page_ids(src, lane))
    record = src.extract_request(lane)

    def installed(rec):
        got_lane = dst.install_request(rec)
        got = planes_at(torch, dst.state, dst.alloc.table(got_lane))
        return got_lane, planes_equal(torch, before, got)

    def drop_last(leaf):
        if isinstance(leaf, dict):
            return {p: drop_last(leaf[p]) for p in ("q", "s")}
        out = leaf.clone()
        out[:, -1] = 0
        return out

    controls = {}
    variants = {"drop_last_page": {"k": drop_last(record["k"]),
                                   "v": drop_last(record["v"])}}
    if codec == "int8":
        variants["requantized"] = {
            side: kv_quantize(kv_dequantize(record[side],
                                            torch.bfloat16).float())
            for side in ("k", "v")}
    for label, planes in variants.items():
        bad_lane, same = installed({**record, **planes})
        dst.cancel_request(bad_lane)
        controls[label] = same
    good_lane, bitwise = installed(record)
    src.detach_request(lane)
    dst.run()
    stay = make()
    want = transcripts(stay, [(list(prompt), max_new)])[0]
    if not bitwise or any(controls.values()) or q.output != want or \
            dst.alloc.pages_in_use() or src.alloc.pages_in_use():
        raise RuntimeError(f"fleet f32 ({codec}) handoff: bitwise "
                           f"{bitwise}, controls passing {controls}, tokens "
                           f"== unmigrated {q.output == want}")
    return {"handoff_bitwise": bitwise, "handoff_pages": before[0].shape[1],
            **{f"control_{k}_passes": v for k, v in controls.items()}}


def sampled_migration(torch, params, cfg, reseed=False):
    """(d) of ``fleet-f32-identity``: a temperature-0.8 request served on
    one engine, and the same request, same seed, moved mid-decode to an
    engine of another seed — its CUDA generator's state (seed and Philox
    offset) rides the record. ``reseed`` is the control: the destination
    gets a freshly seeded generator. Returns (unmigrated, migrated)."""
    from tpushare_torch.workloads.serving import PagedServingEngine, Request

    def make(seed):
        return PagedServingEngine(params, cfg, seed=seed, attn_impl="paged",
                                  **FLEET_F32_KW)

    prompt = list(range(3, 14))
    stay = make(7)
    q_stay = Request(prompt=prompt, max_new=24, temperature=0.8)
    stay.submit(q_stay)
    stay.run()
    src = make(7)
    q = Request(prompt=prompt, max_new=24, temperature=0.8)
    src.submit(q)
    src.step()
    src.step()
    lane = next(iter(src.running))
    record = src.extract_request(lane)
    if reseed:
        fresh = torch.Generator(device="cuda")
        fresh.manual_seed(12345)
        record = {**record, "generator": fresh.get_state()}
    dst = make(99)
    if dst.install_request(record) is None:
        raise RuntimeError("fleet f32: the sampler's install was refused")
    src.detach_request(lane)
    dst.run()
    return q_stay, q


def fleet_f32_identity(torch, build):
    """A 2-layer f32 config on both pool codecs, kernels (K5, K5-int8,
    K1 at registration) against ``attn_impl="xla"``: (a) the handoff
    bitwise with its failing controls (``handoff_bitwise``); (b) a
    disaggregated 2-member fleet gives one engine's greedy tokens, with
    no decode launch on the prefill member; (c) ``open_member`` on a
    member with running lanes salvages them mid-decode by migration,
    their tokens those of the unmigrated run; (e) a prefix replicated to
    a second engine launches no K1 there and serves the source's tokens.
    Then (d), sampled: a sampler migrated mid-decode on CUDA generators
    equals the unmigrated run, and the reseeded control does not."""
    from tpushare_torch.workloads.fleet import FleetRouter
    from tpushare_torch.workloads.serving import PagedServingEngine
    cfg, params, specs, rng = f32_setup(torch, PAGED_F32, 15, 6, 60,
                                        (8, 40))
    prefix = rng.integers(0, cfg.vocab, 21).tolist()
    fields = {}
    for codec in ("bf16", "int8"):
        k5 = "paged_decode_int8" if codec == "int8" else "paged_decode"

        def make(impl="paged", **kw):
            return PagedServingEngine(params, cfg, kv_codec=codec,
                                      attn_impl=impl,
                                      **{**FLEET_F32_KW, **kw})

        fields.update({f"{codec}_{k}": v for k, v in handoff_bitwise(
            torch, make, specs[0][0], specs[0][1], codec).items()})
        one = transcripts(make(), specs)
        if transcripts(make("xla"), specs) != one:
            raise RuntimeError(f"fleet f32 ({codec}): kernel != twin")
        # (b) disaggregated
        members = [make(), make()]
        prefill_launches = count_inside(build, members[0],
                                        ("prefill_step", "step"), {})
        before = build.LAUNCHES[k5]
        r = FleetRouter(members, disaggregate=True, publish=False)
        disagg = transcripts(r, specs)
        decode_launches = build.LAUNCHES[k5] - before
        if disagg != one or prefill_launches.get(k5) or \
                not decode_launches or r.stats["handoffs"] != len(specs) \
                or any(e.alloc.pages_in_use() for e in members):
            raise RuntimeError(f"fleet f32 ({codec}) disaggregated: tokens "
                               f"== one engine {disagg == one}, prefill "
                               f"member launches {prefill_launches}, "
                               f"{k5} {decode_launches}, router {r.stats}")
        # (c) salvage mid-decode
        members = [make(n_lanes=6, n_pages=80), make(n_lanes=6, n_pages=80)]
        r = FleetRouter(members, publish=False, **FLEET_KNOBS)
        reqs = served_start(r, specs)
        for _ in range(3):
            r.step()
        victims = sum(1 for q in members[0].running.values() if q.output)
        r.open_member(0)
        r.run()
        salvaged = [q.output for q in reqs]
        if not victims or r.stats["migrations"] < victims or \
                salvaged != one or members[1].alloc.pages_in_use():
            raise RuntimeError(f"fleet f32 ({codec}) salvage: {victims} "
                               f"victims, router {r.stats}, tokens == "
                               f"unmigrated {salvaged == one}")
        # (e) replication: no K1 on the replica
        src, dst = make(), make()
        flash0 = build.LAUNCHES["flash_fwd"]
        src.register_prefix("sys", prefix)
        home_k1 = build.LAUNCHES["flash_fwd"] - flash0
        flash0 = build.LAUNCHES["flash_fwd"]
        dst.install_prefix_pages("sys", prefix, src.extract_prefix("sys"))
        replica_k1 = build.LAUNCHES["flash_fwd"] - flash0
        same_pins = planes_equal(
            torch, planes_at(torch, src.state, src.prefixes["sys"][1]),
            planes_at(torch, dst.state, dst.prefixes["sys"][1]))
        on_src = transcripts(src, specs, prefix="sys")
        on_dst = transcripts(dst, specs, prefix="sys")
        for e in (src, dst):
            e.drop_prefix("sys")
        if home_k1 != cfg.n_layers or replica_k1 or not same_pins or \
                on_src != on_dst or src.alloc.pages_in_use() or \
                dst.alloc.pages_in_use():
            raise RuntimeError(f"fleet f32 ({codec}) replication: K1 home "
                               f"{home_k1} replica {replica_k1}, pins "
                               f"bitwise {same_pins}, tokens equal "
                               f"{on_src == on_dst}")
        fields.update({f"{codec}_disagg_handoffs": len(specs),
                       f"{codec}_disagg_{k5}": decode_launches,
                       f"{codec}_prefill_member_{k5}":
                           prefill_launches.get(k5, 0),
                       f"{codec}_salvaged": victims,
                       f"{codec}_replica_flash": replica_k1,
                       f"{codec}_home_flash": home_k1})
    stay, moved = sampled_migration(torch, params, cfg)
    c_stay, c_moved = sampled_migration(torch, params, cfg, reseed=True)
    if moved.output != stay.output or c_moved.output == c_stay.output:
        raise RuntimeError(f"fleet f32 sampled migration: continues "
                           f"{moved.output == stay.output}, reseeded "
                           f"control parts {c_moved.output != c_stay.output}")
    diverge = next(i for i, (a, b) in enumerate(zip(c_moved.output,
                                                    c_stay.output))
                   if a != b)
    phase("fleet-f32-identity", requests=len(specs), **fields,
          sampled_tokens=len(moved.output), sampled_continues=True,
          reseeded_control_parts_at=diverge)


def served_start(front, specs, prefix=None):
    """Submit ``specs`` to ``front`` (an engine or a router); the
    requests, not yet run."""
    from tpushare_torch.workloads.serving import Request
    reqs = [Request(prompt=list(p), max_new=n, prefix=prefix)
            for p, n in specs]
    for r in reqs:
        front.submit(r)
    return reqs


def smi_memory_mib() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def fleet_serve(torch, build, infer, extra):
    """One ``infer --mode serve --paged`` run over a fleet (``extra``
    names it) at the serve traffic, the counts zeroed just before and
    the prefill member's own launches counted apart. Every request
    completes; every member pool is empty after; the router's merged
    snapshot is taken and the process provider cleared."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    args = infer.parse_args(SERVE_ARGS + ["--paged"] + extra)
    setup = infer.serve_engine(args)
    router = setup["router"]
    prefill = {}
    if router.disaggregate:
        count_inside(build, router.engines[0], ("prefill_step", "step"),
                     prefill)
    torch.cuda.synchronize()
    build.reset_launches()
    registry.reset_fallbacks()
    res = infer.serve_traffic(router, args, setup["cfg"], setup["device"],
                              setup["plen"], setup["max_seq"],
                              setup["n_lanes"])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    set_snapshot_provider(None)
    reqs = res["requests"]
    bad = [r.status for r in reqs if r.status != "completed"
           or len(r.output) != r.max_new]
    leaks = [e.alloc.pages_in_use() for e in router.engines
             if hasattr(e, "alloc")]
    if bad or any(leaks) or fallbacks or launches["flash_fwd"]:
        raise RuntimeError(f"fleet serve {extra}: statuses {bad}, pages "
                           f"{leaks}, fallbacks {fallbacks}, launches "
                           f"{launches}")
    ttft = res["ttft_s"]
    snap = res["telemetry"]
    from tpushare_torch import consts
    fields = dict(tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
                  seconds=res["seconds"],
                  ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
                  ttft_max_ms=ttft[-1] * 1e3,
                  decode_p99_ms=snap[consts.TELEMETRY_DECODE_P99_MS],
                  handoffs=router.stats["handoffs"],
                  reasons=json.dumps(router.stats["reasons"],
                                     separators=(",", ":")),
                  states="+".join(router.member_states()),
                  member_lanes="+".join(str(e.n_lanes)
                                        for e in router.engines),
                  member_pages="+".join(str(e.alloc.n_pages)
                                        for e in router.engines
                                        if hasattr(e, "alloc")),
                  handoffs_in="+".join(str(e.stats["handoffs_in"])
                                       for e in router.engines),
                  handoffs_out="+".join(str(e.stats["handoffs_out"])
                                        for e in router.engines),
                  member_decode_steps="+".join(
                      str(w + s) for w, s in zip(
                          res["member_warmup_decode_steps"],
                          res["member_decode_steps"])))
    return res, router, launches, prefill, fields


def serve_fleet_path(torch, build, infer):
    """``serve --paged --fleet 2`` over ``serve``'s 16 flagship requests,
    then ``--disaggregate`` on a bf16 and on an int8 pool: K5 (K5-int8)
    launches equal 16 x the decode steps summed over the decode members,
    none on the prefill member, every request completed, every pool
    empty after."""
    launches_all, out = {}, {}
    for label, extra in (("fleet", ["--fleet", "2"]),
                         ("disagg", ["--fleet", "2", "--disaggregate"]),
                         ("disagg_int8", ["--fleet", "2", "--disaggregate",
                                          "--kv-codec", "int8"])):
        res, router, launches, prefill, fields = fleet_serve(
            torch, build, infer, extra)
        cfg = res["engine"].engines[0].cfg
        k5 = ("paged_decode_int8" if "int8" in label else "paged_decode")
        first = 1 if router.disaggregate else 0
        steps = sum(w + s for w, s in zip(
            res["member_warmup_decode_steps"][first:],
            res["member_decode_steps"][first:]))
        others = {k: n for k, n in without_chunks(
            f"serve-fleet {label}", launches, res["prefill_chunks"],
            cfg.n_layers).items()
                  if n and k != k5}
        if launches[k5] != cfg.n_layers * steps or others or \
                prefill.get(k5) or (router.disaggregate and (
                    res["member_decode_steps"][0]
                    or router.stats["handoffs"] != len(res["requests"]))):
            raise RuntimeError(f"serve-fleet {label}: {k5} {launches[k5]} "
                               f"!= {cfg.n_layers} x {steps} decode steps, "
                               f"others {others}, prefill member "
                               f"{prefill}, handoffs {router.stats}")
        out[label] = [r.output for r in res["requests"]]
        for k, n in launches.items():
            launches_all[k] = launches_all.get(k, 0) + n
        phase("serve-fleet", run=label, **fields, decode_steps=steps,
              **{f"{k5}_launches": launches[k5]},
              prefill_member_launches=sum(prefill.values()))
        del res, router
    return launches_all, out


FLEET_AB_LANES, FLEET_AB_N, FLEET_AB_MAX_SEQ = 12, 48, 512


def fleet_ab_traffic():
    """The reference bench's fleet traffic (its full preset): a 100-token
    system prompt, 48 tails of 12-32 tokens, 48-80 new tokens, rng 13."""
    import numpy as np
    rng = np.random.default_rng(13)
    sysp = [int(t) for t in rng.integers(0, 32768, 100)]
    tails = [[int(t) for t in rng.integers(0, 32768,
                                           int(rng.integers(12, 33)))]
             for _ in range(FLEET_AB_N)]
    news = [int(n) for n in rng.integers(48, 81, FLEET_AB_N)]
    return sysp, tails, news


def fleet_ab_arm(torch, build, params, cfg, n_engines=2, disagg=False,
                 affinity=True):
    """One arm of the fleet A/B: 2 members of 12 lanes x 64 pages of 32
    rows (or one engine of 24 lanes x 128 pages), max_seq 512, buckets
    (32, 128), chunk 8, forecast fraction 0.8, the K5 read; a warm burst
    of 8, then the 48 requests timed. ``affinity`` registers the system
    prompt and names it; otherwise it is inlined in every prompt.
    Returns the arm's fields, its K1 launches at registration, those
    counted inside replications and the admission chunks its members
    recorded."""
    from tpushare_torch import consts
    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.fleet import FleetRouter
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    sysp, tails, news = fleet_ab_traffic()
    pages = paging.pages_for_rows(4 * FLEET_AB_MAX_SEQ, 32)
    lanes, pages = ((FLEET_AB_LANES, pages) if n_engines > 1
                    else (2 * FLEET_AB_LANES, 2 * pages))
    members = [PagedServingEngine(
        params, cfg, n_lanes=lanes, max_seq=FLEET_AB_MAX_SEQ, n_pages=pages,
        page_size=32, prompt_buckets=(32, 128), chunk=8,
        decode_forecast_fraction=0.8) for _ in range(n_engines)]
    replica_k1 = {}
    for e in members:
        count_inside(build, e, ("install_prefix_pages",), replica_k1)
    front = FleetRouter(members, disaggregate=disagg, publish=False)
    flash0 = build.LAUNCHES["flash_fwd"]
    if affinity:
        front.register_prefix("sys", sysp)
    home_k1 = build.LAUNCHES["flash_fwd"] - flash0

    def req(i):
        if affinity:
            return Request(prompt=list(tails[i]), max_new=news[i],
                           prefix="sys")
        return Request(prompt=sysp + list(tails[i]), max_new=news[i])

    for r in [req(i) for i in range(8)]:
        front.submit(r)
    front.run()
    warm_replications = front.stats["replications"]
    chunks = sum(e.stats["prefill_chunks"] for e in members)
    front.reset_stats()
    reqs = [req(i) for i in range(FLEET_AB_N)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        front.submit(r)
    front.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    snap = front.snapshot()
    rs = front.stats
    chunks += sum(e.stats["prefill_chunks"] for e in members)
    statuses = sorted({r.status for r in reqs})
    fields = {"tokens_per_s": sum(len(r.output) for r in reqs) / dt,
              "seconds": dt,
              "ttft_p50_ms": snap[consts.TELEMETRY_TTFT_P50_MS],
              "ttft_p99_ms": snap[consts.TELEMETRY_TTFT_P99_MS],
              "decode_p99_ms": snap[consts.TELEMETRY_DECODE_P99_MS],
              "hit_rate": rs["affinity_hits"] / max(1, rs["submitted"]
                                                    - rs["shed"]),
              "prefix_hits": sum(e.stats["prefix_hits"] for e in members),
              "handoffs": rs["handoffs"], "replications": rs["replications"],
              "warm_replications": warm_replications,
              "reasons": json.dumps(rs["reasons"], separators=(",", ":")),
              "statuses": "+".join(statuses)}
    if affinity:
        front.drop_prefix("sys")
    leaks = [e.alloc.pages_in_use() for e in members]
    if statuses != ["completed"] or any(leaks) or (
            affinity and not fields["prefix_hits"]):
        raise RuntimeError(f"fleet-ab arm ({n_engines} engines, disagg "
                           f"{disagg}, affinity {affinity}): statuses "
                           f"{statuses}, pages left {leaks}, fields "
                           f"{fields}")
    return fields, home_k1, replica_k1.get("flash_fwd", 0), chunks


def fleet_ab_path(torch, build, params, cfg):
    """The reference's fleet A/B at its full preset and the flagship's
    widths, on the kernel path: affinity on, affinity off (the prefix
    inlined), disaggregated, and one engine of twice the pages and
    lanes. Per arm: tokens/s, TTFT p50 / p99, decode p99, hit rate,
    handoffs, replications, reasons. Hard: every request completed,
    prefix hits with affinity on, 16 K1 per registration on the first
    home and none inside a replication, every pool empty after the drop,
    no kernel but K1 and K5."""
    from tpushare_torch.workloads.ops import registry
    torch.cuda.synchronize()
    build.reset_launches()
    registry.reset_fallbacks()
    arms = {}
    homes = chunks = 0
    for label, kw in (("affinity", {}), ("affinity_off",
                                         {"affinity": False}),
                      ("disagg", {"disagg": True}),
                      ("single", {"n_engines": 1})):
        fields, home_k1, replica_k1, arm_chunks = fleet_ab_arm(
            torch, build, params, cfg, **kw)
        chunks += arm_chunks
        registered = kw.get("affinity", True)
        homes += registered
        if home_k1 != cfg.n_layers * registered or replica_k1:
            raise RuntimeError(f"fleet-ab {label}: K1 at registration "
                               f"{home_k1}, inside replications "
                               f"{replica_k1}")
        arms[label] = fields
        phase("fleet-ab", arm=label, **fields, home_flash=home_k1,
              replica_flash=replica_k1)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fallbacks = registry.fallback_counts()
    others = {k: n for k, n in without_chunks(
        "fleet-ab", launches, chunks, cfg.n_layers).items()
              if n and k not in ("paged_decode", "flash_fwd")}
    if launches["flash_fwd"] != cfg.n_layers * homes or others or \
            fallbacks or not launches["paged_decode"]:
        raise RuntimeError(f"fleet-ab launches {launches}, fallbacks "
                           f"{fallbacks}")
    phase("fleet-ab", arm="summary",
          affinity_vs_off_ttft_p50=arms["affinity"]["ttft_p50_ms"]
          / max(1e-9, arms["affinity_off"]["ttft_p50_ms"]),
          disagg_vs_affinity_decode_p99=arms["disagg"]["decode_p99_ms"]
          / max(1e-9, arms["affinity"]["decode_p99_ms"]),
          fleet_vs_single_tokens_per_s=arms["affinity"]["tokens_per_s"]
          / arms["single"]["tokens_per_s"],
          paged_launches=launches["paged_decode"],
          flash_launches=launches["flash_fwd"])
    return launches


class FleetHost:
    """A second OS process serving one paged engine on a socket (``argv``:
    ``infer --mode serve --listen 127.0.0.1:0`` with the serve flags, or
    ``FLEET_F32_HOST``), started at once so its start-up overlaps other
    phases; ``address`` waits for its first ``fleet host:`` (or
    ``PORT``) line. Its output is drained on a thread; ``kill`` sends
    SIGKILL and reaps it."""

    def __init__(self, argv: list, timeout_s: float = 300.0):
        import os
        import queue
        import threading
        env = dict(os.environ, PYTHONPATH=str(REPO))
        self.proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        self._lines: queue.Queue = queue.Queue()
        self._deadline = time.monotonic() + timeout_s
        self._address = None

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                self._lines.put(line)
            self._lines.put(None)

        threading.Thread(target=drain, daemon=True).start()

    @property
    def address(self) -> tuple:
        import queue
        while self._address is None:
            try:
                line = self._lines.get(timeout=max(
                    0.1, self._deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                self.kill()
                raise RuntimeError("fleet host never came up: "
                                   + " | ".join(self.lines[-20:]))
            for key in ("fleet host: paged engine at ", "PORT "):
                if line.startswith(key):
                    tail = line[len(key):].split()[0].rstrip(":")
                    host, _, port = tail.rpartition(":")
                    self._address = (host or "127.0.0.1", int(port))
        return self._address

    def kill(self) -> None:
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=60)


def fleet_hosts() -> tuple:
    """The two host processes ``serve-fleet-remote`` joins, started
    before the fleet phases: the flagship ``infer --listen`` and the f32
    check's ``fleet_f32_host``."""
    return (FleetHost([sys.executable, "-m",
                       "tpushare_torch.workloads.infer", "--listen",
                       "127.0.0.1:0"] + SERVE_ARGS + ["--paged"]),
            FleetHost([sys.executable, "-c",
                       FLEET_F32_HOST.format(repo=str(REPO))]))


# the child of the f32 cross-process check: chip_smoke's own engine
FLEET_F32_HOST = (
    "import sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
    "chip_smoke.fleet_f32_host()")


def fleet_f32_host() -> None:
    """Serve ``fleet_f32_identity``'s f32 config on the card from this
    process (the child of ``serve-fleet-remote``'s f32 check)."""
    import torch
    from tpushare_torch.workloads.remote import EngineHost
    from tpushare_torch.workloads.serving import PagedServingEngine
    cfg, params, _, _ = f32_setup(torch, PAGED_F32, 15, 6, 60, (8, 40))
    host = EngineHost(PagedServingEngine(params, cfg, attn_impl="paged",
                                         **FLEET_F32_KW))
    print("PORT", host.address[1], flush=True)
    host.serve_forever()


def f32_remote_identity(torch, build, child):
    """Cross-process identity in f32: the same disaggregated fleet (a
    local prefill member, a decode member of the same shape) with the
    decode member in this process, then in a second OS process on the
    same card — every handoff crossing the wire from one CUDA context to
    the other — over the greedy specs and one temperature-0.8 sampler
    queued last, whose CUDA generator state crosses with its pages. The
    greedy tokens equal the in-process run's; the sampler's tokens equal
    the in-process run's and one engine's, unmigrated, same seed (the
    prefill member seeds it as that engine would: the same admission
    count). Returns (greedy equal, sampler continues, handoffs, wire
    bytes sent)."""
    from tpushare_torch.workloads.fleet import FleetRouter
    from tpushare_torch.workloads.remote import RemoteMember
    from tpushare_torch.workloads.serving import PagedServingEngine, Request
    cfg, params, specs, _ = f32_setup(torch, PAGED_F32, 15, 6, 60, (8, 40))

    def make():
        return PagedServingEngine(params, cfg, attn_impl="paged",
                                  **FLEET_F32_KW)

    def outputs(front):
        reqs = [Request(prompt=list(p), max_new=n) for p, n in specs]
        reqs.append(Request(prompt=list(range(3, 14)), max_new=24,
                            temperature=0.8))
        for r in reqs:
            front.submit(r)
        front.run()
        return [r.output for r in reqs]

    local = outputs(FleetRouter([make(), make()], disaggregate=True,
                                publish=False))
    unmigrated = outputs(make())[-1]
    member = None
    try:
        member = RemoteMember(child.address)
        r = FleetRouter([make(), member], disaggregate=True, publish=False)
        remote = outputs(r)
        handoffs = r.stats["handoffs"]
        sent = member.wire_stats["bytes_sent"]
    finally:
        if member is not None:
            member.close()
        child.kill()
    return (remote[:-1] == local[:-1],
            remote[-1] == local[-1] == unmigrated, handoffs, sent)


def serve_fleet_remote_path(torch, build, infer, disagg_outputs, hosts):
    """Two OS processes on one card. ``hosts`` (``fleet_hosts``, started
    before the fleet phases): an ``infer --listen 127.0.0.1:0`` host with
    the serve flags and seed, and the f32 check's child. ``serve``'s
    requests run from this process with ``--join ADDR --disaggregate``:
    prefill local (its chunks through the cached chunk's kernel, no K5
    here), decode remote, every handoff across the wire. Its greedy tokens are reported against the in-process
    disaggregated run's (bf16: the in-process decode members have 4
    lanes, the host 8, so batch composition may part them) and held
    equal in f32, with a sampler's CUDA generator stream continuing
    across the wire (``f32_remote_identity``, same shapes on both
    sides).
    Then ``--join ADDR`` (host and local engine both serving) with the
    host killed by SIGKILL mid-decode: every request ends in exactly one
    terminal status, the ``member_failed`` sheds counted, the wire
    breaker open, the local pool empty; the card's used memory is read
    before and after the kill."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.serving import Request
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    host, f32_host = hosts
    try:
        addr = f"{host.address[0]}:{host.address[1]}"
        args = infer.parse_args(SERVE_ARGS + ["--paged", "--join", addr,
                                              "--disaggregate"])
        setup = infer.serve_engine(args)
        router = setup["router"]
        remote = router.engines[1]
        wire_ms: list = []
        install = remote.install_request

        def timed_install(record):
            t = time.perf_counter()
            try:
                return install(record)
            finally:
                wire_ms.append((time.perf_counter() - t) * 1e3)
        remote.install_request = timed_install
        torch.cuda.synchronize()
        build.reset_launches()
        registry.reset_fallbacks()
        res = infer.serve_traffic(router, args, setup["cfg"],
                                  setup["device"], setup["plen"],
                                  setup["max_seq"], setup["n_lanes"])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        set_snapshot_provider(None)
        reqs = res["requests"]
        outs = [r.output for r in reqs]
        agree = sum(a == b for a, b in zip(outs, disagg_outputs))
        bad = [r.status for r in reqs if r.status != "completed"]
        local = without_chunks("serve-fleet-remote", launches,
                               res["prefill_chunks"], setup["cfg"].n_layers)
        if bad or any(local.values()) or \
                router.engines[0].alloc.pages_in_use() or \
                router.stats["handoffs"] < len(reqs) or \
                router.member_states() != ["closed", "closed"]:
            raise RuntimeError(f"serve-fleet-remote: statuses {bad}, local "
                               f"launches {launches}, router "
                               f"{router.stats}, states "
                               f"{router.member_states()}")
        ttft = res["ttft_s"]
        wire = remote.wire_stats
        fields = dict(tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
                      ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
                      ttft_max_ms=ttft[-1] * 1e3,
                      handoffs=router.stats["handoffs"],
                      remote_decode_steps=res["member_decode_steps"][1]
                      + res["member_warmup_decode_steps"][1],
                      local_launches=sum(launches.values()),
                      install_ms_p50=statistics.median(wire_ms),
                      install_ms_max=max(wire_ms),
                      wire_mib_sent=wire["bytes_sent"] / 2 ** 20,
                      wire_mib_per_handoff=wire["bytes_sent"] / 2 ** 20
                      / max(1, router.stats["handoffs"]),
                      wire_calls=wire["calls"],
                      wire_faults=wire["wire_faults"],
                      bf16_agree_with_in_process=f"{agree}/{len(reqs)}")
        remote.close()
        del router, setup, res, remote
        f32_equal, f32_sampler, f32_handoffs, f32_sent = \
            f32_remote_identity(torch, build, f32_host)
        if not (f32_equal and f32_sampler):
            raise RuntimeError(f"serve-fleet-remote: f32 across two "
                               f"processes: greedy == in-process "
                               f"{f32_equal}, sampler continues "
                               f"{f32_sampler}")
        # the kill: host and local engine both serve
        args = infer.parse_args(SERVE_ARGS + ["--paged", "--join", addr])
        setup = infer.serve_engine(args)
        router = setup["router"]
        local, remote = router.engines
        reqs = [Request(prompt=list(range(7 + i, 7 + i + 64)), max_new=48)
                for i in range(16)]
        for r in reqs:
            router.submit(r)
        for _ in range(400):
            router.step()
            if any(q.output for q in remote.running.values()):
                break
        in_flight = sum(1 for q in remote.running.values() if q.output)
        if not in_flight:
            raise RuntimeError("serve-fleet-remote: no token in flight on "
                               "the host before the kill")
        mem_before = smi_memory_mib()
        host.kill()
        time.sleep(2.0)
        mem_after = smi_memory_mib()
        router.run()
        set_snapshot_provider(None)
        statuses = [r.status for r in reqs]
        by = {s: statuses.count(s) for s in sorted(set(statuses), key=str)}
        failed = router.stats["reasons"].get("member_failed", 0)
        member = router.healthz()["members"][1]
        # the wire's breaker: consecutive wire faults, or the healthz
        # probe that timed out on the dead socket first
        if not all(r.done for r in reqs) or \
                not set(statuses) <= {"completed", "shed"} or \
                by.get("shed", 0) != failed or failed < in_flight or \
                router.member_states()[1] != "open" or \
                member["reason"] not in ("transport_faults",
                                         "probe_timeout") or \
                local.alloc.pages_in_use() or local.alloc.leaked():
            raise RuntimeError(f"serve-fleet-remote kill: statuses {by}, "
                               f"member_failed {failed}, router "
                               f"{router.stats}, member {member}, local "
                               f"pages {local.alloc.pages_in_use()}")
        remote.close()
        fields.update(kill_in_flight=in_flight,
                      kill_statuses=json.dumps(by, separators=(",", ":")),
                      kill_member_failed=failed,
                      kill_wire_faults=router.stats["wire_faults"],
                      kill_breaker=router.member_states()[1],
                      kill_breaker_reason=member["reason"],
                      kill_migrations=router.stats["migrations"],
                      kill_hedged=router.stats["hedged"],
                      smi_used_mib_before_kill=mem_before,
                      smi_used_mib_after_kill=mem_after,
                      f32_equal=f32_equal,
                      f32_sampler_continues=f32_sampler,
                      f32_handoffs=f32_handoffs,
                      f32_wire_mib=f32_sent / 2 ** 20)
        del router, setup, local, remote
    finally:
        host.kill()
        f32_host.kill()
    phase("serve-fleet-remote", **fields)
    return launches


# ---------------------------------------------------------------------------
# sharded serving (tp×pp): the per-shard reads, the mesh paths, identities
# ---------------------------------------------------------------------------

MESH_TP, MESH_PP = 2, 2


def shard_read_cases(torch):
    """B.9 and B.11: the paged read (K5, K5-int8) with KV heads over tp
    and the ragged read (K4, K4-int8) with heads over tp, at the
    ``serve --paged`` and ``serve --ragged`` shapes over a tp=2 mesh
    naming the card twice. The per-shard launches, concatenated in rank
    order, must equal one unsharded launch bit for bit: the paged read
    over the pool shards a sharded engine holds
    (``sharded_pool.place_state``: one contiguous tensor per shard), the
    ragged read through ``registry._build_decode_ragged`` with the mesh
    (each shard a view of the whole slot cache, read in place). Rank 0's
    shard is then held against its twin and timed beside its bound at
    the per-shard shape. At the ``long`` ragged shape the whole meshed
    read is timed against one unsharded launch, beside the copy of the
    layer's shards that a read from copies would add."""
    from tpushare_torch.workloads import sharded_pool
    from tpushare_torch.workloads.decode import kv_view
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.ops.paged_attention import (paged_decode,
                                                              xla_paged_read)
    from tpushare_torch.workloads.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_plain)
    from tpushare_torch.workloads.parallel.mesh import make_serving_mesh
    dev = torch.device("cuda", 0)
    mesh = make_serving_mesh(MESH_TP, devices=[dev] * MESH_TP)
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = {}
    _, B, H, Hkv, hd, ps, P, max_len, short_max, dtype = PAGED_CASES[0]
    hs, ks = H // MESH_TP, Hkv // MESH_TP

    def stacked(leaf):
        return ({n: t[None] for n, t in leaf.items()}
                if isinstance(leaf, dict) else leaf[None])
    for int8 in (False, True):
        name = "paged_decode_int8" if int8 else "paged_decode"
        q1, kp, vp, tables, kv_lens = paged_inputs(
            torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max, dtype,
            int8=int8)
        one = paged_decode(q1, kp, vp, tables, kv_lens)
        pool = sharded_pool.place_state(
            {"k": stacked(kp), "v": stacked(vp)}, mesh,
            "int8" if int8 else "bf16")
        shards = [(q1[:, r * hs:(r + 1) * hs].contiguous(),
                   kv_view(pool["k"][0][r], 0), kv_view(pool["v"][0][r], 0))
                  for r in range(MESH_TP)]
        sharded = torch.cat([paged_decode(sq, skp, svp, tables, kv_lens)
                             for sq, skp, svp in shards], dim=1)
        if not torch.equal(one, sharded):
            raise RuntimeError(f"{name}: the tp shards' outputs in rank "
                               "order differ from one unsharded launch")
        sq, skp, svp = shards[0]

        def kernel():
            return paged_decode(sq, skp, svp, tables, kv_lens)

        def plain():
            return xla_paged_read(sq[:, None], skp, svp, tables, kv_lens,
                                  hs, ks)[:, 0]
        what = f"{name} tp shard"
        checked = (check_int8 if int8 else check_paged)(what, kernel(),
                                                        plain(), dtype)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        live = int(kv_lens.sum().item())
        unique = paged_unique_rows(torch, tables, kv_lens, ps)
        elem = sq.element_size()
        kv_bytes = (int8_rows_bytes(unique, ks, hd) if int8
                    else 2 * unique * ks * hd * elem)
        n_bytes = kv_bytes + 2 * sq.numel() * elem + tables.numel() * 4 \
            + kv_lens.numel() * 4
        bms, by = bound_ms(n_bytes, 4 * hs * hd * live, dtype)
        row = dict(case="main-path-tp2", form="B.9", B=B, H=hs, Hkv=ks,
                   hd=hd, ps=ps, P=P, dtype=dtype, tp=MESH_TP,
                   rank_order_bitwise=True, **checked, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                   bound_by=by)
        phase("mesh-vs-plain", kernel=name, **row)
        rows[name] = row
        del q1, kp, vp, pool, shards, skp, svp
    _, B, S, H, Hkv, dtype = RAGGED_CASES[0]
    hs, ks = H // MESH_TP, Hkv // MESH_TP
    for int8 in (False, True):
        name = "ragged_decode_int8" if int8 else "ragged_decode"
        q, k, v, lens = ragged_inputs(torch, gen, "serve", B, S, H, Hkv,
                                      dtype, int8=int8)
        one = ragged_decode_attention(q, k, v, lens)
        sharded = registry._build_decode_ragged(mesh, batch=B)(q, k, v,
                                                               lens)
        if not torch.equal(one, sharded):
            raise RuntimeError(f"{name}: the tp shards' outputs in rank "
                               "order differ from one unsharded launch")
        sq = q[:, :hs].contiguous()
        sk = registry._shard(k, slice(None), slice(0, ks), dev)
        sv = registry._shard(v, slice(None), slice(0, ks), dev)

        def kernel():
            return ragged_decode_attention(sq, sk, sv, lens)

        def plain():
            return ragged_decode_plain(sq, sk, sv, lens)
        what = f"{name} tp shard"
        if int8:
            checked = check_int8(what, kernel(), plain(), dtype)
        else:
            got, want = kernel(), plain()
            rel = elem_rel_err(got, want)
            if not rel <= FWD_TOL[dtype]:
                raise RuntimeError(f"{what}: {rel} of the value > "
                                   f"{FWD_TOL[dtype]}")
            checked = dict(max_abs_err=max_err(got, want), rel_err=rel,
                           rel_tol=FWD_TOL[dtype])
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library_ms = None
        if not int8:
            # SDPA with a boolean mask over the shard's heads, as
            # ragged-vs-plain times the unsharded read (no PyTorch call
            # reads int8 rows with per-row scales)
            import torch.nn.functional as F
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= lens[:, None])[:, None, None, :]
            qt, kt, vt = sq[:, :, None, :], sk.transpose(1, 2), \
                sv.transpose(1, 2)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=ks != hs))
            del qt, kt, vt, mask
        live = int((lens.long() + 1).clamp(max=S).sum().item())
        elem = sq.element_size()
        kv_bytes = (int8_rows_bytes(live, ks, RAGGED_HD) if int8
                    else 2 * live * ks * RAGGED_HD * elem)
        n_bytes = kv_bytes + 2 * sq.numel() * elem + 4 * B
        bms, by = bound_ms(n_bytes, 4 * hs * RAGGED_HD * live, dtype)
        row = dict(case="serve-tp2", form="B.11", B=B, S=S, H=hs, Hkv=ks,
                   hd=RAGGED_HD, dtype=dtype, tp=MESH_TP,
                   rank_order_bitwise=True, **checked, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                   bound_by=by)
        phase("mesh-vs-plain", kernel=name, **row)
        rows[name] = row
        del q, k, v, sk, sv
    _, B, S, H, Hkv, dtype = RAGGED_CASES[1]
    ks = Hkv // MESH_TP
    q, k, v, lens = ragged_inputs(torch, gen, "long", B, S, H, Hkv, dtype)
    meshed = registry._build_decode_ragged(mesh, batch=B)

    def unsharded():
        return ragged_decode_attention(q, k, v, lens)

    def shard_copies():
        for r in range(MESH_TP):
            k[:, :, r * ks:(r + 1) * ks].contiguous()
            v[:, :, r * ks:(r + 1) * ks].contiguous()
    if not torch.equal(meshed(q, k, v, lens), unsharded()):
        raise RuntimeError("ragged_decode long: the tp shards' outputs in "
                           "rank order differ from one unsharded launch")
    long = dict(case="long-tp2", B=B, S=S, H=H, Hkv=Hkv, dtype=dtype,
                tp=MESH_TP, rank_order_bitwise=True,
                meshed_ms=time_ms(lambda: meshed(q, k, v, lens)),
                unsharded_ms=time_ms(unsharded),
                shard_copy_ms=time_ms(shard_copies))
    phase("mesh-vs-plain", kernel="ragged_decode", **long)
    rows["ragged_decode"]["long_tp2"] = long
    del q, k, v, lens
    torch.cuda.empty_cache()
    return rows


def serve_mesh_path(torch, build, infer, serve_fields):
    """``serve --tp 2 --pp 2`` at the flagship on ``serve``'s traffic,
    bf16 then int8 pools, over a 2×2 serving mesh naming the card four
    times: the sharded engine's four pool shards, each read by K5
    (K5-int8) on its own — n_layers x tp launches a decode step, none of
    the other rung, no flash (admission is the pipelined chunk prefill),
    every request completed, no page leaked."""
    from tpushare_torch.workloads.ops import registry
    devices = [torch.device("cuda", 0)] * (MESH_TP * MESH_PP)
    out = {}
    for codec in ("bf16", "int8"):
        name = "paged_decode_int8" if codec == "int8" else "paged_decode"
        other = "paged_decode" if codec == "int8" else "paged_decode_int8"
        build.reset_launches()
        registry.reset_fallbacks()
        res = infer.run(infer.parse_args(
            SERVE_ARGS + ["--tp", str(MESH_TP), "--pp", str(MESH_PP),
                          "--kv-codec", codec]), mesh_devices=devices)
        launches = dict(build.LAUNCHES)
        fallbacks = registry.fallback_counts()
        eng, reqs = res["engine"], res["requests"]
        bad = [r.status for r in reqs if r.status != "completed"
               or len(r.output) != r.max_new]
        steps = res["warmup_decode_steps"] + res["decode_steps"]
        per_step = eng.cfg.n_layers * MESH_TP
        if bad or (eng._tp, eng._pp) != (MESH_TP, MESH_PP) or \
                eng.attn_impl != "paged" or eng.alloc.pages_in_use() or \
                eng.alloc.leaked():
            raise RuntimeError(f"serve-mesh {codec}: statuses {bad}, mesh "
                               f"{(eng._tp, eng._pp)}, read {eng.attn_impl}")
        without_chunks(f"serve-mesh {codec}", launches,
                       res["prefill_chunks"], per_step)
        if launches[name] != per_step * steps or launches[other] or \
                launches["flash_fwd"] or fallbacks:
            raise RuntimeError(f"serve-mesh {codec}: launches {launches} != "
                               f"{per_step} x {steps} decode steps on "
                               f"{name} alone (fallbacks {fallbacks})")
        ttft = res["ttft_s"]
        snap = res["telemetry"]
        phase("serve-mesh", kv_codec=codec, tp=MESH_TP, pp=MESH_PP,
              tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
              seconds=res["seconds"], ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
              ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
              launches_per_step=per_step, n_pages=eng.alloc.n_pages,
              pool_shard_mib=snap["kv_pool_shard_mib"],
              serve_tokens_per_s=serve_fields["tokens_per_s"],
              tokens_per_s_ratio=res["tokens_per_s"]
              / serve_fields["tokens_per_s"],
              **{f"{k}_launches": n for k, n in launches.items()})
        out[codec] = launches
        del res, eng, reqs
        torch.cuda.empty_cache()
    return out["bf16"], out["int8"]


def serve_ragged_mesh_path(torch, build, infer, ragged_res):
    """``serve --ragged`` over a tp=2 mesh naming the card twice
    (``ServingEngine(mesh=)``, the ``serve-ragged`` engine's weights and
    traffic), then the same with int8 caches: each layer's read runs K4
    (K4-int8) once per tp shard — n_layers x tp launches a decode step,
    no other kernel but the dense run's admission chunks (the int8 run's
    keep the einsum core, its one fallback) —, the dense run with the
    unsharded ragged run's tokens, request for request."""
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.parallel.mesh import make_serving_mesh
    from tpushare_torch.workloads.serving import ServingEngine
    base = ragged_res["engine"]
    mesh = make_serving_mesh(MESH_TP, devices=[torch.device("cuda", 0)]
                             * MESH_TP)
    args = infer.parse_args(SERVE_ARGS + ["--ragged"])
    out = {}
    for int8 in (False, True):
        name = "ragged_decode_int8" if int8 else "ragged_decode"
        cfg = dataclasses.replace(base.cfg, kv_int8=int8)
        build.reset_launches()
        registry.reset_fallbacks()
        eng = ServingEngine(base.params, cfg, n_slots=base.n_slots,
                            max_seq=base.max_seq,
                            prompt_buckets=base.buckets, chunk=base.chunk,
                            seed=args.seed, top_k=args.top_k, mesh=mesh)
        res = infer.serve_traffic(eng, args, cfg, torch.device("cuda"),
                                  len(ragged_res["requests"][0].prompt),
                                  base.max_seq, base.n_slots)
        launches = dict(build.LAUNCHES)
        fallbacks = registry.fallback_counts()
        bad = [r.status for r in res["requests"] if r.status != "completed"
               or len(r.output) != r.max_new]
        steps = res["warmup_decode_steps"] + res["decode_steps"]
        per_step = cfg.n_layers * MESH_TP
        others = {k: n for k, n in launches.items() if k != name and n}
        if not int8:
            others = without_chunks("serve-ragged-mesh", others,
                                    res["prefill_chunks"], cfg.n_layers)
        fell_back = (not only_codec_chunk_fallbacks(fallbacks) if int8
                     else bool(fallbacks))
        if bad or launches[name] != per_step * steps or \
                any(others.values()) or fell_back:
            raise RuntimeError(f"serve-ragged-mesh int8={int8}: statuses "
                               f"{bad}, launches {launches} != {per_step} "
                               f"x {steps} on {name} (fallbacks "
                               f"{fallbacks})")
        same = None
        if not int8:
            # the per-shard reads are bitwise one launch and nothing else
            # is split: the unsharded run's tokens, request for request
            same = sum(a.output == b.output for a, b in
                       zip(res["requests"], ragged_res["requests"]))
            if same != len(res["requests"]):
                raise RuntimeError(f"serve-ragged-mesh: {same} of "
                                   f"{len(res['requests'])} requests equal "
                                   "the unsharded serve-ragged run's")
        ttft = res["ttft_s"]
        phase("serve-ragged-mesh", kv_int8=int8, tp=MESH_TP,
              tokens_per_s=res["tokens_per_s"], tokens=res["tokens"],
              seconds=res["seconds"], ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
              ttft_max_ms=ttft[-1] * 1e3, decode_steps=steps,
              launches_per_step=per_step,
              ragged_tokens_per_s=ragged_res["tokens_per_s"],
              bf16_requests_equal_unsharded=same,
              **{f"{k}_launches": n for k, n in launches.items()})
        out[int8] = launches
        del eng, res
    torch.cuda.empty_cache()
    return out[False], out[True]


MESH_F32_KW = dict(n_lanes=3, max_seq=128, n_pages=40, page_size=16,
                   prompt_buckets=(16, 64), chunk=4)
# sharded f32 engines vs the unsharded one, the largest distance of a
# request's token logprobs: a tp column shard is a cuBLAS GEMM over half
# the columns, which need not round as the full GEMM's columns (1.67e-6
# read over a bf16 pool on an H100); over an int8 pool a K/V element
# that lands across a quantization step moves a logprob further
# (2.75e-4 read). The ragged read under tp splits no projection: its
# engine must read bitwise.
MESH_F32_LOGP_TOL = {"bf16": 1e-5, "int8": 1e-3}


def mesh_f32_identity(torch, build):
    """2-layer f32 models through sharded engines on the card against the
    unsharded engine: the paged engine over tp2×pp2 on both pool codecs
    with a request joining mid-run, and the slot engine's ragged read
    over tp2 on dense and int8 caches. Greedy tokens must be equal, the
    paged logprobs within ``MESH_F32_LOGP_TOL`` of the unsharded run's
    and the ragged ones bitwise."""
    from tpushare_torch.workloads.parallel.mesh import make_serving_mesh
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  Request, ServingEngine)
    dev = torch.device("cuda", 0)
    cfg, params, specs, _ = f32_setup(torch, PAGED_F32, 21, 6, 60, (8, 40))
    fields = {}

    def paged_run(mesh, codec):
        eng = PagedServingEngine(params, cfg, attn_impl="paged",
                                 kv_codec=codec, mesh=mesh, **MESH_F32_KW)
        first = [Request(prompt=p, max_new=n) for p, n in specs[:-1]]
        for r in first:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        late = Request(prompt=specs[-1][0], max_new=specs[-1][1])
        eng.submit(late)
        eng.run()
        if eng.alloc.pages_in_use() or eng.alloc.leaked():
            raise RuntimeError(f"mesh-f32-identity {codec}: pages leaked")
        return first + [late]

    def distance(a, b):
        return max((abs(x - y) for ra, rb in zip(a, b)
                    for x, y in zip(ra.logprobs, rb.logprobs)), default=0.0)

    for codec in ("bf16", "int8"):
        name = "paged_decode_int8" if codec == "int8" else "paged_decode"
        before = build.LAUNCHES[name]
        sharded = paged_run(make_serving_mesh(
            MESH_TP, MESH_PP, devices=[dev] * (MESH_TP * MESH_PP)), codec)
        launched = build.LAUNCHES[name] - before
        plain = paged_run(None, codec)
        if [r.output for r in sharded] != [r.output for r in plain] or \
                not launched:
            raise RuntimeError(f"mesh-f32-identity paged {codec}: tp2xpp2 "
                               f"tokens differ from the unsharded engine's "
                               f"(K5 launches {launched})")
        gap = distance(sharded, plain)
        if not gap <= MESH_F32_LOGP_TOL[codec]:
            raise RuntimeError(f"mesh-f32-identity paged {codec}: logprobs "
                               f"{gap} from the unsharded engine's > "
                               f"{MESH_F32_LOGP_TOL[codec]}")
        fields[f"paged_{codec}_launches"] = launched
        fields[f"paged_{codec}_logprob_max_abs_diff"] = gap
    scfg, sparams, sspecs, _ = f32_setup(torch, SLOT_F32, 22, 6, 90, (8, 60))
    for int8 in (False, True):
        name = "ragged_decode_int8" if int8 else "ragged_decode"
        rcfg = dataclasses.replace(scfg, ragged_decode=True, kv_int8=int8)
        outs = {}
        for label, mesh in (("tp2", make_serving_mesh(
                MESH_TP, devices=[dev] * MESH_TP)), ("plain", None)):
            before = build.LAUNCHES[name]
            eng = ServingEngine(sparams, rcfg, n_slots=3, max_seq=512,
                                prompt_buckets=(16, 64), chunk=4, mesh=mesh)
            outs[label] = served(eng, sspecs)
            if label == "tp2":
                launched = build.LAUNCHES[name] - before
        gap = distance(outs["tp2"], outs["plain"])
        if [r.output for r in outs["tp2"]] != \
                [r.output for r in outs["plain"]] or not launched or gap:
            raise RuntimeError(f"mesh-f32-identity ragged int8={int8}: "
                               "tp2 tokens or logprobs differ from the "
                               f"unsharded read's ({gap})")
        tag = "int8" if int8 else "bf16"
        fields[f"ragged_{tag}_launches"] = launched
        fields[f"ragged_{tag}_logprob_max_abs_diff"] = gap
    phase("mesh-f32-identity", paged_requests=len(specs),
          slot_requests=len(sspecs), tp=MESH_TP, pp=MESH_PP, **fields)


# ---------------------------------------------------------------------------
# the payload's contract with the device plugin: cap, reports, drain
# ---------------------------------------------------------------------------

PAYLOAD_ARGS = ["--mode", "serve", "--paged", "--requests", "16", "--slots",
                "4", "--seq", "512", "--steps", "128", "--seed", "0"]
# a child that caps itself at 2048 MiB, allocates 1 GiB (fits), then 2 GiB
# more (past the cap), and prints what happened as one JSON line
CAP_CHILD = (
    "import sys, json; sys.path.insert(0, {repo!r}); import torch\n"
    "from tpushare_torch.device import apply_hbm_cap\n"
    "frac = apply_hbm_cap('cuda', 2048, environ={{}})\n"
    "small = torch.empty(1024 * 2**20, dtype=torch.uint8, device='cuda')\n"
    "try:\n"
    "    big = torch.empty(2048 * 2**20, dtype=torch.uint8, device='cuda')\n"
    "    refused = False\n"
    "except torch.cuda.OutOfMemoryError:\n"
    "    refused = True\n"
    "print(json.dumps({{'fraction': frac, 'refused': refused, "
    "'allocated_mib': torch.cuda.memory_allocated() / 2**20}}))\n")


class UsageSink:
    """The node daemon's usage endpoint, played by the smoke: a local
    HTTP server (127.0.0.1) that keeps every POST body and answers each
    with ``answer`` (a drain directive, or nothing)."""

    def __init__(self, answer: dict | None = None):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.bodies: list = []
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                sink.bodies.append(json.loads(self.rfile.read(n)))
                body = json.dumps(answer or {}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/usage"

    def of(self, pod: str) -> list:
        return [b for b in self.bodies if b.get("pod") == pod]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def payload_child(pod: str, limit_mib: int, url: str, extra=()):
    """``infer`` as a pod runs it: a child process with the Allocate env
    contract (the HBM limit, the usage endpoint, the pod identity) and
    no allocator fraction of its own, so it derives its cap."""
    import os
    env = dict(os.environ, PYTHONPATH=str(REPO),
               TPUSHARE_HBM_LIMIT_MIB=str(limit_mib),
               TPUSHARE_USAGE_URL=url, POD_NAME=pod, POD_NAMESPACE="smoke")
    for key in ("XLA_PYTHON_CLIENT_MEM_FRACTION",
                "TPUSHARE_DISABLE_ISOLATION", "TPU_VISIBLE_CHIPS"):
        env.pop(key, None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.workloads.infer",
         *PAYLOAD_ARGS, *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(proc, what: str, timeout_s: float = 300.0) -> str:
    """The child's output once it exited 0 (killed at the timeout)."""
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise RuntimeError(f"{what} did not finish in {timeout_s} s: "
                           f"{out[-2000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{what} exited {proc.returncode}: "
                           f"{out[-3000:]}")
    return out


def child_cap_mib(out: str, total_mib: float, what: str) -> tuple:
    """(fraction, cap MiB) from the child's ``allocator cap:`` line."""
    import re
    m = re.search(r"allocator cap: XLA_PYTHON_CLIENT_MEM_FRACTION=([0-9.]+)",
                  out)
    if not m:
        raise RuntimeError(f"{what} printed no allocator cap: {out[-2000:]}")
    frac = float(m.group(1))
    return frac, frac * total_mib


def child_tokens_per_s(out: str) -> float:
    import re
    m = re.search(r"serve throughput: ([0-9,.]+) tokens/s", out)
    return float(m.group(1).replace(",", "")) if m else float("nan")


def last_report(sink: UsageSink, pod: str, cap_mib: float, what: str):
    """The pod's final usage POST: allocator figures at or under the cap,
    the serving telemetry attached."""
    reports = sink.of(pod)
    if not reports:
        raise RuntimeError(f"{what}: no usage report reached the sink")
    last = reports[-1]
    if last.get("source") != "memory_stats" or \
            last.get("peak_kind") != "allocator" or \
            not last["peak_mib"] <= cap_mib or \
            "telemetry" not in last or not last["telemetry"]:
        raise RuntimeError(f"{what}: final report {last} (cap {cap_mib:.0f} "
                           "MiB)")
    return reports, last


def payload_cap_path(torch):
    """``infer --mode serve --paged`` as a pod at TPUSHARE_HBM_LIMIT_MIB
    32768 (the flagship preset) in a child process, reporting to the
    smoke's sink: the cap is the reference's fraction of the card, the
    final POST's allocator peak lies at or under it with the telemetry
    attached. Beside it a tiny child capped at 2048 MiB allocates 1 GiB
    and is refused 2 GiB more (``torch.cuda.OutOfMemoryError``)."""
    from tpushare_torch.device import memory_fraction
    total_mib = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
    sink = UsageSink()
    child = payload_child("cap", 32768, sink.url)
    tiny = subprocess.Popen([sys.executable, "-c",
                             CAP_CHILD.format(repo=str(REPO))], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        tiny_out = finish(tiny, "the 2048 MiB child")
        out = finish(child, "the payload-cap child")
    finally:
        sink.close()
        for p in (child, tiny):
            if p.poll() is None:
                p.kill()
                p.wait()
    frac, cap_mib = child_cap_mib(out, total_mib, "payload-cap")
    if frac != memory_fraction(32768, total_mib):
        raise RuntimeError(f"payload-cap: fraction {frac} is not the "
                           "reference's rule")
    reports, last = last_report(sink, "cap", cap_mib, "payload-cap")
    tiny_res = json.loads(tiny_out.strip().splitlines()[-1])
    if not tiny_res["refused"] or tiny_res["allocated_mib"] < 1024:
        raise RuntimeError(f"the 2048 MiB child: {tiny_res}")
    phase("payload-cap", limit_mib=32768, fraction=frac, cap_mib=cap_mib,
          card_mib=total_mib, peak_mib=last["peak_mib"],
          used_mib=last["used_mib"], posts=len(reports),
          telemetry_keys=len(last["telemetry"]),
          tokens_per_s=child_tokens_per_s(out),
          tiny_fraction=tiny_res["fraction"],
          tiny_allocated_mib=tiny_res["allocated_mib"],
          tiny_refused_past_cap=tiny_res["refused"])


def payload_coresident_path(torch):
    """Two pods at 36000 MiB each serving on the card at once, each in
    its own child capped at its grant: both complete, each final peak
    under its own cap; the card's used memory (nvidia-smi) sampled while
    they run."""
    total_mib = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
    sink = UsageSink()
    base_used = smi_memory_mib()
    kids = {pod: payload_child(pod, 36000, sink.url)
            for pod in ("co-a", "co-b")}
    peak_used = base_used
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in kids.values()):
            peak_used = max(peak_used, smi_memory_mib())
            time.sleep(0.5)
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("payload-coresident: children hang")
        outs = {pod: finish(p, f"payload-coresident {pod}")
                for pod, p in kids.items()}
    finally:
        sink.close()
        for p in kids.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    fields = {}
    for pod, out in outs.items():
        frac, cap_mib = child_cap_mib(out, total_mib, pod)
        _, last = last_report(sink, pod, cap_mib, f"payload-coresident {pod}")
        tag = pod.replace("-", "_")
        fields.update({f"{tag}_fraction": frac, f"{tag}_cap_mib": cap_mib,
                       f"{tag}_peak_mib": last["peak_mib"],
                       f"{tag}_tokens_per_s": child_tokens_per_s(out)})
    if fields["co_a_fraction"] + fields["co_b_fraction"] > 1.0:
        raise RuntimeError(f"co-resident fractions sum past the card: "
                           f"{fields}")
    phase("payload-coresident", limit_mib_each=36000,
          seconds=time.perf_counter() - t0, smi_used_mib_before=base_used,
          smi_used_mib_peak=peak_used, **fields)


DRAIN_REQUESTS = 48


def payload_drain_path(torch):
    """A pod whose usage endpoint answers every POST ``{"drain": true}``
    (a rebalancer migration): the directive reaches the serving engine
    through the reporter (its 10 s cadence), the engine stops admitting
    and finishes in flight; every request ends in exactly one terminal
    status, and the final POST carries the counters."""
    import re
    total_mib = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
    sink = UsageSink(answer={"drain": True})
    child = payload_child("drain", 32768, sink.url,
                          ["--requests", str(DRAIN_REQUESTS)])
    t0 = time.perf_counter()
    try:
        out = finish(child, "the payload-drain child")
    finally:
        sink.close()
        if child.poll() is None:
            child.kill()
            child.wait()
    _, cap_mib = child_cap_mib(out, total_mib, "payload-drain")
    reports, last = last_report(sink, "drain", cap_mib, "payload-drain")
    m = re.search(r"overload accounting: completed=(\d+) shed=(\d+) "
                  r"deadline_exceeded=(\d+) oom_quarantined=(\d+)", out)
    tel = last["telemetry"]
    if not m or sum(map(int, m.groups())) != DRAIN_REQUESTS or \
            not tel.get("draining") or \
            tel.get("shed_total") != int(m.group(2)):
        raise RuntimeError(f"payload-drain: accounting {m and m.groups()}, "
                           f"final telemetry {tel}: {out[-2000:]}")
    phase("payload-drain", requests=DRAIN_REQUESTS,
          completed=int(m.group(1)), shed=int(m.group(2)),
          deadline_exceeded=int(m.group(3)),
          oom_quarantined=int(m.group(4)), posts=len(reports),
          final_shed_total=tel.get("shed_total"),
          final_draining=tel.get("draining"),
          final_drained=tel.get("drained"),
          seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# training over a mesh: B.10 and B.8 per shard, then the mesh steps. Every
# mesh names cuda:0 as often as it needs (one card measures launches and
# copies, not links)
# ---------------------------------------------------------------------------

# the mesh steps' first loss against the unsharded step's, bf16: the tp
# partial sums are fp32 sums of bf16 products rounded once, where the
# unsharded matmul rounds its fp32 accumulator once — a loss of ~10 moves
# in its 4th digit at most (stated limit; the reading is printed)
MESH_LOSS_TOL = 1e-3
# train-payload-mesh: the resumed run's last loss against the
# uninterrupted run's (bf16 payload model; the resumed steps run on
# another mesh, so their sums round in another order)
PAYLOAD_LOSS_TOL = 2e-2
MESH_KERNELS = TRAIN_KERNELS + SPLASH_KERNELS


def cuda_mesh(torch, **kw):
    from tpushare_torch.workloads.parallel.mesh import make_mesh
    return make_mesh(devices=[torch.device("cuda", 0)] * math.prod(
        kw.values()), **kw)


def sharded_vs_one(torch, build, one, sharded, q, k, v, do, names):
    """One unsharded launch per kernel against the per-shard launches of
    ``sharded`` (outputs and gradients concatenated in rank order):
    bitwise, with the launch counts of each."""
    def run(fn):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        build.reset_launches()
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        return (o, *grads), {n: build.LAUNCHES[n] for n in names}
    want, n_one = run(one)
    got, n_shards = run(sharded)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    return same, n_one, n_shards


def mesh_kernel_cases(torch, build):
    """B.10 (K1-K3 per (dp, tp) shard at the ``train`` shape halved by
    dp2 x tp2) and B.8 (K6-fwd, -dq, -dkv per tp shard at the
    ``train-longctx`` shape halved by tp2): the rank-order outputs and
    gradients equal one unsharded launch bit for bit; rank 0's shard is
    held against its twin and timed beside its bound, its twin and the
    library call at the shard's shape."""
    import torch.nn.functional as F
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.ops.attention import (
        bwd_delta, flash_attention, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dq)
    from tpushare_torch.workloads.ops.splash_attention import (
        prescale, splash_attention, splash_attention_bwd_plain,
        splash_attention_plain, splash_bwd_dkv, splash_bwd_dq, splash_fwd)
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {}
    for form, kind, B, S, H, hd, dp, tp in (
            ("B.10", "flash", TRAIN_B, TRAIN_S, 16, 96, 2, 2),
            ("B.8", "splash", LONGCTX_B, LONGCTX_S, 16, 128, 1, 2)):
        mesh = cuda_mesh(torch, dp=dp, tp=tp)
        choice = registry.select_attention(
            "prefill", impl=kind, seq=S, mesh=mesh, n_heads=H, n_kv_heads=H,
            head_dim=hd, platform="cuda", batch=B)
        q, k, v, do = bwd_inputs(torch, gen, B, S, H, H, hd, "bfloat16")
        names = TRAIN_KERNELS if kind == "flash" else SPLASH_KERNELS
        one = flash_attention if kind == "flash" else splash_attention
        same, n_one, n_shards = sharded_vs_one(torch, build, one, choice.fn,
                                               q, k, v, do, names)
        if not same or set(n_one.values()) != {1} or \
                set(n_shards.values()) != {dp * tp}:
            raise RuntimeError(f"{form}: rank-order shards bitwise one "
                               f"launch: {same}; launches {n_one} / "
                               f"{n_shards}")
        # rank 0's shard: its batch rows and heads, contiguous
        b, h = B // dp, H // tp
        q0, k0, v0, do0 = (x[:b, :, :h].contiguous() for x in (q, k, v, do))
        if kind == "splash":
            q0 = prescale(q0)
            fwd = lambda: splash_fwd(q0, k0, v0, with_lse=True)  # noqa: E731
            o0, lse0 = fwd()
            plain_fwd = lambda: splash_attention_plain(  # noqa: E731
                q0, k0, v0, with_lse=True)
            delta = bwd_delta(do0, o0)
            dq = lambda: splash_bwd_dq(q0, k0, v0, do0, lse0, delta)  # noqa
            dkv = lambda: splash_bwd_dkv(q0, k0, v0, do0, lse0, delta)  # noqa
            plain_bwd = lambda: splash_attention_bwd_plain(  # noqa: E731
                q0, k0, v0, o0, lse0, do0)
            sdpa_kw = dict(is_causal=True, scale=1.0)
        else:
            fwd = lambda: flash_attention_fwd(  # noqa: E731
                q0, k0, v0, with_lse=True)
            o0, lse0 = fwd()
            plain_fwd = lambda: flash_attention_plain(  # noqa: E731
                q0, k0, v0, with_lse=True)
            delta = bwd_delta(do0, o0)
            dq = lambda: flash_bwd_dq(q0, k0, v0, do0, lse0, delta)  # noqa
            dkv = lambda: flash_bwd_dkv(q0, k0, v0, do0, lse0, delta)  # noqa
            plain_bwd = lambda: flash_attention_bwd_plain(  # noqa: E731
                q0, k0, v0, o0, lse0, do0)
            sdpa_kw = dict(is_causal=True)
        want_o, _ = plain_fwd()
        fwd_rel = elem_rel_err(o0, want_o)
        got_g = (dq(), *dkv())
        want_g = plain_bwd()
        bwd_rel = {n: max_err(g, w) / w.float().abs().max().item()
                   for n, g, w in zip(("dq", "dk", "dv"), got_g, want_g)}
        if not (fwd_rel <= FWD_TOL["bfloat16"]
                and max(bwd_rel.values()) <= BWD_TOL["bfloat16"]):
            raise RuntimeError(f"{form} rank-0 shard vs its twin: forward "
                               f"{fwd_rel}, backward {bwd_rel}")
        del want_o, want_g
        ms = {"fwd": time_ms(fwd), "dq": time_ms(dq), "dkv": time_ms(dkv)}
        plain_ms = {"fwd": time_ms(plain_fwd, reps=3, warmup=1),
                    "bwd": time_ms(plain_bwd, reps=3, warmup=1)}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q0, k0, v0))
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_kw))
        ot = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), do0.transpose(1, 2), retain_graph=True))
        x_bytes = 2 * b * S * h * hd
        stat_bytes = 4 * b * h * S
        product = 2 * b * h * hd * live_pairs(S, True, None)
        bounds = {"fwd": bound_ms(4 * x_bytes + stat_bytes, 2 * product,
                                  "bfloat16"),
                  "dq": bound_ms(5 * x_bytes + 2 * stat_bytes, 3 * product,
                                 "bfloat16"),
                  "dkv": bound_ms(6 * x_bytes + 2 * stat_bytes, 4 * product,
                                  "bfloat16")}
        errs = {"fwd": max_err(o0, plain_fwd()[0]),
                "dq": max_err(got_g[0], plain_bwd()[0]),
                "dkv": max(max_err(a, b_) for a, b_ in
                           zip(got_g[1:], plain_bwd()[1:]))}
        for part, name in zip(("fwd", "dq", "dkv"), names):
            row = dict(form=form, kernel=name, B=b, S=S, H=h, Hkv=h, hd=hd,
                       dtype="bfloat16", dp=dp, tp=tp,
                       shards_bitwise_one_launch=same,
                       max_abs_err=errs[part], ms=ms[part],
                       plain_ms=plain_ms["fwd" if part == "fwd" else "bwd"],
                       bound_ms=bounds[part][0], bound_by=bounds[part][1],
                       library_ms=sdpa_fwd_ms if part == "fwd"
                       else sdpa_bwd_ms,
                       over_bound=ms[part] / bounds[part][0],
                       fwd_rel_err=fwd_rel, bwd_rel_err=max(bwd_rel.values()))
            phase("mesh-train-vs-plain", **row)
            rows[name] = row
        del q, k, v, do, q0, k0, v0, do0, qt, kt, vt, ot, got_g
        torch.cuda.empty_cache()
    return rows


def mesh_run(torch, build, step, state, inputs, targets, n):
    """n steps from counts set to 0: (state, times, losses, launches,
    fallbacks, peak GiB)."""
    from tpushare_torch.workloads.ops import registry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    registry.reset_fallbacks()
    state, times, losses = run_steps(torch, step, state, inputs, targets, n)
    return (state, times, losses, dict(build.LAUNCHES),
            registry.fallback_counts(),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def check_mesh_run(label, launches, want, fallbacks, losses, plain_first,
                   falling=True):
    """Launches exactly ``want`` (every other kernel 0), no fallback,
    finite (falling) losses, the first within MESH_LOSS_TOL of the
    unsharded step's; returns that distance."""
    got = {k: launches[k] for k in launches if launches[k] or k in want}
    if got != {k: v for k, v in want.items()}:
        raise RuntimeError(f"{label} launches {got} != {want}")
    if fallbacks:
        raise RuntimeError(f"{label} fell back: {fallbacks}")
    if not all(map(math.isfinite, losses)) or \
            (falling and not losses[-1] < losses[0]):
        raise RuntimeError(f"{label} losses not finite and falling: "
                           f"{losses}")
    rel = abs(losses[0] - plain_first) / abs(plain_first)
    if not rel <= MESH_LOSS_TOL:
        raise RuntimeError(f"{label} first loss {losses[0]} vs the "
                           f"unsharded step's {plain_first}: {rel} > "
                           f"{MESH_LOSS_TOL}")
    return rel


def replicas_equal(torch, state) -> bool:
    """Every replica of every block bitwise equal to its group's first."""
    from tpushare_torch.workloads.parallel.mesh import Sharded

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, Sharded):
            yield tree
    return all(torch.equal(leaf.shards[c], leaf.shards[g[0]])
               for tree in (state["params"], state["opt"]["mu"],
                            state["opt"]["nu"])
               for leaf in leaves(tree) for g in leaf.groups()
               for c in g[1:])


def plain_first_loss(torch, cfg, opt, state, inputs, targets, moe=False):
    """The unsharded step's loss from a copy of ``state``."""
    from tpushare_torch.workloads.train import (make_moe_train_step,
                                                make_train_step)
    make = make_moe_train_step if moe else make_train_step
    copy = clone_state(torch, state)
    _, loss = make(cfg, opt, "cuda")(copy, inputs, targets)
    loss = loss.item()
    del copy
    torch.cuda.empty_cache()
    return loss


def train_mesh_path(torch, build, smi, train_fields):
    """The training preset at dp2 x tp2 (B=8 x S=1024, 6 steps): 48 K1,
    48 K2 and 48 K3 a step (12 layers x 4 shards), nothing else, the
    first loss against the unsharded step's, replicas bitwise equal;
    step ms beside ``train``'s and the peak with two dp replicas of every
    leaf and its moments. Returns the launches, the unsharded first loss
    for ``train-pp`` and the first loss and step ms for
    ``train-multihost``."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import make_train_step, place_state
    cfg = TransformerConfig(**TRAIN_PRESET)
    opt, state, inputs, targets = train_setup(torch, cfg, 6, TRAIN_B,
                                              TRAIN_S)
    plain = plain_first_loss(torch, cfg, opt, state, inputs, targets)
    mesh = cuda_mesh(torch, dp=2, tp=2)
    placed = place_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    n = 6
    placed, times, losses, launches, fallbacks, peak = mesh_run(
        torch, build, make_train_step(cfg, opt, mesh), placed, inputs,
        targets, n)
    per = cfg.n_layers * 4
    rel = check_mesh_run("train-mesh", launches,
                         {k: n * per for k in TRAIN_KERNELS}, fallbacks,
                         losses, plain)
    if not replicas_equal(torch, placed):
        raise RuntimeError("train-mesh: dp replicas differ after the steps")
    step_s = statistics.median(times[1:])
    fields = {"first_loss": losses[0], "step_ms": step_s * 1e3}
    phase("train-mesh", mesh="dp2xtp2", batch=TRAIN_B, seq=TRAIN_S,
          steps=n, first_loss=losses[0], plain_first_loss=plain,
          first_loss_rel_err=rel, loss_tol=MESH_LOSS_TOL,
          last_loss=losses[-1], step_ms=step_s * 1e3,
          train_step_ms=train_fields["step_ms"],
          first_step_ms=times[0] * 1e3,
          tokens_per_s=TRAIN_B * TRAIN_S / step_s, peak_mem_gib=peak,
          train_peak_mem_gib=train_fields["peak_mem_gib"],
          replicas_bitwise_equal=True,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS},
          card=repr(smi))
    del placed
    torch.cuda.empty_cache()
    return launches, plain, fields


def train_longctx_mesh_path(torch, build, infer, smi):
    """Flagship widths at tp2 (B=2 x S=4096, 3 steps): 32 of each splash
    kernel a step (16 layers x 2 shards, the registry's long-context row
    decided on the shard's 8 heads), no flash launch."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import make_train_step, place_state
    cfg = TransformerConfig(**{**infer.PRESETS[-1][1], "max_seq": LONGCTX_S})
    opt, state, inputs, targets = train_setup(torch, cfg, 11, LONGCTX_B,
                                              LONGCTX_S)
    plain = plain_first_loss(torch, cfg, opt, state, inputs, targets)
    mesh = cuda_mesh(torch, dp=1, tp=2)
    placed = place_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    n = 3
    placed, times, losses, launches, fallbacks, peak = mesh_run(
        torch, build, make_train_step(cfg, opt, mesh), placed, inputs,
        targets, n)
    rel = check_mesh_run("train-longctx-mesh", launches,
                         {k: n * cfg.n_layers * 2 for k in SPLASH_KERNELS},
                         fallbacks, losses, plain, falling=False)
    step_s = statistics.median(times[1:])
    phase("train-longctx-mesh", mesh="tp2", batch=LONGCTX_B, seq=LONGCTX_S,
          steps=n, first_loss=losses[0], plain_first_loss=plain,
          first_loss_rel_err=rel, last_loss=losses[-1],
          step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3,
          tokens_per_s=LONGCTX_B * LONGCTX_S / step_s, peak_mem_gib=peak,
          **{f"{k}_per_step": launches[k] / n for k in SPLASH_KERNELS},
          flash_launches=sum(launches[k] for k in TRAIN_KERNELS),
          card=repr(smi))
    del placed
    torch.cuda.empty_cache()
    return launches


RING_B, RING_S, RING_WINDOW = 4, 2048, 512


def train_ring_path(torch, build, smi):
    """The training preset at sp2 (B=4 x S=2048): 3 steps of the zigzag
    ring, then 3 of the banded ring at window 512 — the merges are plain
    PyTorch (the reference's ring is einsums), so no kernel launches;
    each first loss against the unsharded step's (flash, banded under
    the window)."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import make_train_step, place_state
    fields = {}
    for label, window in (("zigzag", None), ("banded", RING_WINDOW)):
        cfg = TransformerConfig(**{**TRAIN_PRESET, "max_seq": RING_S,
                                   "attn_window": window})
        opt, state, inputs, targets = train_setup(torch, cfg, 13, RING_B,
                                                  RING_S)
        plain = plain_first_loss(torch, cfg, opt, state, inputs, targets)
        mesh = cuda_mesh(torch, dp=1, tp=1, sp=2)
        placed = place_state(state, mesh)
        del state
        n = 3
        placed, times, losses, launches, fallbacks, peak = mesh_run(
            torch, build, make_train_step(cfg, opt, mesh,
                                          ring_attention=True),
            placed, inputs, targets, n)
        rel = check_mesh_run(f"train-ring {label}", launches, {}, fallbacks,
                             losses, plain, falling=False)
        fields.update({f"{label}_first_loss": losses[0],
                       f"{label}_plain_first_loss": plain,
                       f"{label}_first_loss_rel_err": rel,
                       f"{label}_last_loss": losses[-1],
                       f"{label}_step_ms":
                           statistics.median(times[1:]) * 1e3,
                       f"{label}_peak_mem_gib": peak})
        del placed
        torch.cuda.empty_cache()
    phase("train-ring", mesh="sp2", batch=RING_B, seq=RING_S, steps=3,
          window=RING_WINDOW, kernel_launches=0, **fields, card=repr(smi))


def train_pp_path(torch, build, smi, plain):
    """The training preset at pp2 x tp2, n_micro 4 (B=8 x S=1024, 3
    steps): each stage runs its 6 layers on 2 tp shards for 4
    microbatches, so 96 K1, 96 K2 and 96 K3 a step; the first loss
    against the unsharded step's (``train-mesh``'s reading)."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.parallel.pipeline import (
        make_pp_train_step, place_pp_state)
    cfg = TransformerConfig(**TRAIN_PRESET)
    opt, state, inputs, targets = train_setup(torch, cfg, 6, TRAIN_B,
                                              TRAIN_S)
    mesh = cuda_mesh(torch, dp=1, tp=2, pp=2)
    placed = place_pp_state(state, mesh)
    del state
    n, n_micro = 3, 4
    placed, times, losses, launches, fallbacks, peak = mesh_run(
        torch, build, make_pp_train_step(cfg, opt, mesh, n_micro=n_micro),
        placed, inputs, targets, n)
    per = cfg.n_layers * 2 * n_micro
    rel = check_mesh_run("train-pp", launches,
                         {k: n * per for k in TRAIN_KERNELS}, fallbacks,
                         losses, plain)
    step_s = statistics.median(times[1:])
    phase("train-pp", mesh="pp2xtp2", n_micro=n_micro, batch=TRAIN_B,
          seq=TRAIN_S, steps=n, first_loss=losses[0],
          plain_first_loss=plain, first_loss_rel_err=rel,
          last_loss=losses[-1], step_ms=step_s * 1e3,
          tokens_per_s=TRAIN_B * TRAIN_S / step_s, peak_mem_gib=peak,
          **{f"{k}_per_step": launches[k] / n for k in TRAIN_KERNELS},
          card=repr(smi))
    del placed
    torch.cuda.empty_cache()
    return launches


def moe_train_ep_path(torch, build, smi):
    """The MoE width at ep2, then pp2 x ep2 (n_micro 2), 3 steps each, B=4
    x S=512: attention on the home device (8 K1 / K2 / K3 a step; 16 over
    two microbatches), each ep rank's 4 experts on its device; first
    losses against the unsharded MoE step's."""
    from tpushare_torch.workloads.parallel.pipeline import (
        make_moe_pp_train_step, place_moe_pp_state)
    from tpushare_torch.workloads.train import (init_state,
                                                make_moe_train_step,
                                                make_optimizer,
                                                place_moe_state)
    cfg, params = moe_setup(torch)
    opt = make_optimizer()
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), generator=gen,
                           device="cuda")
    targets = torch.roll(inputs, -1, dims=1)
    state = init_state(params, opt)
    plain = plain_first_loss(torch, cfg, opt, state, inputs, targets,
                             moe=True)
    fields, all_launches = {}, {}
    for label, kw, n_micro in (("ep2", dict(dp=1, tp=1, ep=2), None),
                               ("pp2xep2", dict(dp=1, tp=1, ep=2, pp=2), 2)):
        mesh = cuda_mesh(torch, **kw)
        if n_micro is None:
            placed = place_moe_state(state, mesh)
            step = make_moe_train_step(cfg, opt, mesh)
        else:
            placed = place_moe_pp_state(state, mesh)
            step = make_moe_pp_train_step(cfg, opt, mesh, n_micro=n_micro)
        n = 3
        placed, times, losses, launches, fallbacks, peak = mesh_run(
            torch, build, step, placed, inputs, targets, n)
        want = {k: n * cfg.n_layers * (n_micro or 1) for k in TRAIN_KERNELS}
        if n_micro is None:
            rel = check_mesh_run(f"moe-train-ep {label}", launches, want,
                                 fallbacks, losses, plain)
        else:
            # two microbatches' router auxes averaged: the first loss
            # moves from the full batch's by that term (reported)
            check_mesh_run(f"moe-train-ep {label}", launches, want,
                           fallbacks, losses, losses[0], falling=False)
            rel = abs(losses[0] - plain) / plain
        fields.update({f"{label}_first_loss": losses[0],
                       f"{label}_first_loss_rel_err": rel,
                       f"{label}_last_loss": losses[-1],
                       f"{label}_step_ms":
                           statistics.median(times[1:]) * 1e3,
                       f"{label}_peak_mem_gib": peak,
                       f"{label}_flash_fwd_per_step":
                           launches["flash_fwd"] / n})
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        del placed, step
        torch.cuda.empty_cache()
    phase("moe-train-ep", batch=MOE_B, seq=MOE_S, steps=3,
          plain_first_loss=plain, **fields, card=repr(smi))
    del state, params
    torch.cuda.empty_cache()
    return all_launches


def grads_rel_err(torch, mesh_grads, plain_grads) -> float:
    """Largest |mesh - plain| as a share of the leaf's largest |plain|,
    over every leaf, the mesh's gathered from its blocks."""
    from tpushare_torch.workloads.train import tree_leaves, tree_map_whole
    whole = tree_map_whole(mesh_grads)
    return max(max_err(a, b) / b.abs().max().item()
               for a, b in zip(tree_leaves(whole), tree_leaves(plain_grads)))


def train_mesh_f32_identity(torch, build):
    """2-layer f32 configs through every mesh form of this slice against
    the unsharded step on the card (both on the kernel path): loss within
    F32_LOSS_TOL (relative), every gradient within F32_GRAD_TOL of its
    leaf's scale; each form's kernels launched (none for the rings)."""
    from tpushare_torch.workloads.models.moe import MoEConfig, moe_loss_fn
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, loss_fn)
    from tpushare_torch.workloads.parallel.pipeline import (
        moe_pp_param_specs, pp_grad_fn, pp_param_specs)
    from tpushare_torch.workloads.parallel.mesh import (moe_param_specs,
                                                        param_specs,
                                                        place_tree)
    from tpushare_torch.workloads.train import loss_and_grads, mesh_grad_fn
    dense = TransformerConfig(vocab=512, d_model=384, n_heads=4,
                              n_kv_heads=2, n_layers=2, d_ff=768,
                              max_seq=256, dtype=torch.float32)
    longctx = TransformerConfig(vocab=512, d_model=512, n_heads=4,
                                n_layers=2, d_ff=1024, max_seq=LONGCTX_S,
                                dtype=torch.float32)
    moe = MoEConfig(**{**MOE_F32, "max_seq": 256, "capacity_factor": 1.0},
                    dtype=torch.float32)
    forms = [  # (label, cfg, B, S, mesh kw, grad kind, kernels launched)
        ("dp2xtp2", dense, 4, 256, dict(dp=2, tp=2), "mesh", TRAIN_KERNELS),
        ("tp2-splash", longctx, 1, LONGCTX_S, dict(dp=1, tp=2), "mesh",
         SPLASH_KERNELS),
        ("sp2-zigzag", dense, 4, 256, dict(dp=1, tp=1, sp=2), "ring", ()),
        ("sp2-banded", dataclasses.replace(dense, attn_window=64), 4, 256,
         dict(dp=1, tp=1, sp=2), "ring", ()),
        ("pp2xtp2", dense, 4, 256, dict(dp=1, tp=2, pp=2), "pp",
         TRAIN_KERNELS),
        ("ep2-moe", moe, 4, 256, dict(dp=1, tp=1, ep=2), "moe",
         TRAIN_KERNELS),
        ("pp2xep2-moe", moe, 4, 256, dict(dp=1, tp=1, ep=2, pp=2), "moe-pp",
         TRAIN_KERNELS),
    ]
    fields = {}
    for label, cfg, B, S, kw, kind, kernels in forms:
        is_moe = kind.startswith("moe")
        _, state, inputs, targets = train_setup(torch, cfg, 21, B, S)
        params = state["params"]
        p_loss, p_grads = loss_and_grads(params, inputs, targets, cfg,
                                         moe_loss_fn if is_moe else loss_fn)
        mesh = cuda_mesh(torch, **kw)
        specs = {"mesh": param_specs, "ring": param_specs,
                 "pp": pp_param_specs, "moe": moe_param_specs,
                 "moe-pp": moe_pp_param_specs}[kind]()
        placed = place_tree(params, specs, mesh)
        if kind in ("pp", "moe-pp"):
            grad_fn = pp_grad_fn(cfg, mesh, n_micro=1 if is_moe else 2,
                                 moe=is_moe)
        else:
            grad_fn = mesh_grad_fn(cfg, mesh, ring_attention=kind == "ring",
                                   moe=is_moe)
        build.reset_launches()
        m_loss, m_grads = grad_fn(placed, inputs, targets)
        launched = {k: build.LAUNCHES[k] for k in MESH_KERNELS}
        loss_err = abs(m_loss.item() - p_loss.item()) / abs(p_loss.item())
        grad_err = grads_rel_err(torch, m_grads, p_grads)
        fields.update({f"{label}_loss_rel_err": loss_err,
                       f"{label}_grad_rel_err": grad_err})
        ok_launch = (all(launched[k] > 0 for k in kernels)
                     and not any(launched[k] for k in MESH_KERNELS
                                 if k not in kernels))
        if not (loss_err <= F32_LOSS_TOL and grad_err <= F32_GRAD_TOL
                and ok_launch):
            raise RuntimeError(f"mesh-f32 {label}: loss {loss_err}, grads "
                               f"{grad_err}, launches {launched}")
        del state, params, placed, p_grads, m_grads
        torch.cuda.empty_cache()
    phase("train-mesh-f32-identity", forms=len(forms),
          loss_tol=F32_LOSS_TOL, grad_tol=F32_GRAD_TOL, **fields)


def payload_mesh_child(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.workloads.train_payload",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def train_payload_mesh_path(torch):
    """The payload as a pod runs it, over dp2 x tp2 on cuda:0 named four
    times under an HBM grant: stopped by SIGTERM after its first step, it
    drains and checkpoints; a restart on dp2 x tp1 resumes and trains to
    step 6; its last loss is held against an uninterrupted dp2 x tp2
    run's."""
    import os
    import re
    import signal
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(REPO),
               TPUSHARE_HBM_LIMIT_MIB="16384")
    for key in ("XLA_PYTHON_CLIENT_MEM_FRACTION",
                "TPUSHARE_DISABLE_ISOLATION", "TPU_VISIBLE_CHIPS"):
        env.pop(key, None)
    common = ["--steps", "6", "--save-every", "1", "--batch", "8",
              "--seq", "64"]
    four = ["--dp", "2", "--tp", "2", "--mesh-devices",
            ",".join(["cuda:0"] * 4)]
    two = ["--dp", "2", "--tp", "1", "--mesh-devices", "cuda:0,cuda:0"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck, ref = os.path.join(tmp, "ck"), os.path.join(tmp, "ref")
        child = payload_mesh_child(common + four + ["--checkpoint-dir", ck],
                                   env)
        lines = []
        try:
            for line in child.stdout:
                lines.append(line)
                if line.startswith("step 1:"):
                    child.send_signal(signal.SIGTERM)
                    break
            out = "".join(lines) + finish(child, "the interrupted payload")
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        m = re.search(r"graceful drain at step (\d+)", out)
        if not m or "mesh: {'dp': 2, 'sp': 1, 'tp': 2" not in out or \
                "allocator cap:" not in out:
            raise RuntimeError(f"the payload did not drain on its mesh: "
                               f"{out[-2000:]}")
        drained = int(m.group(1))
        resumed = finish(payload_mesh_child(
            common + two + ["--checkpoint-dir", ck], env),
            "the resumed payload")
        whole = finish(payload_mesh_child(
            common + four + ["--checkpoint-dir", ref], env),
            "the uninterrupted payload")
    if f"resumed from step {drained}" not in resumed:
        raise RuntimeError(f"no resume from step {drained}: "
                           f"{resumed[-2000:]}")

    def last_loss(out):
        return float(re.findall(r"final loss=([0-9.]+)", out)[-1])
    got, want = last_loss(resumed), last_loss(whole)
    rel = abs(got - want) / abs(want)
    if not rel <= PAYLOAD_LOSS_TOL:
        raise RuntimeError(f"resumed last loss {got} vs uninterrupted "
                           f"{want}: {rel} > {PAYLOAD_LOSS_TOL}")
    phase("train-payload-mesh", mesh="dp2xtp2", drained_at=drained,
          resumed_on="dp2xtp1", last_loss=got, uninterrupted_last_loss=want,
          loss_rel_err=rel, loss_tol=PAYLOAD_LOSS_TOL,
          seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# training over a pod group: two processes on the card, gloo between them
# (A.10's multihost remainder), and the device backend behind the daemon
# ---------------------------------------------------------------------------

MULTIHOST_STEPS = 3
# the f32 forms across two processes against the one-process step over
# the same global mesh (the gathers are exact: what differs is at most
# a library's choice of algorithm in another process)
MULTIHOST_LOSS_TOL = 1e-5
MULTIHOST_PARAM_TOL = 1e-4
MULTIHOST_F32_STEPS = 2
MULTIHOST_RANK = ("import sys; sys.path.insert(0, {repo!r}); "
                  "import chip_smoke; chip_smoke.multihost_rank({kind!r})")
# the f32 forms: (label, global mesh, DCN axis, kind)
MULTIHOST_F32_FORMS = (
    ("dp2xtp2", dict(dp=2, tp=2), "dp", "dense"),
    ("pp2xtp2", dict(dp=1, tp=2, pp=2), "pp", "pp"),
    ("moe-dp2xep2", dict(dp=2, ep=2, tp=1), "dp", "moe"),
)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_pair(argv, extra_env=None, timeout_s: float = 300.0) -> list:
    """Both ranks of a two-process group on the card, under the
    Allocate-shaped group envs (``TPUSHARE_GROUP_RANK`` / ``_SIZE`` /
    ``TPUSHARE_COORDINATOR`` on 127.0.0.1): their outputs by rank once
    both exited 0. A rank that exits non-zero fails the phase at once
    (its peer is killed); no failure is caught or retried."""
    import os
    import tempfile
    port = free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   TPUSHARE_COORDINATOR=f"127.0.0.1:{port}",
                   TPUSHARE_GROUP_SIZE="2", TPUSHARE_GROUP_RANK=str(rank))
        for key in ("XLA_PYTHON_CLIENT_MEM_FRACTION",
                    "TPUSHARE_DISABLE_ISOLATION", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        for key, value in (extra_env or {}).items():
            if value is None:
                env.pop(key, None)       # unset in the child
            else:
                env[key] = value
        log = tempfile.TemporaryFile(mode="w+")
        logs.append(log)
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout_s:
                outs = []
                for log in logs:
                    log.seek(0)
                    outs.append(log.read()[-3000:])
                raise RuntimeError(
                    f"rank(s) {bad or 'both'} of {argv[:3]} "
                    f"{'failed' if bad else 'timed out'}: {outs}")
            time.sleep(0.2)
        outs = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            out = log.read()
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {p.returncode}: "
                                   f"{out[-3000:]}")
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def rank_json(out: str) -> list:
    """The JSON lines a rank printed."""
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def multihost_rank(kind: str) -> None:
    """One rank of the multihost phases (a child process): the process
    group from the Allocate-shaped envs, then ``kind`` (``train``: the
    training preset at dp2 x tp2 with this rank naming cuda:0 twice;
    ``f32``: the f32 forms, its gathered states saved to
    ``TPUSHARE_SMOKE_OUT`` by rank 0). Prints one JSON line per run."""
    import os
    import torch
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.ops import registry
    from tpushare_torch.workloads.parallel import mesh as tmesh
    from tpushare_torch.workloads.parallel import multihost
    from tpushare_torch.workloads.train import gather_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not multihost.init_from_env():
        raise SystemExit("multihost_rank: no TPUSHARE_GROUP_* envs")
    rank = multihost.process_index()
    runs = ([("train", None, "dp", "train")] if kind == "train"
            else MULTIHOST_F32_FORMS)
    for label, mesh_kw, dcn, form in runs:
        cfg, state, inputs, targets, step, place = multihost_form(
            torch, form, mesh_kw)
        mesh = multihost.make_multihost_mesh(
            **(mesh_kw or dict(dp=2, tp=2)), dcn_axis=dcn,
            devices=[torch.device("cuda", 0)] * 2)
        placed = place(state, mesh)
        del state
        torch.cuda.empty_cache()
        B = inputs.shape[0]
        rows = (slice(rank * B // 2, (rank + 1) * B // 2) if dcn == "dp"
                else slice(None))
        inputs = multihost.shard_host_batch(inputs[rows], mesh)
        targets = multihost.shard_host_batch(targets[rows], mesh)
        step = step(cfg, mesh)
        n = MULTIHOST_STEPS if form == "train" else MULTIHOST_F32_STEPS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        registry.reset_fallbacks()
        tmesh.reset_exchanged()
        placed, times, losses = run_steps(torch, step, placed, inputs,
                                          targets, n)
        launches = dict(build.LAUNCHES)
        moved = dict(tmesh.EXCHANGED)
        out = dict(label=label, rank=rank, losses=losses,
                   losses_hex=[x.hex() for x in losses],
                   step_ms=[t * 1e3 for t in times], launches=launches,
                   fallbacks=registry.fallback_counts(),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   gathered_mib_per_step=moved["received_bytes"] / n / 2 ** 20,
                   sent_mib_per_step=moved["sent_bytes"] / n / 2 ** 20,
                   gathers_per_step=moved["calls"] / n,
                   gather_ms_per_step=moved["seconds"] / n * 1e3)
        if form != "train":
            whole = gather_state(placed)["params"]
            if rank == 0:
                torch.save(whole, os.path.join(
                    os.environ["TPUSHARE_SMOKE_OUT"], f"{label}.pt"))
            del whole
        print(json.dumps(out), flush=True)
        del placed, inputs, targets
        torch.cuda.empty_cache()


def multihost_form(torch, form: str, mesh_kw):
    """(cfg, state, inputs, targets, make_step(cfg, mesh), place) of a
    multihost run, the state and batch from the same seed as the one-
    process run it is held against."""
    from tpushare_torch.workloads.models.moe import MoEConfig
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.parallel import pipeline
    from tpushare_torch.workloads.train import (make_moe_train_step,
                                                make_train_step,
                                                place_moe_state, place_state)
    if form == "train":
        cfg = TransformerConfig(**TRAIN_PRESET)
        opt, state, inputs, targets = train_setup(torch, cfg, 6, TRAIN_B,
                                                  TRAIN_S)
        return (cfg, state, inputs, targets,
                lambda cfg, mesh: make_train_step(cfg, opt, mesh),
                place_state)
    if form == "moe":
        cfg = MoEConfig(**{**MOE_F32, "max_seq": 256,
                           "capacity_factor": 1.0}, dtype=torch.float32)
    else:
        cfg = TransformerConfig(vocab=512, d_model=384, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=768,
                                max_seq=256, dtype=torch.float32)
    opt, state, inputs, targets = train_setup(torch, cfg, 21, 4, 256)
    if form == "pp":
        return (cfg, state, inputs, targets,
                lambda cfg, mesh: pipeline.make_pp_train_step(
                    cfg, opt, mesh, n_micro=2),
                pipeline.place_pp_state)
    if form == "moe":
        return (cfg, state, inputs, targets,
                lambda cfg, mesh: make_moe_train_step(cfg, opt, mesh),
                place_moe_state)
    return (cfg, state, inputs, targets,
            lambda cfg, mesh: make_train_step(cfg, opt, mesh), place_state)


def multihost_cmd(kind: str) -> list:
    return [sys.executable, "-c", MULTIHOST_RANK.format(repo=str(REPO),
                                                        kind=kind)]


def train_multihost_path(torch, smi, mesh_fields):
    """``train-mesh``'s run across two processes: the training preset at
    dp2 (across the processes, gloo over loopback) x tp2 (inside each,
    cuda:0 named twice), B=8 x S=1024, 3 steps. Each rank launches
    24 K1, 24 K2 and 24 K3 a step (48 of each summed, as ``train-mesh``),
    nothing else; both ranks' losses are equal bit for bit, the first
    within MESH_LOSS_TOL of the one-process ``train-mesh`` run's. Returns
    the launches summed over the ranks."""
    outs = [rank_json(out)[0] for out in rank_pair(multihost_cmd("train"))]
    per = TRAIN_PRESET["n_layers"] * 2     # layers x the rank's tp shards
    n = MULTIHOST_STEPS
    for o in outs:
        got = {k: v for k, v in o["launches"].items() if v}
        if got != {k: n * per for k in TRAIN_KERNELS}:
            raise RuntimeError(f"train-multihost rank {o['rank']} "
                               f"launches {got}")
        if o["fallbacks"]:
            raise RuntimeError(f"train-multihost fell back: {o['fallbacks']}")
    if outs[0]["losses_hex"] != outs[1]["losses_hex"]:
        raise RuntimeError(f"train-multihost ranks' losses differ: "
                           f"{outs[0]['losses']} / {outs[1]['losses']}")
    losses = outs[0]["losses"]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train-multihost losses not finite and falling: "
                           f"{losses}")
    rel = abs(losses[0] - mesh_fields["first_loss"]) / \
        abs(mesh_fields["first_loss"])
    if not rel <= MESH_LOSS_TOL:
        raise RuntimeError(f"train-multihost first loss {losses[0]} vs "
                           f"train-mesh's {mesh_fields['first_loss']}: "
                           f"{rel} > {MESH_LOSS_TOL}")
    step_ms = [statistics.median(o["step_ms"][1:]) for o in outs]
    phase("train-multihost", mesh="dp2(processes)xtp2", processes=2,
          transport="gloo", batch=TRAIN_B, seq=TRAIN_S, steps=n,
          first_loss=losses[0], last_loss=losses[-1],
          ranks_bitwise_equal=True,
          train_mesh_first_loss=mesh_fields["first_loss"],
          first_loss_rel_err=rel, loss_tol=MESH_LOSS_TOL,
          step_ms_by_rank=step_ms, train_mesh_step_ms=mesh_fields["step_ms"],
          first_step_ms_by_rank=[o["step_ms"][0] for o in outs],
          gathered_mib_per_step=outs[0]["gathered_mib_per_step"],
          sent_mib_per_step=outs[0]["sent_mib_per_step"],
          gathers_per_step=outs[0]["gathers_per_step"],
          gather_ms_per_step_by_rank=[o["gather_ms_per_step"] for o in outs],
          peak_mem_gib_by_rank=[o["peak_mem_gib"] for o in outs],
          **{f"{k}_per_step_per_rank": per for k in TRAIN_KERNELS},
          card=repr(smi))
    return {k: sum(o["launches"][k] for o in outs)
            for k in outs[0]["launches"]}


def multihost_f32_identity(torch, build):
    """Three 2-layer f32 forms trained 2 steps as two processes on the
    card — dp (across them) x tp2, pp (across them) x tp2 and MoE dp
    (across them) x ep2 — against the one-process run of the same
    global mesh on the card: the ranks' losses bitwise equal, within
    MULTIHOST_LOSS_TOL of the one-process losses, and every parameter
    within MULTIHOST_PARAM_TOL of its leaf's scale; the kernels
    launched on both sides."""
    import tempfile
    from tpushare_torch.workloads.train import gather_state, tree_leaves
    from tpushare_torch.workloads.parallel.mesh import make_mesh
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [rank_json(out) for out in rank_pair(
            multihost_cmd("f32"), {"TPUSHARE_SMOKE_OUT": tmp})]
        for i, (label, mesh_kw, _, form) in enumerate(MULTIHOST_F32_FORMS):
            r0, r1 = outs[0][i], outs[1][i]
            if r0["losses_hex"] != r1["losses_hex"]:
                raise RuntimeError(f"multihost-f32 {label}: ranks differ "
                                   f"{r0['losses']} / {r1['losses']}")
            if not any(r0["launches"].get(k) for k in TRAIN_KERNELS):
                raise RuntimeError(f"multihost-f32 {label}: no kernel "
                                   f"launched {r0['launches']}")
            cfg, state, inputs, targets, step, place = multihost_form(
                torch, form, mesh_kw)
            n = math.prod(mesh_kw.values())
            mesh = make_mesh(devices=[torch.device("cuda", 0)] * n,
                             **mesh_kw)
            placed = place(state, mesh)
            build.reset_launches()
            placed, _, losses = run_steps(torch, step(cfg, mesh), placed,
                                          inputs, targets,
                                          MULTIHOST_F32_STEPS)
            launched = {k: build.LAUNCHES[k] for k in TRAIN_KERNELS}
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(r0["losses"], losses))
            got = torch.load(f"{tmp}/{label}.pt", map_location="cuda")
            want = gather_state(placed)["params"]
            param_err = max(max_err(a, b) / b.abs().max().item()
                            for a, b in zip(tree_leaves(got),
                                            tree_leaves(want)))
            fields.update({f"{label}_loss_rel_err": loss_err,
                           f"{label}_param_rel_err": param_err,
                           f"{label}_gathered_mib_per_step":
                               r0["gathered_mib_per_step"],
                           f"{label}_launches_per_rank": r0["launches"],
                           f"{label}_one_process_launches": launched})
            if not (loss_err <= MULTIHOST_LOSS_TOL
                    and param_err <= MULTIHOST_PARAM_TOL
                    and all(launched.values())):
                raise RuntimeError(f"multihost-f32 {label}: loss {loss_err}, "
                                   f"params {param_err}, launches "
                                   f"{launched}")
            del state, placed, got, want
            torch.cuda.empty_cache()
    phase("multihost-f32-identity", forms=len(MULTIHOST_F32_FORMS),
          processes=2, steps=MULTIHOST_F32_STEPS,
          loss_tol=MULTIHOST_LOSS_TOL, param_tol=MULTIHOST_PARAM_TOL,
          ranks_bitwise_equal=True, **fields)


def train_payload_multihost_path(torch):
    """``python -m tpushare_torch.workloads.train_payload`` as a rank
    pair under the Allocate-shaped group envs, an HBM grant and a
    granted ``TPU_VISIBLE_CHIPS=0`` (which the payload turns into
    ``CUDA_VISIBLE_DEVICES``): dp2 across the ranks x tp2 inside each
    (cuda:0 named twice). Both ranks print ``distributed: rank r/2``,
    their allocator cap and the same final loss."""
    import re
    t0 = time.perf_counter()
    outs = rank_pair(
        [sys.executable, "-m", "tpushare_torch.workloads.train_payload",
         "--steps", "6", "--batch", "8", "--seq", "64", "--dp", "2",
         "--tp", "2", "--mesh-devices", "cuda:0,cuda:0"],
        {"TPUSHARE_HBM_LIMIT_MIB": "16384", "TPU_VISIBLE_CHIPS": "0",
         "CUDA_VISIBLE_DEVICES": None})
    finals = []
    for rank, out in enumerate(outs):
        if f"distributed: rank {rank}/2" not in out or \
                "allocator cap:" not in out or \
                "mesh: {'dp': 2, 'sp': 1, 'tp': 2" not in out:
            raise RuntimeError(f"train-payload-multihost rank {rank}: "
                               f"{out[-2000:]}")
        finals.append(re.findall(r"final loss=([0-9.]+)", out)[-1])
    if finals[0] != finals[1]:
        raise RuntimeError(f"train-payload-multihost final losses differ: "
                           f"{finals}")
    phase("train-payload-multihost", processes=2, mesh="dp2(processes)xtp2",
          steps=6, final_loss=float(finals[0]), ranks_equal=True,
          seconds=time.perf_counter() - t0)


CUDA_BACKEND_CHILD = (
    "import os, sys; sys.path.insert(0, {repo!r}); "
    "from tpushare_torch.tpu.native import NvmlBackend; "
    "b = NvmlBackend(); print('ready', os.getpid(), len(b.devices()), "
    "'torch' in sys.modules, flush=True); sys.stdin.readline(); b.close()")
# a CUDA context holds hundreds of MiB of the card; the enumerating
# child may move the card's used memory by less than this
CONTEXT_FREE_MIB = 64


def smi_compute_pids() -> list[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def cuda_backend_path(torch):
    """The port's device backend (``tpushare_torch.tpu.native``) on the
    card, as the launcher hands it to the daemon: one chip whose MiB are
    NVML's total (the CUDA total beside it), every device node it would
    mount present, as many MiB fake devices as ``hbm_mib``, no health
    event in 2 s, ``close()`` within 2 s; and a child process that
    enumerates holds no CUDA context (its pid is absent from
    ``nvidia-smi --query-compute-apps``, and the card's used memory
    does not grow by a context's worth while it holds NVML open) and
    imports no torch."""
    import os
    import queue
    from tpushare_torch.tpu.device import fake_device_ids
    from tpushare_torch.tpu.native import Nvml, NvmlBackend
    t0 = time.perf_counter()
    backend = NvmlBackend()
    events = backend.subscribe_health()
    try:
        chips = backend.devices()
        nvml = Nvml()
        total = nvml.memory_total(nvml.handle(0))
        if len(chips) != torch.cuda.device_count() or len(chips) != 1:
            raise RuntimeError(f"cuda-backend: {len(chips)} chips")
        chip = chips[0]
        cuda_mib = torch.cuda.get_device_properties(0).total_memory // 2 ** 20
        missing = [p for p in chip.dev_paths if not os.path.exists(p)]
        n_fake = len(fake_device_ids(chip))
        time.sleep(2.0)
        seen = []
        while True:
            try:
                seen.append(events.get_nowait())
            except queue.Empty:
                break
    finally:
        c0 = time.perf_counter()
        backend.close()
        close_s = time.perf_counter() - c0
    if chip.hbm_mib != total // 2 ** 20 or missing or \
            n_fake != chip.hbm_mib or seen or close_s > 2.0:
        raise RuntimeError(f"cuda-backend: hbm_mib {chip.hbm_mib} vs NVML "
                           f"{total // 2 ** 20}, missing {missing}, fake "
                           f"{n_fake}, events {seen}, close {close_s} s")
    torch.cuda.synchronize()
    used_mib = smi_memory_mib()
    child = subprocess.Popen(
        [sys.executable, "-c", CUDA_BACKEND_CHILD.format(repo=str(REPO))],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = child.stdout.readline().split()
        if not line or line[0] != "ready":
            raise RuntimeError(f"cuda-backend child: {line} "
                               f"{child.stdout.read()[-2000:]}")
        pid, n_child, child_torch = int(line[1]), int(line[2]), line[3]
        pids = smi_compute_pids()
        grew_mib = smi_memory_mib() - used_mib
        child.stdin.write("\n")
        child.stdin.flush()
        finish(child, "the enumerating child", 30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    # no CUDA context: absent from nvidia-smi's compute processes, and
    # the card's used memory as it was before the child enumerated
    if pid in pids or n_child != 1 or child_torch != "False" or \
            grew_mib >= CONTEXT_FREE_MIB:
        raise RuntimeError(f"cuda-backend child {pid}: in nvidia-smi's "
                           f"compute apps {pids}, {n_child} chips, torch "
                           f"imported {child_torch}, the card's used "
                           f"memory grew {grew_mib} MiB")
    phase("cuda-backend", chips=len(chips), chip_id=chip.chip_id,
          generation=chip.generation, index=chip.index, minor=chip.minor,
          pci_bdf=chip.pci_bdf, hbm_mib=chip.hbm_mib,
          nvml_total_mib=total // 2 ** 20, cuda_total_mib=cuda_mib,
          dev_paths=list(chip.dev_paths), fake_devices_mib=n_fake,
          health_events_2s=len(seen), close_s=close_s,
          child_pid=pid, child_context=False, child_imports_torch=False,
          child_card_used_grew_mib=grew_mib,
          smi_compute_pids=pids, smi_lists_this_process=os.getpid() in pids,
          seconds=time.perf_counter() - t0)


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
    chunk_rows = chunk_cases(torch)
    bwd_rows = bwd_cases(torch)
    torch.cuda.empty_cache()    # the S=2048 plain twins' score matrices
    splash_rows = splash_cases(torch)
    splash_bwd_rows = splash_bwd_cases(torch)
    paged_rows = paged_cases(torch)
    paged_int8_rows = paged_int8_cases(torch)
    ragged_rows = ragged_cases(torch)
    torch.cuda.empty_cache()    # the long-cache rows' caches and twins
    ragged_int8_rows = ragged_int8_cases(torch)
    torch.cuda.empty_cache()
    mesh_rows = shard_read_cases(torch)
    mesh_train_rows = mesh_kernel_cases(torch, build)
    paths = {}
    paths["forward"], bf16_params, _ = forward_path(torch, build, infer)
    paths["forward-w8"] = forward_w8_path(torch, build, infer, bf16_params)
    del bf16_params
    torch.cuda.empty_cache()
    paths["decode"] = decode_path(torch, build, infer)
    paths["decode-w8"] = decode_w8_path(torch, build, infer)
    paths["forward-longctx"] = forward_longctx_path(torch, build, infer)
    paths["decode-longctx"] = decode_longctx_path(torch, build, infer)
    paths["serve"], serve_fields = serve_path(torch, build, infer)
    paths["serve-int8"] = serve_int8_path(torch, build, infer, serve_fields)
    paths["serve-w8"] = serve_w8_path(torch, build, infer, serve_fields)
    paths["serve-spec"] = serve_spec_path(torch, build, infer, serve_fields)
    paths["serve-mesh"], paths["serve-mesh-int8"] = serve_mesh_path(
        torch, build, infer, serve_fields)
    paths["serve-slot"] = serve_slot_path(torch, build, infer)
    paths["serve-ragged"], ragged_res = serve_ragged_path(torch, build, infer)
    paths["serve-ragged-int8"] = serve_ragged_int8_path(torch, build, infer,
                                                        ragged_res)
    paths["serve-ragged-w8"] = serve_ragged_w8_path(torch, build, infer,
                                                    ragged_res)
    paths["serve-ragged-mesh"], paths["serve-ragged-mesh-int8"] = \
        serve_ragged_mesh_path(torch, build, infer, ragged_res)
    del ragged_res
    paths["serve-ring"] = serve_ring_path(torch, build, infer)
    paths["serve-traffic"], traffic_eng = serve_traffic_path(torch, build,
                                                             infer)
    paths["serve-traffic-ragged"] = serve_traffic_ragged_path(torch, build,
                                                              infer)
    paths["serve-traffic-chat"] = serve_traffic_chat_path(torch, build,
                                                          infer)
    paths["serve-overload"] = serve_overload_path(
        torch, build, traffic_eng.params, traffic_eng.cfg)
    # the fleet phases: nothing they build may outlive them (a router's
    # snapshot provider holds every member pool), so the training
    # phases' peaks read as before
    import gc
    torch.cuda.synchronize()
    fleet_t0, fleet_base = time.perf_counter(), torch.cuda.memory_allocated()
    hosts = fleet_hosts()
    try:
        paths["serve-fleet"], fleet_outs = serve_fleet_path(torch, build,
                                                            infer)
        paths["fleet-ab"] = fleet_ab_path(torch, build, traffic_eng.params,
                                          traffic_eng.cfg)
        paths["serve-fleet-remote"] = serve_fleet_remote_path(
            torch, build, infer, fleet_outs["disagg"], hosts)
    finally:
        for h in hosts:
            h.kill()
    del fleet_outs
    gc.collect()
    torch.cuda.synchronize()
    fleet_left = torch.cuda.memory_allocated() - fleet_base
    # a leaked member pool is 128 MiB or more, leaked weights 2.25 GiB;
    # a kernel workspace cached for a new shape stays under this
    if fleet_left > 64 * 2 ** 20:
        raise RuntimeError(f"the fleet phases left {fleet_left} bytes "
                           "allocated on the card")
    phase("fleet-memory", left_bytes=fleet_left,
          seconds=time.perf_counter() - fleet_t0)
    del traffic_eng
    torch.cuda.empty_cache()
    # the payload as a pod runs it: child processes under their grants
    payload_t0 = time.perf_counter()
    payload_cap_path(torch)
    payload_coresident_path(torch)
    payload_drain_path(torch)
    phase("payload-phases", seconds=time.perf_counter() - payload_t0)
    small_f32_identity(torch, build)
    slot_f32_identity(torch, build)
    int8_f32_identity(torch, build)
    w8_f32_identity(torch, build)
    moe_f32_identity(torch, build)
    prefix_f32_identity(torch, build)
    fleet_f32_identity(torch, build)
    spec_f32_identity(torch, build)
    mesh_f32_identity(torch, build)
    paths["train"], train_fields = train_path(torch, build, smi)
    torch.cuda.empty_cache()
    paths["lora-train"] = lora_train_path(torch, build, smi)
    torch.cuda.empty_cache()
    paths["train-remat"] = train_remat_path(torch, build)
    train_f32_parity(torch, build)
    paths["train-longctx"] = train_longctx_path(torch, build, infer, smi)
    train_longctx_f32_parity(torch, build)
    paths["train-payload"] = train_payload_path(torch, build)
    torch.cuda.empty_cache()
    moe_cfg, moe_params = moe_setup(torch)
    paths["moe-forward"] = moe_forward_path(torch, build, moe_cfg,
                                            moe_params)
    paths["moe-serve"] = moe_serve_path(torch, build, infer, moe_cfg,
                                        moe_params)
    paths["moe-train"] = moe_train_path(torch, build, moe_cfg, moe_params)
    del moe_params
    torch.cuda.empty_cache()
    train_f32_parity(torch, build, moe=True)
    # training over a mesh: B.10 and B.8 per shard, ring, GPipe, ep
    mesh_t0 = time.perf_counter()
    paths["train-mesh"], mesh_plain, mesh_fields = train_mesh_path(
        torch, build, smi, train_fields)
    paths["train-longctx-mesh"] = train_longctx_mesh_path(torch, build,
                                                          infer, smi)
    train_ring_path(torch, build, smi)
    paths["train-pp"] = train_pp_path(torch, build, smi, mesh_plain)
    paths["moe-train-ep"] = moe_train_ep_path(torch, build, smi)
    train_mesh_f32_identity(torch, build)
    train_payload_mesh_path(torch)
    phase("mesh-train-phases", seconds=time.perf_counter() - mesh_t0)
    # training over a pod group (two processes on the card, gloo between
    # them) and the device backend the daemon advertises
    torch.cuda.empty_cache()
    multihost_t0 = time.perf_counter()
    paths["train-multihost"] = train_multihost_path(torch, smi, mesh_fields)
    multihost_f32_identity(torch, build)
    train_payload_multihost_path(torch)
    cuda_backend_path(torch)
    phase("multihost-phases", seconds=time.perf_counter() - multihost_t0)
    # last: a serve-traffic run right after the profiler read lower
    serve_spec_cost(torch, infer)

    def by_path(name):
        return {p: n[name] for p, n in paths.items() if n.get(name)}

    def kernel_line(name, source, replaces, row, checked_in, **fields):
        counts = by_path(name)
        line = {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "checked_in": checked_in,
                "launches": sum(counts.values()),
                "launches_by_path": counts}
        for key in ("max_abs_err", "ms", "bound_ms", "bound_by"):
            line[key] = row[fields.get(key, key)]
        line["plain_ms"] = row["plain_ms"]
        line["library_ms"] = row["library_ms"]
        line["shape"] = {k: row[k] for k in ("B", "S", "Q", "pos", "rows",
                                               "H", "Hkv", "hd", "ps", "P",
                                               "dtype")
                         if k in row}
        return line

    bwd = bwd_rows[0]
    train_fwd = next(r for r in flash_rows if r["case"] == "train-lse")
    splash_lse = next(r for r in splash_rows if r["case"] == "longctx-lse")
    splash_bwd = next(r for r in splash_bwd_rows
                      if r["case"] == "train-longctx")
    kernels = [
        kernel_line("flash_fwd", "tpushare_torch/workloads/kernels/flash_fwd.cu",
                    "tpushare/workloads/ops/attention.py:94", flash_rows[0],
                    "flash-vs-plain, forward-logits, forward-w8, decode, "
                    "f32-identity, w8-f32-identity, moe-f32-identity, "
                    "prefix-f32-identity, fleet-f32-identity, "
                    "spec-f32-identity, "
                    "train-f32-parity, moe-train-f32-parity"),
        kernel_line(CHUNK_KERNEL,
                    "tpushare_torch/workloads/kernels/flash_fwd.cu",
                    "tpushare/workloads/decode.py:166",
                    chunk_rows[0], "chunk-vs-plain"),
        kernel_line("flash_bwd_dq",
                    "tpushare_torch/workloads/kernels/flash_bwd.cu",
                    "tpushare/workloads/ops/attention.py:245", bwd,
                    "flash-bwd-vs-plain, train-f32-parity, "
                    "moe-train-f32-parity",
                    max_abs_err="dq_max_abs_err", ms="dq_ms",
                    bound_ms="dq_bound_ms", bound_by="dq_bound_by"),
        kernel_line("flash_bwd_dkv",
                    "tpushare_torch/workloads/kernels/flash_bwd.cu",
                    "tpushare/workloads/ops/attention.py:300", bwd,
                    "flash-bwd-vs-plain, train-f32-parity, "
                    "moe-train-f32-parity",
                    max_abs_err="dkv_max_abs_err", ms="dkv_ms",
                    bound_ms="dkv_bound_ms", bound_by="dkv_bound_by"),
        kernel_line("paged_decode",
                    "tpushare_torch/workloads/kernels/paged_decode.cu",
                    "tpushare/workloads/ops/registry.py:617", paged_rows[0],
                    "paged-vs-plain, serve, serve-spec, serve-traffic, "
                    "serve-traffic-chat, serve-overload, serve-fleet, "
                    "fleet-ab, f32-identity, w8-f32-identity, "
                    "moe-f32-identity, prefix-f32-identity, "
                    "fleet-f32-identity, serve-fleet-remote, "
                    "spec-f32-identity"),
        kernel_line("ragged_decode",
                    "tpushare_torch/workloads/kernels/ragged_decode.cu",
                    "tpushare/workloads/ops/ragged_decode.py:70",
                    next(r for r in ragged_rows if r["case"] == "long"),
                    "ragged-vs-plain, serve-ragged, serve-traffic-ragged, "
                    "slot-f32-identity, w8-f32-identity, moe-f32-identity"),
        kernel_line("paged_decode_int8",
                    "tpushare_torch/workloads/kernels/paged_decode.cu",
                    "tpushare/workloads/ops/registry.py:617",
                    paged_int8_rows[0],
                    "paged-int8-vs-plain, serve-int8, serve-overload, "
                    "serve-fleet, int8-f32-identity, w8-f32-identity, "
                    "prefix-f32-identity, fleet-f32-identity, "
                    "spec-f32-identity"),
        kernel_line("ragged_decode_int8",
                    "tpushare_torch/workloads/kernels/ragged_decode.cu",
                    "tpushare/workloads/ops/ragged_decode.py:70",
                    next(r for r in ragged_int8_rows if r["case"] == "long"),
                    "ragged-int8-vs-plain, serve-ragged-int8, "
                    "int8-f32-identity"),
        kernel_line("splash_fwd",
                    "tpushare_torch/workloads/kernels/splash_fwd.cu",
                    "tpushare/workloads/ops/registry.py:494",
                    next(r for r in splash_rows if r["case"] == "longctx"),
                    "splash-vs-plain, longctx-logits, "
                    "train-longctx-f32-parity"),
        kernel_line("splash_bwd_dq",
                    "tpushare_torch/workloads/kernels/splash_bwd.cu",
                    "tpushare/workloads/ops/registry.py:494",
                    splash_bwd,
                    "splash-bwd-vs-plain, train-longctx-f32-parity",
                    max_abs_err="dq_max_abs_err", ms="dq_ms",
                    bound_ms="dq_bound_ms", bound_by="dq_bound_by"),
        kernel_line("splash_bwd_dkv",
                    "tpushare_torch/workloads/kernels/splash_bwd.cu",
                    "tpushare/workloads/ops/registry.py:494",
                    splash_bwd,
                    "splash-bwd-vs-plain, train-longctx-f32-parity",
                    max_abs_err="dkv_max_abs_err", ms="dkv_ms",
                    bound_ms="dkv_bound_ms", bound_by="dkv_bound_by"),
    ]
    # B.9 and B.11: the same kernels launched once per tp shard, timed
    # and bounded at the shard's shape, counted on the mesh paths
    mesh_paths = ("serve-mesh", "serve-mesh-int8", "serve-ragged-mesh",
                  "serve-ragged-mesh-int8")
    for name, source, replaces, checked_in in (
            ("paged_decode", "paged_decode.cu",
             "tpushare/workloads/ops/registry.py:698",
             "mesh-vs-plain, serve-mesh, mesh-f32-identity"),
            ("paged_decode_int8", "paged_decode.cu",
             "tpushare/workloads/ops/registry.py:698",
             "mesh-vs-plain, serve-mesh, mesh-f32-identity"),
            ("ragged_decode", "ragged_decode.cu",
             "tpushare/workloads/ops/registry.py:580",
             "mesh-vs-plain, serve-ragged-mesh, mesh-f32-identity"),
            ("ragged_decode_int8", "ragged_decode.cu",
             "tpushare/workloads/ops/registry.py:580",
             "mesh-vs-plain, serve-ragged-mesh, mesh-f32-identity")):
        row = mesh_rows[name]
        counts = {p: paths[p][name] for p in mesh_paths if paths[p][name]}
        kernels.append({
            "name": f"{name}_tp_shard", "route": "cuda",
            "source": f"tpushare_torch/workloads/kernels/{source}",
            "replaces": replaces, "form": row["form"],
            "checked_in": checked_in, "launches": sum(counts.values()),
            "launches_by_path": counts,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "shape": {k: row[k] for k in ("B", "S", "H", "Hkv", "hd", "ps",
                                          "P", "dtype", "tp") if k in row}})
    # B.10 and B.8: the training kernels launched once per (dp, tp)
    # shard, timed and bounded at rank 0's shard, counted on the mesh
    # training paths
    for name, form, source, replaces, mesh_paths_of in (
            ("flash_fwd", "B.10", "flash_fwd.cu",
             "tpushare/workloads/ops/attention.py:634",
             ("train-mesh", "train-pp", "moe-train-ep", "train-multihost")),
            ("flash_bwd_dq", "B.10", "flash_bwd.cu",
             "tpushare/workloads/ops/attention.py:634",
             ("train-mesh", "train-pp", "moe-train-ep", "train-multihost")),
            ("flash_bwd_dkv", "B.10", "flash_bwd.cu",
             "tpushare/workloads/ops/attention.py:634",
             ("train-mesh", "train-pp", "moe-train-ep", "train-multihost")),
            ("splash_fwd", "B.8", "splash_fwd.cu",
             "tpushare/workloads/ops/registry.py:494",
             ("train-longctx-mesh",)),
            ("splash_bwd_dq", "B.8", "splash_bwd.cu",
             "tpushare/workloads/ops/registry.py:494",
             ("train-longctx-mesh",)),
            ("splash_bwd_dkv", "B.8", "splash_bwd.cu",
             "tpushare/workloads/ops/registry.py:494",
             ("train-longctx-mesh",))):
        row = mesh_train_rows[name]
        counts = {p: paths[p][name] for p in mesh_paths_of if paths[p][name]}
        kernels.append({
            "name": f"{name}_{'dp_tp' if form == 'B.10' else 'tp'}_shard",
            "route": "cuda",
            "source": f"tpushare_torch/workloads/kernels/{source}",
            "replaces": replaces, "form": form,
            "checked_in": "mesh-train-vs-plain, train-mesh-f32-identity"
                          + (", multihost-f32-identity" if form == "B.10"
                             else ""),
            "launches": sum(counts.values()), "launches_by_path": counts,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "shape": {k: row[k] for k in ("B", "S", "H", "Hkv", "hd",
                                          "dtype", "dp", "tp")}})
    line_of = {line["name"]: line for line in kernels}
    fields = ("B", "S", "H", "Hkv", "hd", "dtype", "max_abs_err", "ms",
              "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the ragged reads at the serve --ragged shape
    for name, rows in (("ragged_decode", ragged_rows),
                       ("ragged_decode_int8", ragged_int8_rows)):
        line_of[name]["serve_shape"] = {k: rows[0][k] for k in fields}
    # the forward on the training path: the LSE launch at the train shape
    line_of["flash_fwd"]["train_shape"] = {k: train_fwd[k] for k in fields}
    # the cached chunk at the 6144 clip's last chunk
    line_of[CHUNK_KERNEL]["clip_shape"] = {
        k: chunk_rows[1][k] for k in ("Q", "pos", "rows", "H", "Hkv", "hd",
                                      "dtype", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}
    # the splash forward's LSE launch, which the training path runs
    line_of["splash_fwd"]["train_shape"] = {k: splash_lse[k]
                                            for k in fields}
    phase("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
