#!/usr/bin/env python3
"""Where the PyTorch port's main paths spend their time on one GPU.

    python scripts/torch_profile.py

At the flagship preset (1.2B, bf16, random weights from a seed) this
profiles, with ``torch.profiler`` (CPU + CUDA activities):

- ``forward``: three batch-8 x seq-128 forwards; ``forward-w8`` the
  same through ``quant.qmm`` over the int8 weights
  (``quant.quantize_params``, ``infer --int8``);
- ``forward-longctx``: two batch-2 x seq-4096 forwards (the splash
  forward, ``infer --mode forward --batch 2 --seq 4096``);
- ``decode``: the paged serving engine's decode chunks with 8 lanes busy;
  ``decode-int8`` the same over an int8 pool (``kv_codec="int8"``),
  ``decode-w8`` over int8 weights (``mm=quant.qmm``, bf16 pool);
- ``serve-ragged``: the slot engine's decode chunks with ``ragged_decode``
  (``infer --mode serve --ragged``), 4 slots busy; ``serve-ragged-int8``
  the same over int8 slot caches (``cfg.kv_int8``);

and at the reference's training preset (0.55B: d_model 1536, 16 heads of
96, 12 layers, bf16; batch 8 x seq 1024):

- ``train``: one ``train.make_train_step`` step after a warm-up step;

and at the flagship's widths, batch 2 x seq 4096:

- ``train-longctx``: one step after a warm-up step (the splash forward,
  dQ and dK/dV kernels).

For each it prints one JSON line: host wall time per step, device busy
time per step (the sum of the device-side kernel and copy times), the
device idle share over the window (1 - busy / wall), device launches per
step (all kernels and copies; the decode, long-context and training
paths also their kernels' own counts), and the top kernels by device
time. Needs a CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def profile(torch, fn, n_steps_of, label, **extra):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = n_steps_of(state)
    extra = {k: f(steps) for k, f in extra.items()}
    # device-side events only: a CPU op's row also carries the device time
    # of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({
        "path": label, "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
        "launches_per_step": launches / steps, **extra,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top],
    }), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import dataclasses

    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.infer import pick_config
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.models.transformer import (forward,
                                                             init_params)
    from tpushare_torch.workloads.quant import qmm, quantize_params
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  Request, ServingEngine)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = pick_config(80_000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, "cuda")
    rng = torch.Generator().manual_seed(1)

    tokens = torch.randint(0, cfg.vocab, (8, 128), generator=gen,
                           device="cuda")
    forward(params, tokens, cfg)

    def forwards():
        for _ in range(3):
            forward(params, tokens, cfg)
        return 3
    profile(torch, forwards, lambda n: n, "forward")

    qparams = quantize_params(params)
    forward(qparams, tokens, cfg, mm=qmm)

    def forwards_w8():
        for _ in range(3):
            forward(qparams, tokens, cfg, mm=qmm)
        return 3
    profile(torch, forwards_w8, lambda n: n, "forward-w8")

    def per_step(*kernels):
        """Launch counts per step of ``kernels``, zeroed before the run."""
        build.reset_launches()
        return {f"{k}_launches_per_step":
                (lambda steps, k=k: build.LAUNCHES[k] / steps)
                for k in kernels}

    long_tokens = torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                                device="cuda")
    forward(params, long_tokens, cfg)

    def long_forwards():
        for _ in range(2):
            forward(params, long_tokens, cfg)
        return 2
    profile(torch, long_forwards, lambda n: n, "forward-longctx",
            **per_step("splash_fwd", "flash_fwd"))
    del long_tokens

    def decode_chunks(eng, lanes, label, kernel):
        """Fill every lane (prompt 128, 120 new tokens), warm with the
        admission wave and first chunk, then profile two more chunks."""
        for _ in range(lanes):
            eng.submit(Request(prompt=torch.randint(0, cfg.vocab, (128,),
                                                    generator=rng).tolist(),
                               max_new=120))
        eng.step()
        before = eng.stats["lane_steps"]
        build.reset_launches()

        def chunks():
            for _ in range(2):
                eng.step()
            return eng.stats["lane_steps"]
        profile(torch, chunks, lambda after: (after - before) // lanes,
                label, **{f"{kernel}_launches_per_step":
                          lambda steps: build.LAUNCHES[kernel] / steps})
        torch.cuda.empty_cache()

    # the paged decode: 8 lanes, each with room for prompt 128 + 128 new
    ps, max_seq, lanes = 32, 256, 8
    for codec, w8, label in (("bf16", False, "decode"),
                             ("int8", False, "decode-int8"),
                             ("bf16", True, "decode-w8")):
        decode_chunks(PagedServingEngine(
            qparams if w8 else params, cfg, n_lanes=lanes, max_seq=max_seq,
            n_pages=lanes * paging.pages_for_rows(max_seq, ps) + 1,
            page_size=ps, prompt_buckets=(128,), chunk=16,
            kv_codec=codec, mm=qmm if w8 else None), lanes, label,
            "paged_decode_int8" if codec == "int8" else "paged_decode")
    del qparams

    # serve --ragged: 4 slots, prompt 128 + up to 120 new tokens
    for int8, label in ((False, "serve-ragged"),
                        (True, "serve-ragged-int8")):
        decode_chunks(ServingEngine(
            params, dataclasses.replace(cfg, ragged_decode=True,
                                        kv_int8=int8),
            n_slots=4, max_seq=256, prompt_buckets=(128,), chunk=16),
            4, label, "ragged_decode_int8" if int8 else "ragged_decode")
    del params
    torch.cuda.empty_cache()

    from tpushare_torch.workloads.models.transformer import TransformerConfig
    from tpushare_torch.workloads.train import (init_state, make_optimizer,
                                                make_train_step)
    tcfg = TransformerConfig(vocab=32768, d_model=1536, n_heads=16,
                             n_layers=12, d_ff=6144, max_seq=1024)
    gen = torch.Generator(device="cuda").manual_seed(3)
    opt = make_optimizer()
    state = init_state(init_params(gen, tcfg, "cuda"), opt)
    inputs = torch.randint(0, tcfg.vocab, (8, 1024), generator=gen,
                           device="cuda")
    targets = torch.roll(inputs, -1, dims=1)
    step = make_train_step(tcfg, opt, "cuda")
    state, _ = step(state, inputs, targets)         # warm-up

    def train_step():
        step(state, inputs, targets)
        return 1
    profile(torch, train_step, lambda n: n, "train",
            **per_step("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del state, step
    torch.cuda.empty_cache()

    lcfg = dataclasses.replace(cfg, max_seq=4096)
    state = init_state(init_params(gen, lcfg, "cuda"), opt)
    inputs = torch.randint(0, lcfg.vocab, (2, 4096), generator=gen,
                           device="cuda")
    targets = torch.roll(inputs, -1, dims=1)
    step = make_train_step(lcfg, opt, "cuda")
    state, _ = step(state, inputs, targets)         # warm-up
    profile(torch, train_step, lambda n: n, "train-longctx",
            **per_step("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv",
                       "flash_fwd"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
