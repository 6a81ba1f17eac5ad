#!/usr/bin/env python3
"""Where the PyTorch port's main paths spend their time on one GPU.

    python scripts/torch_profile.py

At the flagship preset (1.2B, bf16, random weights from a seed) this
profiles, with ``torch.profiler`` (CPU + CUDA activities):

- ``forward``: three batch-8 x seq-128 forwards;
- ``decode``: the paged serving engine's decode chunks with 8 lanes busy;

and at the reference's training preset (0.55B: d_model 1536, 16 heads of
96, 12 layers, bf16; batch 8 x seq 1024):

- ``train``: one ``train.make_train_step`` step after a warm-up step.

For each it prints one JSON line: host wall time per step, device busy
time per step (the sum of the device-side kernel and copy times), the
device idle share over the window (1 - busy / wall), device launches per
step, and the top kernels by device time. Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def profile(torch, fn, n_steps_of, label):
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
        "launches_per_step": launches / steps,
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
    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.infer import pick_config
    from tpushare_torch.workloads.models.transformer import (forward,
                                                             init_params)
    from tpushare_torch.workloads.serving import PagedServingEngine, Request

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = pick_config(80_000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, "cuda")

    tokens = torch.randint(0, cfg.vocab, (8, 128), generator=gen,
                           device="cuda")
    forward(params, tokens, cfg)

    def forwards():
        for _ in range(3):
            forward(params, tokens, cfg)
        return 3
    profile(torch, forwards, lambda n: n, "forward")

    # decode: 8 lanes, each with room for prompt 128 + 128 new tokens
    ps, max_seq, lanes = 32, 256, 8
    n_pages = lanes * paging.pages_for_rows(max_seq, ps) + 1
    eng = PagedServingEngine(params, cfg, n_lanes=lanes, max_seq=max_seq,
                             n_pages=n_pages, page_size=ps,
                             prompt_buckets=(128,), chunk=16)
    rng = torch.Generator().manual_seed(1)
    for _ in range(lanes):
        eng.submit(Request(prompt=torch.randint(0, cfg.vocab, (128,),
                                                generator=rng).tolist(),
                           max_new=120))
    eng.step()                        # admission wave + first chunk (warm)
    before = eng.stats["lane_steps"]

    def chunks():
        for _ in range(2):
            eng.step()
        return eng.stats["lane_steps"]
    profile(torch, chunks,
            lambda after: (after - before) // lanes, "decode")
    del eng, params
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
    profile(torch, train_step, lambda n: n, "train")
    return 0


if __name__ == "__main__":
    sys.exit(main())
