"""Inference payload of the port — ``python -m
tpushare_torch.workloads.infer``, the counterpart of
``tpushare/workloads/infer.py``.

Sizes a model preset from the pod's HBM budget, then runs one of three
modes on the card and prints the reference payload's throughput lines:

- ``forward`` (default): batch scoring, the flash-forward kernel path;
- ``decode``: KV-cache generation (``decode.generate``);
- ``serve --paged``: the block-paged continuous-batching engine over
  synthetic requests, decode reads through the paged-decode kernel.

The slot engine (``serve`` without ``--paged``) is a later slice and is
rejected. ``--device cpu`` runs the plain-PyTorch path (tests); the
default is the card, and a host without CUDA raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpushare_torch import consts
from tpushare_torch.device import resolve_device

# model presets by HBM budget (MiB) — the reference's table
PRESETS = (
    (2_000, dict(vocab=2048, d_model=256, n_heads=8, n_layers=4, d_ff=1024)),
    (8_000, dict(vocab=8192, d_model=512, n_heads=8, n_layers=8, d_ff=2048)),
    (30_000, dict(vocab=32768, d_model=1024, n_heads=16, n_layers=12,
                  d_ff=4096)),
    (10 ** 9, dict(vocab=32768, d_model=2048, n_heads=16, n_layers=16,
                   d_ff=8192)),
)


def pick_config(hbm_limit_mib: int):
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    for cap, kw in PRESETS:
        if hbm_limit_mib <= cap:
            return TransformerConfig(**kw)
    raise ValueError(f"no preset for {hbm_limit_mib} MiB")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="tpushare-torch-infer-payload")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--mode", choices=("forward", "decode", "serve"),
                   default="forward",
                   help="forward: batch scoring; decode: KV-cache "
                        "generation; serve --paged: continuous-batching "
                        "engine over synthetic request traffic")
    p.add_argument("--requests", type=int, default=16,
                   help="serve: number of synthetic requests")
    p.add_argument("--slots", type=int, default=4,
                   help="serve: the slot-reservation KV budget the paged "
                        "pool is sized to (lanes = 2 x slots)")
    p.add_argument("--paged", action="store_true",
                   help="serve: block-paged KV pool + continuous batching "
                        "(required in this version of the port)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="decode sampling temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=0,
                   help="decode top-k truncation (0 = full vocab)")
    p.add_argument("--seed", type=int, default=0,
                   help="weights / traffic / sampling seed")
    p.add_argument("--hbm-limit-mib", type=int, default=None,
                   help=f"defaults to ${consts.ENV_HBM_LIMIT_MIB}")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Run one payload mode; returns its measurements (and, for serve,
    the engine and requests) for callers that check the outcome."""
    from tpushare_torch.workloads.models.transformer import (forward,
                                                             init_params)
    if args.mode == "serve" and not args.paged:
        raise SystemExit(
            "serve: the slot engine is not ported yet — run "
            "`--mode serve --paged` (the block-paged engine)")
    device = resolve_device(args.device)
    limit = args.hbm_limit_mib
    if limit is None:
        limit = int(os.environ.get(consts.ENV_HBM_LIMIT_MIB, "2000"))
    cfg = pick_config(limit)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg, device)
    print(f"payload starting: device={device} hbm_limit={limit}MiB "
          f"d_model={cfg.d_model} layers={cfg.n_layers}", flush=True)

    if args.mode == "serve":
        return _serve(args, cfg, params, device)
    if args.mode == "decode":
        from tpushare_torch.workloads.decode import generate
        prompt = torch.randint(0, cfg.vocab,
                               (args.batch, max(8, args.seq // 4)),
                               generator=gen, device=device)
        kw = {}
        if args.temperature > 0:
            kw = dict(temperature=args.temperature, top_k=args.top_k,
                      generator=gen)
        generate(params, prompt, cfg, args.steps, **kw)       # warm-up
        _sync(device)
        t0 = time.perf_counter()
        generate(params, prompt, cfg, args.steps, **kw)
        _sync(device)
        dt = time.perf_counter() - t0
        toks = args.batch * args.steps / dt
        print(f"decode throughput: {toks:,.0f} tokens/s "
              f"({args.steps} new tokens, d_model={cfg.d_model})", flush=True)
        return {"mode": "decode", "tokens_per_s": toks}
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=gen, device=device)
    forward(params, tokens, cfg)                               # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = forward(params, tokens, cfg)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.seq * args.steps / dt
    print(f"throughput: {toks:,.0f} tokens/s "
          f"({args.steps} steps, d_model={cfg.d_model})", flush=True)
    return {"mode": "forward", "tokens_per_s": toks, "logits": out,
            "params": params, "cfg": cfg}


def _serve(args, cfg, params, device) -> dict:
    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  Request, lane_efficiency)
    rng = np.random.default_rng(args.seed)
    plen = max(8, args.seq // 4)
    max_seq = -(-(plen + args.steps) // 128) * 128
    # equal-HBM sizing against the slot engine's reservation, as in the
    # reference: the slots' KV budget buys the pool's pages
    page_size = 32
    budget_mib = paging.pool_hbm_mib(
        paging.pages_for_rows(args.slots * max_seq, page_size),
        page_size, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
    n_pages = paging.pages_for_hbm(budget_mib, page_size, cfg.n_layers,
                                   cfg.kv_heads, cfg.head_dim)
    n_lanes = max(2, args.slots * 2)
    eng = PagedServingEngine(params, cfg, n_lanes=n_lanes, max_seq=max_seq,
                             n_pages=n_pages, page_size=page_size,
                             prompt_buckets=(-(-plen // 32) * 32,), chunk=16,
                             seed=args.seed, top_k=args.top_k)
    bpt = paging.kv_bytes_per_token(cfg.n_layers, cfg.kv_heads, cfg.head_dim)
    print(f"paged KV pool: {n_pages} pages x {page_size} rows (codec bf16, "
          f"{bpt:.0f} B/token, {n_lanes} lanes, read {eng.attn_impl})",
          flush=True)
    reqs = [Request(
        prompt=[int(t) for t in rng.integers(0, cfg.vocab, plen)],
        max_new=int(rng.integers(max(1, args.steps // 4), args.steps + 1)),
        temperature=args.temperature) for _ in range(args.requests)]
    warm = Request(prompt=reqs[0].prompt,
                   max_new=max(1, min(17, max_seq - plen)))
    eng.submit(warm)
    eng.run()
    warm_steps = eng.stats["lane_steps"] // n_lanes
    eng.reset_stats()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    eff = lane_efficiency(eng.stats)
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs
                  if r.first_token_at is not None)
    print(f"serve throughput: {total / dt:,.0f} tokens/s "
          f"({args.requests} requests, {total} tokens, lane efficiency "
          f"{f'{eff:.0%}' if eff is not None else 'n/a'}, "
          f"d_model={cfg.d_model})", flush=True)
    if ttft:
        print(f"time to first token: p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, "
              f"max {ttft[-1] * 1e3:.1f} ms", flush=True)
    s = eng.stats
    if s["shed"] or s["oom_quarantined"]:
        print(f"overload accounting: completed={s['completed']} "
              f"shed={s['shed']} oom_quarantined={s['oom_quarantined']}",
              flush=True)
    # decode steps of the wave, each one read of the pool per layer
    return {"mode": "serve", "tokens_per_s": total / dt, "seconds": dt,
            "tokens": total, "ttft_s": ttft, "engine": eng,
            "requests": reqs, "warmup_decode_steps": warm_steps,
            "decode_steps": s["lane_steps"] // n_lanes}


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
