"""Inference payload of the port — ``python -m
tpushare_torch.workloads.infer``, the counterpart of
``tpushare/workloads/infer.py``.

Sizes a model preset from the pod's HBM budget, then runs one of three
modes on the card and prints the reference payload's throughput lines:

- ``forward`` (default): batch scoring, the flash-forward kernel path;
- ``decode``: KV-cache generation (``decode.generate``);
- ``serve``: the slot continuous-batching engine (``ServingEngine``)
  over synthetic requests — ``--ragged`` reads the slot caches through
  the ragged-decode kernel, ``--window W --ring-rows R`` serves a
  sliding-window model from a ring cache of R rows per slot;
- ``serve --paged``: the block-paged engine, decode reads through the
  paged-decode kernel; ``--kv-codec int8`` (implies ``--paged``) stores
  the pool as the int8 codec, sized to the same HBM, and reads it
  through the kernel's int8 rung;
- ``serve --draft-k K``: speculative decoding on either engine (the slot
  engine at single occupancy, the paged engine batched over its lanes),
  with a random-init draft of ``--draft-dmodel`` x ``--draft-layers``
  from its own generator seeded by ``--seed`` (``--draft-dmodel 0``: the
  target drafts for itself).

``--int8`` stores the weights as the int8 mirror
(``quant.quantize_params``: about half the weight bytes) in every mode
— ``forward`` and each engine run them through ``mm=quant.qmm``,
``decode`` runs ``quant.qgenerate`` — and ``--ragged``'s re-headed
preset is quantized the same way. It composes with ``--kv-codec int8``;
with ``--draft-k`` the engine refuses (``ERR_SPEC_MM``), as in the
reference.

``serve`` runs the AIMD admission controller by default
(``overload.AdmissionController.from_env``: the pod's HBM cap, the node
daemon's chip pressure when the env wires it), sized by the engine's
lanes — the paged engine's 2 x ``--slots``, where the reference sizes
its non-fleet paged controller by ``--slots`` — with the weights as its
base charge; ``--no-admission`` turns it off. ``--queue-limit`` bounds
the submit queue and ``--deadline-s`` stamps every request's deadline;
SIGTERM drains the engine (stop admitting, finish in flight, shed the
queue with exact accounting). The serve result carries the engine's
telemetry snapshot.

``--device cpu`` runs the plain-PyTorch path (tests); the default is the
card, and a host without CUDA raises. Invalid flag combinations print a
message and exit 2, as the reference payload does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys
import threading
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
                   help="serve: engine slot count (--paged: the "
                        "slot-reservation KV budget the pool is sized to, "
                        "lanes = 2 x slots)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weights in any mode (about half the weight "
                        "bytes; pairs with a halved aliyun.com/tpu-hbm "
                        "ask)")
    p.add_argument("--window", type=int, default=None,
                   help="serve: sliding attention window (tokens)")
    p.add_argument("--ring-rows", type=int, default=None,
                   help="serve: ring-buffer KV rows per slot (requires "
                        "--window; caps slot memory at O(rows) while "
                        "generations run to the logical max_seq)")
    p.add_argument("--ragged", action="store_true",
                   help="serve: ragged decode attention - the slot "
                        "step's cache read scales with each slot's live "
                        "length, not max_seq (needs head_dim 128 and "
                        "max_seq %% 256 == 0; excludes --window)")
    p.add_argument("--paged", action="store_true",
                   help="serve: block-paged KV pool + continuous "
                        "batching (PagedServingEngine) instead of the "
                        "slot engine; pool sized to the slot engine's "
                        "KV HBM (excludes --window/--ring-rows/--ragged)")
    p.add_argument("--kv-codec", choices=("bf16", "int8"), default="bf16",
                   help="serve --paged: page-pool storage codec; int8 "
                        "halves bytes/page so the same pool HBM holds "
                        "~2x pages -> deeper admitted concurrency "
                        "(implies --paged)")
    p.add_argument("--draft-k", type=int, default=None,
                   help="serve: arm speculative decoding with this many "
                        "draft tokens per round (>= 2), on either engine: "
                        "the slot engine at single occupancy, the paged "
                        "engine batched over its lanes. Greedy spec is "
                        "exact for any draft; the draft sets the speed")
    p.add_argument("--draft-dmodel", type=int, default=None,
                   help="serve --draft-k: d_model of the random-init "
                        "draft model (default a quarter of the target's); "
                        "0 = self-draft (the target drafts for itself)")
    p.add_argument("--draft-layers", type=int, default=1,
                   help="serve --draft-k: draft model depth")
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
    p.add_argument("--queue-limit", type=int, default=None,
                   help="serve: bound the submit queue (overflow is shed "
                        "with exact accounting)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="serve: per-request wall deadline; expired "
                        "requests shed pre-admission or retire mid-decode")
    p.add_argument("--no-admission", action="store_true",
                   help="serve: disable the AIMD admission controller "
                        "(HBM-cap gate + chip-pressure watermark)")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cli_error(msg: str):
    """The reference payload's flag errors: a message and exit code 2."""
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(2)


def serve_config(args: argparse.Namespace, cfg, limit: int):
    """The serve mode's config and logical max_seq from the flags, with
    the reference payload's rules: ``--window`` sets the model's window;
    ``--ragged`` rounds max_seq up to 256 and re-heads the preset to
    d_model // 128 heads of 128 (same parameter shapes) when its head_dim
    is not 128; ``--paged`` excludes the slot engine's flags."""
    import dataclasses
    plen = max(8, args.seq // 4)
    max_seq = -(-(plen + args.steps) // 128) * 128
    if args.kv_codec != "bf16":
        args.paged = True     # the codec is a page-pool property
    if args.window is not None:
        cfg = dataclasses.replace(cfg, attn_window=args.window)
    if args.ragged:
        max_seq = -(-max_seq // 256) * 256
        if cfg.head_dim != 128:
            if cfg.d_model % 128:
                _cli_error(
                    f"--ragged needs head_dim 128, and the {limit}MiB "
                    f"preset's d_model={cfg.d_model} is not a multiple of "
                    "128 so it cannot be re-headed; pick a preset with "
                    "d_model % 128 == 0 or drop --ragged")
            heads = max(1, cfg.d_model // 128)
            print(f"--ragged: re-headed preset to {heads} heads of 128 "
                  "(kernel lane width)", flush=True)
            cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=None)
        cfg = dataclasses.replace(cfg, ragged_decode=True)
    if args.paged and (args.window is not None or args.ragged
                       or args.ring_rows):
        _cli_error("--paged excludes --window/--ring-rows/--ragged (the "
                   "pool serves full-causal models; windowed models ride "
                   "the ring cache)")
    return cfg, plen, max_seq


def _setup(args: argparse.Namespace):
    """Device, HBM limit, config and seeded weights from the flags (plus
    the serve mode's prompt length and max_seq, and the weight path:
    ``quant.qmm`` over the int8 mirror under ``--int8``, else None)."""
    from tpushare_torch.workloads.models.transformer import init_params
    device = resolve_device(args.device)
    limit = args.hbm_limit_mib
    if limit is None:
        limit = int(os.environ.get(consts.ENV_HBM_LIMIT_MIB, "2000"))
    cfg = pick_config(limit)
    plen = max_seq = None
    if args.mode == "serve":
        cfg, plen, max_seq = serve_config(args, cfg, limit)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg, device)
    mm = None
    if args.int8:
        from tpushare_torch.workloads.quant import qmm, quantize_params
        params, mm = quantize_params(params), qmm
        print("int8 weights: ~half the weight HBM", flush=True)
    print(f"payload starting: device={device} hbm_limit={limit}MiB "
          f"d_model={cfg.d_model} layers={cfg.n_layers}", flush=True)
    return device, limit, cfg, params, gen, plen, max_seq, mm


def run(args: argparse.Namespace) -> dict:
    """Run one payload mode; returns its measurements (and, for serve,
    the engine, the requests and its telemetry snapshot) for callers
    that check the outcome."""
    from tpushare_torch.workloads.models.transformer import forward
    if args.mode == "serve":
        setup = serve_engine(args)
        eng = setup["engine"]
        with _drain_on_sigterm(eng):
            return serve_traffic(eng, args, setup["cfg"], setup["device"],
                                 setup["plen"], setup["max_seq"],
                                 setup["n_lanes"])
    device, limit, cfg, params, gen, _, _, mm = _setup(args)
    if args.mode == "decode":
        if args.int8:
            from tpushare_torch.workloads.quant import qgenerate as generate
        else:
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
    forward(params, tokens, cfg, mm=mm)                        # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = forward(params, tokens, cfg, mm=mm)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.seq * args.steps / dt
    print(f"throughput: {toks:,.0f} tokens/s "
          f"({args.steps} steps, d_model={cfg.d_model})", flush=True)
    return {"mode": "forward", "tokens_per_s": toks, "logits": out,
            "params": params, "cfg": cfg, "mm": mm}


def admission_for(args: argparse.Namespace, params: dict, n_lanes: int,
                  limit: int):
    """The serve mode's admission controller (None under
    ``--no-admission``): from the env contract, sized by the engine's
    lanes, capped at the resolved HBM limit outside the contract, with
    the weights' bytes as the base the pod already pays."""
    from tpushare_torch.workloads.overload import AdmissionController
    if args.no_admission:
        return None
    adm = AdmissionController.from_env(n_lanes)
    if adm.cap_mib is None:
        adm.cap_mib = float(limit)
    adm.base_mib = sum(_tensor_bytes(params)) / (1024 * 1024)
    return adm


def _tensor_bytes(tree):
    if isinstance(tree, torch.Tensor):
        yield tree.numel() * tree.element_size()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_bytes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_bytes(v)


@contextlib.contextmanager
def _drain_on_sigterm(engine):
    """SIGTERM -> ``engine.request_drain()`` while serving (a pod
    eviction stops admitting, finishes in flight and sheds the queue
    with exact accounting); the previous handler is restored after and
    the watcher ends, so it no longer holds the engine. Signal handlers
    live on the main thread only: elsewhere this is a no-op."""
    from tpushare_torch.workloads import overload
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGTERM)
    sigq = overload.install_signal_queue(signals=(signal.SIGTERM,))
    watcher = overload.watch_signal_queue(engine, sigq,
                                          signals=(signal.SIGTERM,))
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)
        sigq.put(None)
        watcher.join()


def draft_for(args: argparse.Namespace, cfg, params: dict, device):
    """The ``--draft-k`` draft, with the reference payload's rules:
    ``--draft-dmodel 0`` is the target itself; otherwise a random-init
    model of that d_model (default a quarter of the target's, at least
    64, rounded to heads of 64) and ``--draft-layers`` layers, its
    weights from its own generator seeded by ``--seed``. None without
    ``--draft-k``."""
    if args.draft_k is None:
        return None
    from tpushare_torch.workloads.models.transformer import (
        TransformerConfig, init_params)
    if args.draft_dmodel == 0:
        dcfg, dparams = cfg, params
    else:
        dm = args.draft_dmodel or max(64, cfg.d_model // 4)
        heads = max(1, dm // 64)
        dm = heads * 64
        dcfg = TransformerConfig(vocab=cfg.vocab, d_model=dm, n_heads=heads,
                                 n_layers=args.draft_layers, d_ff=4 * dm,
                                 max_seq=cfg.max_seq, dtype=cfg.dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        dparams = init_params(gen, dcfg, device)
    print(f"speculative serving: draft k={args.draft_k}, "
          f"d_model={dcfg.d_model} x {dcfg.n_layers} layer(s)"
          + (" (self-draft)" if args.draft_dmodel == 0 else ""), flush=True)
    return dparams, dcfg, args.draft_k


def serve_engine(args: argparse.Namespace) -> dict:
    """Build the serve mode's engine from the flags: the slot engine, or
    the paged one (``--paged`` / ``--kv-codec int8``) with its pool sized
    to the slot engine's KV HBM, admission on unless ``--no-admission``.
    Returns the engine with its config, device, prompt length, max_seq
    and lane count."""
    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  ServingEngine)
    device, limit, cfg, params, _, plen, max_seq, mm = _setup(args)
    bucket = -(-plen // 32) * 32
    overload_kw = dict(mm=mm, queue_limit=args.queue_limit,
                       default_deadline_s=args.deadline_s,
                       draft=draft_for(args, cfg, params, device))
    if args.paged:
        # equal-HBM sizing against the slot engine's reservation, as in
        # the reference: the slots' KV budget buys the pool's pages under
        # the chosen codec — int8 gets about twice the pages
        page_size = 32
        budget_mib = paging.pool_hbm_mib(
            paging.pages_for_rows(args.slots * max_seq, page_size),
            page_size, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
        n_pages = paging.pages_for_hbm(budget_mib, page_size, cfg.n_layers,
                                       cfg.kv_heads, cfg.head_dim,
                                       codec=args.kv_codec)
        n_lanes = max(2, args.slots * 2)
        eng = PagedServingEngine(params, cfg, n_lanes=n_lanes,
                                 max_seq=max_seq, n_pages=n_pages,
                                 page_size=page_size, prompt_buckets=(bucket,),
                                 chunk=16, seed=args.seed, top_k=args.top_k,
                                 kv_codec=args.kv_codec,
                                 admission=admission_for(args, params,
                                                         n_lanes, limit),
                                 **overload_kw)
        bpt = paging.kv_bytes_per_token(cfg.n_layers, cfg.kv_heads,
                                        cfg.head_dim, args.kv_codec)
        print(f"paged KV pool: {n_pages} pages x {page_size} rows (codec "
              f"{args.kv_codec}, {bpt:.0f} B/token, {n_lanes} lanes, read "
              f"{eng.attn_impl})", flush=True)
    else:
        n_lanes = args.slots
        eng = ServingEngine(params, cfg, n_slots=n_lanes, max_seq=max_seq,
                            prompt_buckets=(bucket,), chunk=16,
                            seed=args.seed, top_k=args.top_k,
                            ring_rows=args.ring_rows,
                            admission=admission_for(args, params, n_lanes,
                                                    limit),
                            **overload_kw)
        print(f"slot engine: {n_lanes} slots x {eng.cache_rows} rows "
              f"(read {eng.attn_impl})", flush=True)
        if args.ring_rows:
            print(f"ring KV cache: {eng.cache_rows} rows/slot "
                  f"(window {args.window}, logical max_seq {max_seq})",
                  flush=True)
    if eng.admission is not None:
        print(f"admission: watermark {eng.admission.watermark()} of "
              f"{n_lanes} lanes, cap {eng.admission.cap_mib:.0f} MiB "
              f"(weights {eng.admission.base_mib:.0f} MiB)", flush=True)
    return {"engine": eng, "cfg": cfg, "device": device, "plen": plen,
            "max_seq": max_seq, "n_lanes": n_lanes}


def serve_traffic(eng, args, cfg, device, plen: int, max_seq: int,
                  n_lanes: int) -> dict:
    """Drive a serving engine with the payload's synthetic traffic from
    ``args`` (``--requests`` prompts of ``plen`` tokens, up to
    ``--steps`` new tokens each, from ``--seed``) after one warm-up
    request, print the throughput lines and return the measurements, the
    engine, the requests and the engine's telemetry snapshot."""
    from tpushare_torch.workloads.serving import Request, lane_efficiency
    rng = np.random.default_rng(args.seed)
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
    if args.draft_k is not None:
        print(f"spec: rounds={s['spec_rounds']} "
              f"accept={s['spec_accepted'] / max(1, s['spec_drafted']):.2f} "
              f"emitted={s['spec_emitted']} "
              f"skipped={s['spec_rounds_skipped']}", flush=True)
    if eng.draining or s["shed"] or s["deadline_exceeded"] \
            or s["oom_quarantined"]:
        print(f"overload accounting: completed={s['completed']} "
              f"shed={s['shed']} deadline_exceeded={s['deadline_exceeded']} "
              f"oom_quarantined={s['oom_quarantined']} "
              f"oom_recoveries={s['oom_recoveries']}", flush=True)
    # decode steps of the wave: each reads the cache once per layer
    return {"mode": "serve", "tokens_per_s": total / dt, "seconds": dt,
            "tokens": total, "ttft_s": ttft, "engine": eng,
            "requests": reqs, "warmup_decode_steps": warm_steps,
            "decode_steps": s["lane_steps"] // n_lanes,
            "telemetry": eng.telemetry.snapshot()}


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
