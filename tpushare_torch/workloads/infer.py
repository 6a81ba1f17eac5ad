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

Fleet serving (``workloads/fleet.py``): ``--fleet N`` (implies
``--paged``) fronts N co-resident paged engines with the ``FleetRouter``
— the slot-reservation KV budget splits across the member pools, each
member gets ``max(2, 2 x slots // N)`` lanes and its own admission
controller —; ``--disaggregate`` makes engine 0 an admission-only
prefill member whose pages are handed into the decode members' pools
(the draft arms only the decode side). ``--listen HOST:PORT`` hosts one
paged engine behind the fleet's RPC transport (``remote.EngineHost``),
prints ``fleet host: paged engine at HOST:PORT`` (port 0 binds a free
one) and serves until killed; ``--join ADDR[,ADDR...]`` composes such
hosts as remote members beside the local engine(s). The router takes
SIGTERM's drain, and the run reports ``router.fleet_stats()``.

Sharded serving: ``--tp T --pp P`` (implies ``--paged``) serves one
paged engine over a tp×pp serving mesh of the host's CUDA devices
(``parallel/mesh.make_serving_mesh``): KV heads over tp, layers over pp
(``workloads/sharded_pool.py``); not with ``--fleet`` or ``--int8``, as
in the reference, and a model that does not tile the mesh exits 2 with
the ``ERR_SERVING_MESH_*`` message.

The pod's side of the device plugin's contract, as the reference
payload's: a ``TPU_VISIBLE_CHIPS`` poisoned by a failed Allocate exits
3; a granted one becomes ``CUDA_VISIBLE_DEVICES`` (in PCI bus order,
``device.apply_visible_chips``) unless the caller set that; the
allocator cap (``device.apply_hbm_cap``: Allocate's
``XLA_PYTHON_CLIENT_MEM_FRACTION``, else the fraction of the card the
HBM limit buys) is set on every card the run allocates on — each card
of a ``--tp``/``--pp`` mesh — before the first allocation, unless
``TPUSHARE_DISABLE_ISOLATION=true``; the usage reporter
(``usage_report.start_reporter``) posts the allocator's figures and the
serving telemetry to the node daemon when the env wires it, its drain
directive drains the serve front (engine or router) and a withdrawn one
resumes it; a serve run posts one last report at exit.

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
from tpushare_torch.device import (apply_hbm_cap, apply_visible_chips,
                                   resolve_device)
from tpushare_torch.workloads import usage_report

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
    p.add_argument("--fleet", type=int, default=None,
                   help="serve: front this many co-resident paged "
                        "engines with the prefix-affinity FleetRouter "
                        "(implies --paged; the slot-reservation KV "
                        "budget splits across the member pools)")
    p.add_argument("--disaggregate", action="store_true",
                   help="serve --fleet/--join: engine 0 admits and "
                        "prefills only and hands each admission's pages "
                        "into a decode engine's pool")
    p.add_argument("--listen", metavar="HOST:PORT", default=None,
                   help="serve: host one paged engine behind the fleet "
                        "RPC transport at this address (port 0: any "
                        "free port) and serve until killed — the far "
                        "side of --join (implies --paged, excludes "
                        "--fleet/--join)")
    p.add_argument("--join", metavar="ADDR[,ADDR...]", default=None,
                   help="serve: dial these --listen hosts and compose "
                        "them as remote fleet members beside the local "
                        "engine(s) (implies --paged)")
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
    p.add_argument("--tp", type=int, default=1,
                   help="serve: tensor-parallel degree of ONE sharded "
                        "paged engine (KV heads over tp; implies "
                        "--paged)")
    p.add_argument("--pp", type=int, default=1,
                   help="serve: pipeline-parallel degree (layer stages "
                        "over pp; implies --paged)")
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


def _host_port(text: str, flag: str) -> tuple[str, int]:
    host, _, port = text.strip().rpartition(":")
    if not port.isdigit() or (flag == "--join" and not host):
        _cli_error(f"{flag}: {text.strip()!r} is not HOST:PORT")
    return host or "127.0.0.1", int(port)


def fleet_flags(args: argparse.Namespace) -> list[tuple[str, int]]:
    """The reference payload's fleet guards (each a message and exit
    2); sets ``--paged`` where a fleet flag implies it and returns the
    ``--join`` addresses."""
    if args.listen is not None and (args.fleet is not None
                                    or args.join is not None):
        _cli_error("--listen hosts ONE engine for a remote router; it "
                   "excludes --fleet/--join (run the router process with "
                   "--join instead)")
    remote = []
    if args.join is not None:
        remote = [_host_port(part, "--join")
                  for part in args.join.split(",")]
        args.paged = True
    if args.listen is not None:
        _host_port(args.listen, "--listen")
        args.paged = True
    if args.fleet is not None:
        if args.fleet < 2:
            _cli_error("--fleet needs at least 2 engines (1 is just "
                       "--paged)")
        args.paged = True
    elif args.disaggregate and args.join is None:
        _cli_error("--disaggregate needs --fleet N or --join (prefill "
                   "and decode roles live on different member engines)")
    return remote


def mesh_flags(args: argparse.Namespace, devices=None):
    """The reference payload's ``--tp`` / ``--pp`` guards (each a message
    and exit 2): one sharded paged engine, not a fleet of co-resident
    ones, and the plain weight path. Sets ``--paged`` and returns the
    serving mesh (None for tp = pp = 1) over ``devices``, by default the
    host's CUDA devices."""
    if args.tp * args.pp <= 1:
        return None
    args.paged = True     # only the paged engine shards tp×pp
    if args.fleet is not None:
        _cli_error("--tp/--pp shard ONE engine across chips; --fleet is "
                   "co-resident single-chip engines — pick one")
    if args.int8:
        _cli_error("--tp/--pp use the plain weight path; drop --int8 "
                   "(int8 WEIGHTS under the manual mesh step are a "
                   "ROADMAP follow-up; --kv-codec int8 composes fine)")
    from tpushare_torch.workloads.parallel.mesh import make_serving_mesh
    try:
        return make_serving_mesh(args.tp, args.pp, devices=(
            payload_devices(args) if devices is None else devices))
    except ValueError as e:
        _cli_error(f"serving mesh: {e}")


def payload_devices(args: argparse.Namespace) -> list[torch.device]:
    """The devices a run allocates on, in mesh order: ``--device``, or
    for a ``--tp``/``--pp`` serve the host's first tp*pp CUDA devices
    (as many as there are: the mesh refuses too few), or on the plain
    path the one host device named tp*pp times. The allocator cap
    covers each of them."""
    dev = resolve_device(args.device)
    n = args.tp * args.pp if args.mode == "serve" else 1
    if n <= 1:
        return [dev]
    if dev.type != "cuda":
        return [dev] * n
    return [torch.device("cuda", i)
            for i in range(min(n, torch.cuda.device_count()))]


def hbm_limit(args: argparse.Namespace) -> int:
    """The pod's HBM budget in MiB: ``--hbm-limit-mib``, else the env
    Allocate sets, else 2000."""
    if args.hbm_limit_mib is not None:
        return args.hbm_limit_mib
    return int(os.environ.get(consts.ENV_HBM_LIMIT_MIB, "2000"))


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
    limit = hbm_limit(args)
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


def run(args: argparse.Namespace, mesh_devices=None) -> dict:
    """Run one payload mode; returns its measurements (and, for serve,
    the engine, the requests and its telemetry snapshot) for callers
    that check the outcome. ``mesh_devices`` names the devices of a
    ``--tp`` / ``--pp`` serving mesh (default every CUDA device)."""
    from tpushare_torch.workloads.models.transformer import forward
    if args.mode == "serve":
        setup = serve_engine(args, mesh_devices)
        if setup.get("host") is not None:
            return serve_host(setup["host"])
        front = setup["router"] or setup["engine"]
        # the control plane's drain channel: a usage POST answered
        # {"drain": true} (a rebalancer migration) drains the front as
        # SIGTERM does, and a withdrawn directive resumes it
        usage_report.set_drain_handler(front.request_drain,
                                       on_resume=front.cancel_drain)
        try:
            with _drain_on_sigterm(front):
                return serve_traffic(front, args, setup["cfg"],
                                     setup["device"], setup["plen"],
                                     setup["max_seq"], setup["n_lanes"])
        finally:
            # the handler must not keep the engine alive past its run
            usage_report.set_drain_handler(None)
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


def serve_engine(args: argparse.Namespace, mesh_devices=None) -> dict:
    """Build the serve mode's engine from the flags: the slot engine, or
    the paged one (``--paged`` / ``--kv-codec int8``) with its pool sized
    to the slot engine's KV HBM, admission on unless ``--no-admission``.
    Returns the engine with its config, device, prompt length, max_seq
    and lane count."""
    from tpushare_torch.workloads import paging
    from tpushare_torch.workloads.serving import (PagedServingEngine,
                                                  ServingEngine)
    remote = fleet_flags(args)
    mesh = mesh_flags(args, mesh_devices)
    device, limit, cfg, params, _, plen, max_seq, mm = _setup(args)
    bucket = -(-plen // 32) * 32
    draft = draft_for(args, cfg, params, device)
    overload_kw = dict(mm=mm, queue_limit=args.queue_limit,
                       default_deadline_s=args.deadline_s, draft=draft)
    router = host = None
    if args.paged:
        # equal-HBM sizing against the slot engine's reservation, as in
        # the reference: the slots' KV budget buys the pool's pages under
        # the chosen codec — int8 gets about twice the pages —, split
        # across a fleet's local member pools
        page_size = 32
        n_members = args.fleet or 1
        budget_mib = paging.pool_hbm_mib(
            paging.pages_for_rows(args.slots * max_seq, page_size),
            page_size, cfg.n_layers, cfg.kv_heads, cfg.head_dim)
        n_pages = paging.pages_for_hbm(budget_mib / n_members, page_size,
                                       cfg.n_layers, cfg.kv_heads,
                                       cfg.head_dim, codec=args.kv_codec)
        n_lanes = max(2, args.slots * 2 // n_members)

        def member(with_draft: bool) -> PagedServingEngine:
            return PagedServingEngine(
                params, cfg, n_lanes=n_lanes, max_seq=max_seq,
                n_pages=n_pages, page_size=page_size,
                prompt_buckets=(bucket,), chunk=16, seed=args.seed,
                top_k=args.top_k, kv_codec=args.kv_codec, mesh=mesh,
                admission=admission_for(args, params, n_lanes, limit),
                **{**overload_kw, "draft": draft if with_draft else None})

        bpt = paging.kv_bytes_per_token(cfg.n_layers, cfg.kv_heads,
                                        cfg.head_dim, args.kv_codec)
        layout = (f"{n_pages} pages x {page_size} rows (codec "
                  f"{args.kv_codec}, {bpt:.0f} B/token, {n_lanes} lanes, "
                  "read ")
        if args.listen is not None:
            from tpushare_torch.workloads.remote import EngineHost
            eng = member(True)
            host = EngineHost(eng, *_host_port(args.listen, "--listen"))
            hhost, hport = host.address
            print(f"fleet host: paged engine at {hhost}:{hport}: {layout}"
                  f"{eng.attn_impl}) — join with --join {hhost}:{hport}",
                  flush=True)
        elif args.fleet is not None or remote:
            from tpushare_torch.workloads.fleet import FleetRouter
            from tpushare_torch.workloads.remote import RemoteMember
            from tpushare_torch.workloads.transport import TransportError
            # a prefill member never decodes: the draft arms only the
            # decode side
            engines = [member(not (args.disaggregate and i == 0))
                       for i in range(n_members)]
            for addr in remote:
                try:
                    engines.append(RemoteMember(addr))
                except (TransportError, OSError) as e:
                    _cli_error(f"--join {addr[0]}:{addr[1]}: {e}")
            try:
                router = FleetRouter(engines,
                                     disaggregate=args.disaggregate)
            except ValueError as e:
                # a joined host of another pool layout or shape
                _cli_error(f"fleet compose: {e}")
            eng = None
            print(f"fleet: {n_members} local engine(s) x {layout}"
                  f"{engines[0].attn_impl})"
                  + (f", +{len(remote)} remote member(s)" if remote else "")
                  + (", disaggregated (engine 0 = prefill)"
                     if args.disaggregate else ""), flush=True)
        else:
            try:
                eng = member(True)
            except ValueError as e:
                if mesh is None:
                    raise
                # the ERR_SERVING_MESH_* contract strings name the knob
                _cli_error(f"serving mesh: {e}")
            shard_note = ""
            if mesh is not None:
                shard_mib = paging.pool_hbm_mib(
                    n_pages, page_size, cfg.n_layers, cfg.kv_heads,
                    cfg.head_dim, args.kv_codec, shards=args.tp * args.pp)
                shard_note = (f", tp{args.tp}xpp{args.pp} -> "
                              f"{shard_mib:.0f} MiB pool/chip")
            print(f"paged KV pool: {layout}{eng.attn_impl}{shard_note})",
                  flush=True)
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
    adm = (eng or router.engines[0]).admission
    if adm is not None:
        print(f"admission: watermark {adm.watermark()} of {n_lanes} lanes"
              f"{' per member' if router is not None else ''}, cap "
              f"{adm.cap_mib:.0f} MiB (weights {adm.base_mib:.0f} MiB)",
              flush=True)
    return {"engine": eng, "router": router, "host": host, "cfg": cfg,
            "device": device, "plen": plen, "max_seq": max_seq,
            "n_lanes": n_lanes}


def serve_host(host) -> dict:
    """``--listen``: serve the hosted engine to remote routers until the
    process is killed (or interrupted)."""
    try:
        host.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        host.close()
    return {"mode": "serve", "host": host}


def _decode_steps(members, n_lanes: int) -> list[int]:
    """Decode steps each member dispatched (its lane-steps over its
    lanes); a prefill member of a disaggregated fleet dispatches none."""
    return [m.stats.get("lane_steps", 0) // getattr(m, "n_lanes", n_lanes)
            for m in members]


def _prefill_chunks(members) -> int:
    """Admission chunks the members recorded (``stats["prefill_chunks"]``,
    0 where a member keeps no such count)."""
    return sum(m.stats.get("prefill_chunks", 0) for m in members)


def serve_traffic(eng, args, cfg, device, plen: int, max_seq: int,
                  n_lanes: int) -> dict:
    """Drive a serving engine (or a ``FleetRouter``) with the payload's
    synthetic traffic from ``args`` (``--requests`` prompts of ``plen``
    tokens, up to ``--steps`` new tokens each, from ``--seed``) after
    one warm-up request, print the throughput lines and return the
    measurements, the engine, the requests and its telemetry snapshot
    (a fleet's merged one, with ``fleet_stats()`` and each member's
    decode steps), and the admission chunks of the warm-up and the run
    together (``prefill_chunks``)."""
    fleet = getattr(eng, "fleet_stats", None) is not None
    members = eng.engines if fleet else [eng]
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
    warm_steps = _decode_steps(members, n_lanes)
    warm_chunks = _prefill_chunks(members)
    eng.reset_stats()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    s = eng.fleet_stats() if fleet else eng.stats
    eff = lane_efficiency(s)
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs
                  if r.first_token_at is not None)
    print(f"serve throughput: {total / dt:,.0f} tokens/s "
          f"({args.requests} requests, {total} tokens, lane efficiency "
          f"{f'{eff:.0%}' if eff is not None else 'n/a'}, "
          f"d_model={cfg.d_model})", flush=True)
    if ttft:
        print(f"time to first token: p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, "
              f"max {ttft[-1] * 1e3:.1f} ms", flush=True)
    if args.draft_k is not None:
        print(f"spec: rounds={s['spec_rounds']} "
              f"accept={s['spec_accepted'] / max(1, s['spec_drafted']):.2f} "
              f"emitted={s['spec_emitted']} "
              f"skipped={s['spec_rounds_skipped']}", flush=True)
    def overload_line(st, label=""):
        return (f"{label}overload accounting: completed={st['completed']} "
                f"shed={st['shed']} "
                f"deadline_exceeded={st['deadline_exceeded']} "
                f"oom_quarantined={st['oom_quarantined']} "
                f"oom_recoveries={st['oom_recoveries']}")

    if fleet:
        for i, m in enumerate(members):
            ms = m.stats
            print(overload_line(ms, f"engine {i}: ")
                  + f" handoffs_in={ms['handoffs_in']}"
                  f" handoffs_out={ms['handoffs_out']}", flush=True)
        rs = eng.stats
        print(f"router: routed={rs['submitted'] - rs['shed']} "
              f"shed={rs['shed']} handoffs={rs['handoffs']} "
              f"affinity_hits={rs['affinity_hits']} "
              f"reasons={rs['reasons']} states={eng.member_states()}",
              flush=True)
    elif eng.draining or s["shed"] or s["deadline_exceeded"] \
            or s["oom_quarantined"]:
        print(overload_line(s), flush=True)
    # decode steps of the wave: each reads the cache once per layer
    steps = _decode_steps(members, n_lanes)
    out = {"mode": "serve", "tokens_per_s": total / dt, "seconds": dt,
           "tokens": total, "ttft_s": ttft, "engine": eng,
           "requests": reqs, "warmup_decode_steps": sum(warm_steps),
           "decode_steps": sum(steps),
           "prefill_chunks": warm_chunks + _prefill_chunks(members),
           "telemetry": (eng.snapshot() if fleet
                         else eng.telemetry.snapshot())}
    if fleet:
        out.update(fleet_stats=s, member_decode_steps=steps,
                   member_warmup_decode_steps=warm_steps)
    return out


def main(argv: list[str] | None = None) -> int:
    """The pod's entry point: refuse a poisoned Allocate env (exit 3),
    cap the allocator at the grant before anything is allocated, start
    the usage reporter, run the mode; a serve run posts its last report
    (its final counters) at exit."""
    args = parse_args(argv)
    visible = os.environ.get(consts.ENV_TPU_VISIBLE_CHIPS, "<unset>")
    if visible.startswith(consts.ERR_VISIBLE_DEVICES_PREFIX):
        # the plugin poisoned the env: fail loudly
        print(f"allocation failed: {visible}", file=sys.stderr, flush=True)
        return 3
    apply_visible_chips()
    apply_hbm_cap(payload_devices(args), hbm_limit(args))
    usage_report.start_reporter()
    run(args)
    if args.mode == "serve":
        usage_report.post_now()
    return 0


if __name__ == "__main__":
    sys.exit(main())
