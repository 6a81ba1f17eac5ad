"""A serving cell: the port's ``PagedServingEngine`` (the engine
``infer.py --mode serve --paged`` builds) under open-loop traffic.

Set-up builds the weights and the engine at the cell's sizes and serves
a warm-up set of requests, one prompt a prefill bucket and one of the
longest prompt, each long enough for a full decode chunk and a one-step
chunk. The window offers the traffic's requests at their due instants
from its start to ``seconds``; the engine then drains what was offered
within ``drain_seconds``, and every offered request counts. A request
is timed from when it was due, so a stall that delays later submits
counts against them; how late the generator submitted is reported
beside.

The KV pool holds the cell's ``n_pages``: the traffic's measured peak
with a margin (the cell file says which), not a pool for every lane's
longest request. The engine's admission waits while pages are short.
The run records the pool's peak pages in use and the peak of running
lanes over the window.

The benchmark's own spans wrap the calls into the engine's layers:
each admission wave (``_admit_waiting``: prefill of the wave's prompts,
install, the first-token sync) and each decode chunk (``_dispatch`` to
the end of ``_harvest``). These are the engine's private methods: a
change to them has to carry the spans over. With tracing, the
profiler's one-time start falls in set-up (``DeviceTrace.prewarm``);
it records from the start of the cell's ``trace.slice_s`` to the end
of the drain (it is stopped only after the loop: stopping it takes
host time, which inside the loop would stall the engine), and the
trace is read over the slice alone, which lies inside the offer
window, so that no drain is in it. The card is synchronised at the
slice's edges, between engine steps, so the kernels that ran in the
slice are those launched in it; the K5 reads dispatched in it are
counted from the lanes' lengths, and the port's launch counters are
read at its edges.

After the window a sample of the finished requests, drawn from the
seed with the longest among them, is checked against the plain fp32
reference (``reference/serve.py``): each served token's logit and its
logprob as the engine reported it."""

from __future__ import annotations

import random
import time

import torch

from benchmark.drivers.common import (free_device, launch_delta, launches,
                                      peak_bytes, port_config, sync)
from benchmark.reference.serve import served_gaps
from benchmark.roofline import paged_decode_bytes, paged_decode_ops
from benchmark.weights import leaf_seed, make_params


class EngineSpans:
    """Host spans around the engine's admission waves and decode
    chunks, and the K5 work of the chunks dispatched while
    ``counting``."""

    def __init__(self, eng, m: dict) -> None:
        self.m = m
        self.waves: list[tuple[float, float, int]] = []
        self.chunks: list[tuple[float, float, int]] = []
        self.k5 = {"bytes": 0, "ops": 0, "steps": 0}
        self.counting = False
        self._open = None
        admit, dispatch, harvest = (eng._admit_waiting, eng._dispatch,
                                    eng._harvest)

        def wrapped_admit():
            queued = list(eng.queue)
            t0 = time.monotonic()
            with torch.profiler.record_function("bench.admit"):
                admit()
            left = {id(r) for r in eng.queue}
            tokens = sum(len(r.prompt) for r in queued if id(r) not in left)
            if tokens:
                self.waves.append((t0, time.monotonic(), tokens))

        def wrapped_dispatch(n):
            t0 = time.monotonic()
            lengths = [eng._lengths[lane] for lane in eng.running]
            with torch.profiler.record_function("bench.decode_dispatch"):
                pending = dispatch(n)
            if pending is not None:
                self._open = (t0, pending[2], sum(
                    len(r.output) for r in pending[2].values()))
                if self.counting:
                    self._count_k5(lengths, n, eng.n_lanes)
            return pending

        def wrapped_harvest(*pending):
            with torch.profiler.record_function("bench.decode_harvest"):
                harvest(*pending)
            t0, snap, before = self._open
            kept = sum(len(r.output) for r in snap.values()) - before
            self.chunks.append((t0, time.monotonic(), kept))

        eng._admit_waiting = wrapped_admit
        eng._dispatch = wrapped_dispatch
        eng._harvest = wrapped_harvest

    def _count_k5(self, lengths: list[int], n: int, lanes: int) -> None:
        m = self.m
        H, Hkv, hd, L = (m["n_heads"], m["kv_heads"], m["head_dim"],
                         m["n_layers"])
        for s in range(n):
            rows = sum(x + s + 1 for x in lengths)
            self.k5["bytes"] += L * paged_decode_bytes(rows, len(lengths),
                                                       H, Hkv, hd)
            self.k5["ops"] += L * paged_decode_ops(rows, H, hd)
            self.k5["steps"] += 1


def build_engine(params, cfg, cell: dict, seed: int):
    from tpushare_torch.workloads.serving import PagedServingEngine
    e = cell["engine"]
    return PagedServingEngine(
        params, cfg, n_lanes=e["n_lanes"], max_seq=e["max_seq"],
        n_pages=int(e["n_pages"]), page_size=e["page_size"],
        prompt_buckets=tuple(e["prompt_buckets"]), chunk=e["chunk"],
        seed=seed, attn_impl=e["attn_impl"])


def warm_up(eng, cell: dict, mix: dict, seed: int, vocab: int) -> None:
    from tpushare_torch.workloads.serving import Request
    e = cell["engine"]
    g = torch.Generator()
    g.manual_seed(leaf_seed(seed, "warmup"))
    lens = list(e["prompt_buckets"]) + [int(mix["prompt"]["max"])]
    reqs = [Request(prompt=torch.randint(0, vocab, (n,), generator=g)
                    .tolist(), max_new=e["chunk"] + 1) for n in lens]
    for r in reqs:
        eng.submit(r)
    while not all(r.done for r in reqs):
        eng.step()
    eng.reset_stats()


def sample_for_check(done: list[dict], seed: int, tokens: int) -> list[dict]:
    """The longest finished request, then others in an order drawn from
    the seed, until ``tokens`` served tokens are in the sample."""
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + len(r["output"]))
    rest = [r for r in done if r is not longest]
    random.Random(leaf_seed(seed, "check-sample")).shuffle(rest)
    out, n = [longest], len(longest["output"])
    for r in rest:
        if n >= tokens:
            break
        out.append(r)
        n += len(r["output"])
    return out


def run(ctx: dict) -> dict:
    from tpushare_torch.workloads.serving import Request
    cell, m, mix, seed = ctx["cell"], ctx["m"], ctx["mix"], ctx["seed"]
    device, seconds = ctx["device"], float(ctx["seconds"])
    e = cell["engine"]
    cfg = port_config(m, e["max_seq"])
    marks = {"start_s": time.perf_counter() - ctx["t_start"]}
    params = make_params(seed, m, m["dtype"], device)
    sync(device)
    marks["weights_s"] = time.perf_counter() - ctx["t_start"]
    eng = build_engine(params, cfg, cell, seed)
    sync(device)
    marks["engine_s"] = time.perf_counter() - ctx["t_start"]
    warm_up(eng, cell, mix, seed, m["vocab"])
    # the pool's peak from here on is the window's
    eng.alloc.peak_in_use = eng.alloc.pages_in_use()
    if ctx["trace"]:
        ctx["tracer"].prewarm()
    sync(device)
    marks["warm_up_s"] = time.perf_counter() - ctx["t_start"]
    traffic = ctx["traffic"].make_requests(mix, seed, seconds,
                                           float(cell["rate_rps"]),
                                           m["vocab"])
    spans = EngineSpans(eng, m)
    sync(device)
    setup_s = time.perf_counter() - ctx["t_start"]

    before, _ = launches()
    sl_from, sl_to = (float(x) for x in cell["trace"]["slice_s"])
    tracer = ctx["tracer"]() if ctx["trace"] else None
    tracing = "waiting" if tracer is not None else "off"
    traced_launches, slice_span, enter_s = None, None, None

    def close_slice():
        nonlocal traced_launches
        sync(device)
        slice_span.__exit__(None, None, None)
        spans.counting = False
        traced_launches = launch_delta(traced_from, launches()[0])

    reqs = [Request(prompt=t["prompt"], max_new=t["max_new"])
            for t in traffic]
    submit_at = [None] * len(reqs)
    t0 = time.monotonic()
    t0_ns = time.time_ns()
    i, limit = 0, seconds + float(cell["drain_seconds"])
    while True:
        el = time.monotonic() - t0
        if tracing == "waiting" and el >= sl_from:
            tracer.__enter__()
            enter_s = time.monotonic() - t0 - el
            traced_from = launches()[0]
            slice_span = tracer.span("bench.slice")
            slice_span.__enter__()
            tracing, spans.counting = "on", True
        elif tracing == "on" and el >= sl_to:
            close_slice()
            tracing = "sliced"
        while i < len(reqs) and traffic[i]["due_s"] <= el:
            eng.submit(reqs[i])
            submit_at[i] = time.monotonic() - t0
            i += 1
        if i == len(reqs) and all(r.done for r in reqs):
            break
        if el >= limit:
            break
        if eng.queue or eng.running:
            eng.step()
        elif i < len(reqs):
            time.sleep(min(0.002, max(0.0, traffic[i]["due_s"] - el)))
    span_s = time.monotonic() - t0
    if tracing == "on":
        close_slice()
        tracing = "sliced"
    if tracing == "sliced":
        tracer.__exit__(None, None, None)
        tracing = "done"
    after, fallbacks = launches()
    peak, reserved = peak_bytes(device)
    pool = {"pages": eng.alloc.usable_pages,
            "peak_pages_in_use": eng.alloc.peak_in_use,
            "peak_running_lanes": eng.stats["peak_running"],
            "lanes": eng.n_lanes}

    records = []
    for t, r, sub in zip(traffic, reqs, submit_at):
        due = t0 + t["due_s"]
        admit_ns = (r._trace._marks.get("admit")
                    if r._trace is not None else None)
        records.append({
            "prompt": list(r.prompt), "output": list(r.output),
            "logprobs": list(r.logprobs),
            "max_new": r.max_new, "due_s": t["due_s"],
            "late_s": None if sub is None else sub - t["due_s"],
            "completed": r.status == "completed",
            "ttft_s": (r.first_token_at - due
                       if r.first_token_at is not None else None),
            "queue_s": ((admit_ns - t0_ns) / 1e9 - t["due_s"]
                        if admit_ns is not None else None)})
    del eng, params, reqs
    free_device(device)

    done = [r for r in records if r["completed"]]
    sample = sample_for_check(done, seed, int(cell["check"]["sample_tokens"]))
    control = bool(ctx.get("control"))
    gaps = served_gaps(seed, m, [(r["prompt"], r["output"], r["logprobs"])
                                 for r in sample], device, control=control)
    numbers = {"logit_gap": max((g["gap"] for g in gaps), default=float("nan")),
               "logprob_gap": max((g["logprob_gap"] for g in gaps),
                                  default=float("nan")),
               "unfinished": float(len(records) - len(done)),
               "_sampled_requests": len(sample),
               "_sampled_tokens": sum(len(r["output"]) for r in sample)}
    if control:
        numbers["_control_logit_gap"] = max(g["control_gap"] for g in gaps)
        numbers["_control_logprob_gap"] = max(g["control_logprob_gap"]
                                              for g in gaps)
    return {"kind": "serve", "m": m, "mix": mix, "setup_s": setup_s,
            "offer_s": seconds, "span_s": span_s, "requests": records,
            "attempted": len(records), "failed": len(records) - len(done),
            "waves": spans.waves, "chunks": spans.chunks, "k5": spans.k5,
            "peak_bytes": peak, "reserved_bytes": reserved,
            "launches": launch_delta(before, after), "fallbacks": fallbacks,
            "trace": (tracer.summary(window="bench.slice")
                      if tracing == "done" else None),
            "trace_launches": traced_launches, "trace_enter_s": enter_s,
            "pool": pool,
            "device": torch.device(device).type, "numbers": numbers,
            "setup_marks": marks}
