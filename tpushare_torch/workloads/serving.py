"""Continuous-batching serving engines — the port of
``tpushare/workloads/serving.py``.

What the port carries over: ``Request`` (with its deadline and trace);
``_EngineCore`` — the submit queue with its overload defense (bounded
queue and reject policies, deadlines before admission and mid-decode,
terminal shed accounting), ``run``/``step``, harvest/retire credit under
the sync watchdog, OOM quarantine (at admission, at dispatch, at the
harvest), drain and ``healthz``, the AIMD admission controller, the
telemetry snapshot (``workloads/telemetry.py``: TTFT, decode latency,
tokens/s, SLO goodput and violations by phase) and request traces
(``tracing.RequestTrace``), stats and lane efficiency, the prefix
registry lookup;

- the slot engine: its device programs (``init_slots``,
  ``ingest_chunk``, ``admit``, ``_install_prefix``, ``_slot_step``,
  ``slot_decode_chunk``) and ``ServingEngine`` — a fixed batch of slot
  caches (L, n_slots, rows, Hkv, hd), dense or int8 (``cfg.kv_int8``),
  the ring cache of windowed models (``ring_rows``), the ragged read
  (``cfg.ragged_decode``: the CUDA ragged-decode kernel on the card, its
  int8 rung for int8 caches), prefix caching by copy, ``sample_n`` and
  the pipelined loop;
- the paged engine: its device programs (``init_page_state``,
  ``_paged_step``, ``paged_decode_chunk``, ``_paged_prefill_chunk``,
  ``_install_pages``, ``_paged_admit_commit``) and ``PagedServingEngine``
  with a bf16 or int8 pool (``kv_codec``) on one device, ``attn_impl``
  auto/paged/xla, and page-forecast admission — pool exhaustion defers a
  request, a forecast that could never fit sheds it.

Left for later slices (ROADMAP.md): shared prefix pages with
copy-on-write (A.3), speculative decoding (A.6), int8 weights (A.7),
MoE (A.9), meshes (A.10), fleet handoff, ``take_queue`` and
``cancel_request`` (A.11). The engines raise where the reference would
accept those, naming the item.

The reference's jitted programs become eager functions that update the
pool and the lane state IN PLACE; the host loop keeps the reference's
one device sync per decode chunk (the harvest) and one per admission
wave. Because a chunk writes in place, a real out-of-memory inside it
(not only at its sync) leaves every running lane's device state ahead
of its host mirror: the engines quarantine the chunk's whole snapshot
then, as the reference does for an OOM at the harvest.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpushare_torch import consts, tracing
from tpushare_torch.workloads import overload, paging
from tpushare_torch.workloads.decode import (
    BucketOverflowError, cache_max_seq, check_paged_config,
    check_ragged_config, chunk_step, init_cache, init_page_pool, kv_data,
    kv_planes, kv_view, make_cached_attn_core, make_paged_attn_core,
    make_ragged_attn_core, pool_page_size, prefill, prefill_chunk_layout,
    scatter_scratch_pages, truncate_top_k, truncate_top_p)
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, embed_lookup, layer_block, layer_params, lm_head,
    rope_tables)
from tpushare_torch.workloads.ops.paged_attention import resolve_paged_impl
from tpushare_torch.workloads.overload import DrainTimeout  # re-export
from tpushare_torch.workloads.telemetry import EngineTelemetry

__all__ = ["init_slots", "admit", "ingest_chunk", "slot_decode_chunk",
           "init_page_state", "paged_decode_chunk", "lane_efficiency",
           "Request", "ServingEngine", "PagedServingEngine",
           "DrainTimeout"]

# ROADMAP items of what the engines do not carry yet, for the refusals
_UNPORTED = {"draft": "A.6 (speculative decoding)",
             "mm": "A.7 (int8 weights)",
             "mesh": "A.10 (multi-GPU)"}


def _refuse_unported(**knobs) -> None:
    """Raise on the first reference knob that is set but not ported."""
    for name, value in knobs.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP {_UNPORTED[name]}")


def lane_efficiency(stats: dict) -> float | None:
    """Decode-lane tokens per dispatched lane-step (None with zero
    lane-steps). Each request's first token is sampled by admission,
    not by a decode lane, so one token per retired request is
    subtracted."""
    if not stats["lane_steps"]:
        return None
    decode_lane_tokens = stats["tokens_emitted"] - stats["requests_done"]
    return max(0, decode_lane_tokens) / stats["lane_steps"]


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids; the engine fills
    ``output`` with up to ``max_new`` ids (stopping early on ``eos``).
    ``temperature`` 0 is greedy; > 0 samples from this request's own
    generator stream, truncated to the engine's top_k and the request's
    nucleus ``top_p``. ``prefix`` names a prefix registered with
    ``ServingEngine.register_prefix``: the sequence is then prefix +
    prompt, and admission copies the prefix's K/V instead of recomputing
    it."""

    prompt: list
    max_new: int
    eos: int | None = None
    prefix: str | None = None
    temperature: float = 0.0
    top_p: float = 0.0
    output: list = dataclasses.field(default_factory=list)
    # logprob of each output token under the untruncated distribution
    logprobs: list = dataclasses.field(default_factory=list)
    done: bool = False
    # wall-clock budget from submit (seconds); None = no deadline. An
    # expired request is shed from the queue before admission, or retired
    # mid-decode with its partial output; either way its status is
    # overload.STATUS_DEADLINE_EXCEEDED
    deadline_s: float | None = None
    # terminal disposition, set exactly once (consts.TERMINAL_STATUSES)
    status: str | None = None
    # host monotonic clock at submit and when the first token reached the
    # host (the admission wave's sync) — time to first token
    submitted_at: float | None = None
    first_token_at: float | None = None
    # absolute monotonic deadline, stamped at submit
    _deadline: float | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the request's trace buffer (tracing.RequestTrace), attached at
    # first submit and flushed once at its terminal
    _trace: tracing.RequestTrace | None = dataclasses.field(
        default=None, repr=False, compare=False)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sample_rows(logits: torch.Tensor, temps: torch.Tensor, top_k: int,
                 top_ps: torch.Tensor, use_top_p: bool,
                 generators: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling over (B, vocab) fp32 logits: rows without a
    generator take the argmax, rows in ``generators`` (lane -> its own
    torch.Generator; the sampling lanes) draw at their temperature from
    the truncated distribution. Returns (tokens, their logprobs under the
    untruncated distribution)."""
    choice = torch.argmax(logits, dim=-1)
    if generators:
        scaled = truncate_top_k(
            logits / torch.clamp(temps, min=1e-6)[:, None], top_k)
        if use_top_p:
            scaled = truncate_top_p(scaled, top_ps)
        probs = torch.softmax(scaled, dim=-1)
        for lane, gen in generators.items():
            choice[lane] = torch.multinomial(probs[lane], 1,
                                             generator=gen)[0]
    logp = torch.log_softmax(logits, dim=-1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return choice, logp[rows, choice]


# ---------------------------------------------------------------------------
# slot-engine device programs
# ---------------------------------------------------------------------------

def init_slots(cfg: TransformerConfig, n_slots: int, max_seq: int,
               device: torch.device) -> dict:
    """Slot state: K/V (L, n_slots, max_seq, Hkv, hd) — codec leaves under
    ``cfg.kv_int8`` — per-slot int32 lengths (the kernel's index type),
    active flags, current tokens (the next decode input) and sampling
    state. For a windowed engine ``max_seq`` here is the cache row count
    — a ring smaller than the logical sequence bound (``ServingEngine``
    ``ring_rows``)."""
    base = init_cache(cfg, n_slots, max_seq, device=device)

    def zeros(dtype):
        return torch.zeros((n_slots,), dtype=dtype, device=device)
    return {"k": base["k"], "v": base["v"],
            "lengths": zeros(torch.int32), "active": zeros(torch.bool),
            "tokens": zeros(torch.int64), "temps": zeros(torch.float32),
            "top_ps": zeros(torch.float32), "logps": zeros(torch.float32)}


def ingest_chunk(params: dict, tokens: torch.Tensor, slots: dict, slot: int,
                 start: int, new_len: int, rel_last: int,
                 cfg: TransformerConfig, temp: float = 0.0,
                 generator: torch.Generator | None = None, top_k: int = 0,
                 top_p: float = 0.0, use_top_p: bool = False) -> dict:
    """Run a (1, Q) token chunk through ``slot``'s cache at position
    ``start`` (``decode.chunk_step`` over the slot's view, writing in
    place) — the chunked-prefill admission primitive. Sets the slot's
    length to ``new_len``, marks it active and stores the token sampled
    at in-chunk position ``rel_last`` (only the final chunk's matters)."""
    view = (slice(None), slice(slot, slot + 1))
    sub = {"k": kv_view(slots["k"], view), "v": kv_view(slots["v"], view),
           "length": start}
    logits, _ = chunk_step(params, tokens, sub, cfg, logit_pos=rel_last)
    dev = logits.device
    temps = torch.tensor([temp], dtype=torch.float32, device=dev)
    top_ps = torch.tensor([top_p], dtype=torch.float32, device=dev)
    gens = {0: generator} if temp > 0 and generator is not None else {}
    first, flogp = _sample_rows(logits, temps, top_k, top_ps, use_top_p,
                                gens)
    slots["lengths"][slot] = new_len
    slots["active"][slot] = True
    slots["tokens"][slot] = first[0]
    slots["temps"][slot] = temp
    slots["top_ps"][slot] = top_p
    slots["logps"][slot] = flogp[0]
    return slots


def _install_prefix(slots: dict, slot: int, pk, pv) -> dict:
    """Copy a registered prefix's prefilled K/V ((L, 1, P, Hkv, hd)
    leaves) into ``slot``'s rows 0..P — a device copy, no recompute; an
    int8 prefix copies its ``q`` and ``s`` planes together and is never
    requantized. Lengths, active and tokens are set by the suffix ingest
    that must follow."""
    P = kv_data(pk).shape[2]
    for dst, src in zip(kv_planes(slots["k"]) + kv_planes(slots["v"]),
                        kv_planes(pk) + kv_planes(pv)):
        dst[:, slot, :P] = src[:, 0]
    return slots


def admit(params: dict, prompt: torch.Tensor, slots: dict, slot: int,
          plen: int, cfg: TransformerConfig) -> dict:
    """Install a bucket-padded (1, P) prompt in ``slot``: the start=0
    case of :func:`ingest_chunk`. ``plen`` is the true prompt length;
    the causal mask keeps the pad tail out of every real position and
    decode later overwrites the pad K/V."""
    return ingest_chunk(params, prompt, slots, slot, 0, plen, plen - 1, cfg)


def _slot_step(params: dict, slots: dict, cfg: TransformerConfig, rope,
               top_k: int = 0, use_top_p: bool = False,
               max_len: int | None = None,
               generators: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every slot, updating ``slots`` in place.
    Active slots advance one token; inactive slots compute dead lanes
    and stay put. With ``cfg.ragged_decode`` each layer reads through
    :func:`decode.make_ragged_attn_core` (the ragged kernel on the card),
    else through :func:`decode.make_cached_attn_core` with the per-slot
    position vector. ``max_len`` is the logical sequence bound (rope
    rows); it equals the cache rows except under a ring cache, whose
    core wraps the writes. Returns (tokens, logprobs)."""
    lengths, active = slots["lengths"], slots["active"]
    max_seq = max_len or cache_max_seq(slots)
    cos_t, sin_t = rope
    cos = cos_t[lengths][:, None]                  # (B, 1, half) per row
    sin = sin_t[lengths][:, None]
    x = embed_lookup(params["embed"], slots["tokens"])[:, None]
    slot_ids = torch.arange(cache_max_seq(slots), device=lengths.device)
    for i in range(cfg.n_layers):
        if cfg.ragged_decode:
            core = make_ragged_attn_core(slots["k"], slots["v"], i, lengths,
                                         cfg)
        else:
            core = make_cached_attn_core(kv_view(slots["k"], i),
                                         kv_view(slots["v"], i), lengths,
                                         cfg, slot_ids)
        x, _ = layer_block(x, layer_params(params, i), cfg, cos, sin, core)
    logits = lm_head(params, x[:, 0])
    nxt, lp = _sample_rows(logits, slots["temps"], top_k, slots["top_ps"],
                           use_top_p, generators or {})
    nxt = torch.where(active, nxt, slots["tokens"])
    grow = active & (lengths + 1 < max_seq)
    slots["lengths"] = torch.where(grow, lengths + 1, lengths)
    slots["tokens"] = nxt
    slots["logps"] = lp
    return nxt, lp


def slot_decode_chunk(params: dict, slots: dict, cfg: TransformerConfig,
                      n_steps: int, top_k: int = 0, use_top_p: bool = False,
                      rope_len: int | None = None,
                      generators: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``n_steps`` decode steps for the whole slot batch (device-async;
    the caller syncs once at harvest). Returns (tokens (n_slots, n_steps)
    — the token emitted at each step — their logprobs, and the slots).
    ``rope_len`` is the logical sequence bound when the cache is a ring
    (default the cache rows)."""
    rope_len = rope_len or cache_max_seq(slots)
    rope = rope_tables(cfg, rope_len, slots["lengths"].device)
    toks, lps = [], []
    for _ in range(n_steps):
        nxt, lp = _slot_step(params, slots, cfg, rope, top_k=top_k,
                             use_top_p=use_top_p, max_len=rope_len,
                             generators=generators)
        toks.append(nxt)
        lps.append(lp)
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1), slots


# ---------------------------------------------------------------------------
# paged-engine device programs
# ---------------------------------------------------------------------------

def init_page_state(cfg: TransformerConfig, n_lanes: int,
                    max_pages_per_lane: int,
                    device: torch.device) -> dict:
    """Per-lane decode state: int32 block tables and lengths (the
    kernel's index types), active flags, current tokens, sampling state.
    The pool rides the same dict under "k"/"v"."""
    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "tables": zeros(n_lanes, max_pages_per_lane, dtype=torch.int32),
        "lengths": zeros(n_lanes, dtype=torch.int32),
        "active": zeros(n_lanes, dtype=torch.bool),
        "tokens": zeros(n_lanes, dtype=torch.int64),
        "temps": zeros(n_lanes, dtype=torch.float32),
        "top_ps": zeros(n_lanes, dtype=torch.float32),
        "logps": zeros(n_lanes, dtype=torch.float32),
    }


def _paged_step(params: dict, state: dict, cfg: TransformerConfig, rope,
                top_k: int = 0, use_top_p: bool = False,
                max_len: int | None = None, impl: str = "xla",
                gather_pages_w: int | None = None,
                generators: dict | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every lane over the paged pool: active lanes
    advance one token, inactive lanes compute dead lanes into the trash
    page and stay put. Updates ``state`` in place; returns (tokens,
    logprobs)."""
    lengths, active = state["lengths"], state["active"]
    cos_t, sin_t = rope
    cos = cos_t[lengths][:, None]                  # (B, 1, half) per row
    sin = sin_t[lengths][:, None]
    x = embed_lookup(params["embed"], state["tokens"])[:, None]
    for i in range(cfg.n_layers):
        core = make_paged_attn_core(kv_view(state["k"], i),
                                    kv_view(state["v"], i),
                                    state["tables"], lengths, cfg,
                                    impl=impl, gather_pages_w=gather_pages_w)
        x, _ = layer_block(x, layer_params(params, i), cfg, cos, sin, core)
    logits = lm_head(params, x[:, 0])
    nxt, lp = _sample_rows(logits, state["temps"], top_k, state["top_ps"],
                           use_top_p, generators or {})
    nxt = torch.where(active, nxt, state["tokens"])
    grow = active & (lengths + 1 < max_len)
    state["lengths"] = torch.where(grow, lengths + 1, lengths)
    state["tokens"] = nxt
    state["logps"] = lp
    return nxt, lp


def paged_decode_chunk(params: dict, state: dict, cfg: TransformerConfig,
                       n_steps: int, top_k: int = 0, use_top_p: bool = False,
                       rope_len: int | None = None, impl: str = "xla",
                       gather_pages_w: int | None = None,
                       generators: dict | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``n_steps`` decode steps for the whole lane wave (device-async; the
    caller syncs once at harvest). The engine keeps every running lane's
    table covering ``length + n_steps`` rows before dispatch. Returns
    (tokens (B, n_steps), logprobs (B, n_steps), state)."""
    rope_len = rope_len or (state["tables"].shape[1]
                            * pool_page_size(state["k"]))
    rope = rope_tables(cfg, rope_len, state["tables"].device)
    toks, lps = [], []
    for _ in range(n_steps):
        nxt, lp = _paged_step(params, state, cfg, rope, top_k=top_k,
                              use_top_p=use_top_p, max_len=rope_len,
                              impl=impl, gather_pages_w=gather_pages_w,
                              generators=generators)
        toks.append(nxt)
        lps.append(lp)
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1), state


def _paged_prefill_chunk(params: dict, tokens: torch.Tensor, sk, sv,
                         start: int, rel_last: int, cfg: TransformerConfig):
    """One bucket-padded admission chunk against the lane's contiguous
    prefill scratch — exactly ``decode.chunk_step``."""
    logits, cache = chunk_step(params, tokens,
                               {"k": sk, "v": sv, "length": start}, cfg,
                               logit_pos=rel_last)
    return logits, cache["k"], cache["v"]


def _install_pages(kp, vp, sk, sv, page_ids: torch.Tensor,
                   skip_pages: int = 0):
    """Scatter a finished prefill scratch into the lane's pages, in
    place (decode.scatter_scratch_pages, the one install rule)."""
    return (scatter_scratch_pages(kp, sk, page_ids, skip_pages),
            scatter_scratch_pages(vp, sv, page_ids, skip_pages))


def _paged_admit_commit(state: dict, lane: int, table_row: torch.Tensor,
                        new_len: int, logits: torch.Tensor, temp: float,
                        top_p: float, generator: torch.Generator | None,
                        top_k: int = 0, use_top_p: bool = False) -> dict:
    """The last admission step: sample the first token from the final
    prefill chunk's logits and commit the lane — table row, length,
    active flag, sampling state. Until this runs the lane's table row is
    zero, so a failed admission leaves its writes in the trash page."""
    dev = logits.device
    temps = torch.tensor([temp], dtype=torch.float32, device=dev)
    top_ps = torch.tensor([top_p], dtype=torch.float32, device=dev)
    gens = {0: generator} if temp > 0 and generator is not None else {}
    first, flogp = _sample_rows(logits, temps, top_k, top_ps, use_top_p,
                                gens)
    state["tables"][lane] = table_row
    state["lengths"][lane] = new_len
    state["active"][lane] = True
    state["tokens"][lane] = first[0]
    state["temps"][lane] = temp
    state["top_ps"][lane] = top_p
    state["logps"][lane] = flogp[0]
    return state


# ---------------------------------------------------------------------------
# host-side engine core
# ---------------------------------------------------------------------------

class _EngineCore:
    """Host-side machinery shared by both engines: the submit queue with
    its overload defense (bounded queue, deadlines, terminal shed
    accounting), the harvest/retire credit loop, OOM recovery, drain,
    health, telemetry and request traces, the prefix registry lookup.
    The engines plug their cache models in through ``step()`` and
    ``_scrub_lane(lane)``."""

    def _init_core(self, params: dict, cfg: TransformerConfig, n_lanes: int,
                   max_seq: int, prompt_buckets: tuple[int, ...],
                   chunk: int, seed: int, top_k: int,
                   queue_limit: int | None, reject_policy: str,
                   default_deadline_s: float | None,
                   admission: overload.AdmissionController | None,
                   faults, sync_timeout_s: float | None) -> None:
        # Overload knobs, all off by default: queue_limit bounds the
        # submit queue (reject_policy picks the victim when it is full),
        # default_deadline_s stamps every request without its own
        # deadline, admission is the AIMD watermark + headroom gate (HBM
        # MiB for the slot engine, pages for the paged one), faults is an
        # injectable tpu.fake.WorkloadFaultPlan and sync_timeout_s arms
        # the harvest's watchdog.
        self.params, self.cfg = params, cfg
        self.max_seq, self.chunk, self.top_k = max_seq, chunk, top_k
        self.seed = seed
        self._lane_count = n_lanes
        self._admitted = 0
        # sticky: flips on the first top_p request
        self._use_top_p = False
        self.buckets = tuple(sorted(b for b in prompt_buckets
                                    if b <= max_seq))
        if not self.buckets:
            raise ValueError(f"no prompt bucket <= max_seq {max_seq} "
                             f"(got {prompt_buckets})")
        self.queue: list[Request] = []
        self.running: dict[int, Request] = {}
        # prefix registry: name -> (token length, engine payload)
        self.prefixes: dict[str, tuple] = {}
        # per-lane sampling generators (sampling lanes only)
        self._generators: dict[int, torch.Generator] = {}
        # host mirror of per-lane lengths (no device fetch on the admit
        # path)
        self._lengths: dict[int, int] = {}
        # every submitted request ends as exactly one of completed /
        # shed / deadline_exceeded / oom_quarantined; requests_done is
        # the lane-retire total lane_efficiency subtracts from
        self.stats = {"requests_done": 0, "tokens_emitted": 0,
                      "lane_steps": 0, "chunks": 0, "prefill_chunks": 0,
                      "completed": 0, "shed": 0, "deadline_exceeded": 0,
                      "oom_quarantined": 0, "oom_recoveries": 0}
        if reject_policy not in overload.REJECT_POLICIES:
            raise ValueError(f"reject_policy {reject_policy!r} not in "
                             f"{overload.REJECT_POLICIES}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit {queue_limit} must be >= 1")
        self.queue_limit = queue_limit
        self.reject_policy = reject_policy
        self.default_deadline_s = default_deadline_s
        self.admission = admission
        self.faults = faults
        self._draining = False
        # live telemetry, published as the process snapshot provider
        # (the last engine constructed wins)
        self.telemetry = EngineTelemetry().publish()
        self._watchdog = None
        if sync_timeout_s is not None:
            self._watchdog = overload.SyncWatchdog(
                sync_timeout_s,
                on_degrade=lambda: self.telemetry.set_degraded(True),
                on_recover=lambda: self.telemetry.set_degraded(False))
        if self.admission is not None:
            self.telemetry.set_watermark(self.admission.watermark())
        # head-sampling counter of the request traces attached at submit
        self._trace_seen = 0

    # ---- per-request tracing ------------------------------------------

    def _trace_req(self, req: Request) -> None:
        """Attach the request's trace buffer at first submit; every
        consts.SLO_TRACE_SAMPLE_EVERY_N-th request is head-sampled (the
        finish rule keeps violators and non-completed terminals
        regardless)."""
        if req._trace is not None:
            return
        self._trace_seen += 1
        req._trace = tracing.RequestTrace(
            sampled=(self._trace_seen
                     % consts.SLO_TRACE_SAMPLE_EVERY_N) == 1,
            attrs={"prompt_len": len(req.prompt), "max_new": req.max_new,
                   **({"prefix": req.prefix} if req.prefix else {})})

    def _trace_mark(self, req: Request, name: str) -> None:
        if req._trace is not None:
            req._trace.mark(name)

    def trace_event(self, req: Request, name: str, **attrs) -> None:
        """Stamp a point-in-time event on the request's trace."""
        if req._trace is not None:
            req._trace.event(name, **attrs)

    def _finish_trace(self, req: Request,
                      violated: str | None = None) -> None:
        """Flush the request's trace at its terminal: keep it when
        head-sampled, SLO-violating or not completed."""
        rt = req._trace
        if rt is None:
            return
        keep = (rt.sampled or violated is not None
                or req.status != overload.STATUS_COMPLETED)
        rt.finish(req.status or "?", violated=violated, keep=keep)

    # ---- hooks the engines implement ----------------------------------

    def step(self) -> None:  # pragma: no cover — abstract
        raise NotImplementedError

    def _scrub_lane(self, lane: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def _sampling_generator(self, lane: int,
                            req: Request) -> torch.Generator | None:
        """Admit-time: the lane's own generator for a sampling request
        (None for a greedy one), seeded from the engine seed and the
        admission count."""
        self._admitted += 1
        if req.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + self._admitted)
        self._generators[lane] = gen
        return gen

    def _prefix_len(self, req: Request) -> int:
        """Registered length of the request's prefix (0 without one); an
        unregistered name raises at submit — a request must never
        silently serve without its system prompt."""
        if req.prefix is None:
            return 0
        if req.prefix not in self.prefixes:
            raise ValueError(
                consts.ERR_PREFIX_UNKNOWN_FMT.format(name=req.prefix))
        return self.prefixes[req.prefix][0]

    def _quarantine_admit_oom(self, lane: int, req: Request) -> None:
        """An out-of-memory fired during this request's admission:
        quarantine it (terminal status, never a lane), scrub what the
        half-admission left (the lane's rows, pages and flags are
        rewritten by ``_scrub_lane`` and by the next admission), cut the
        watermark and count the recovery."""
        req.done = True
        req.status = overload.STATUS_OOM_QUARANTINED
        self.stats["oom_quarantined"] += 1
        self.stats["oom_recoveries"] += 1
        self.telemetry.oom_recovery(id(req), queued=True)
        self._finish_trace(req)
        if self.admission is not None:
            self.admission.on_oom()
            self.telemetry.set_watermark(self.admission.watermark())
        try:
            self._scrub_lane(lane)
        except Exception:  # noqa: BLE001 — best effort, as the
            # reference's: the host side (pages, generator, charge) is
            # released before the device writes that could fail again
            pass

    # ---- submit / shed / deadlines ------------------------------------

    def submit(self, req: Request) -> None:
        """Reject impossible requests here (a caller bug raises); once
        queued a request is owed an answer. A full queue or a drain is
        load: the request is shed with its accounting. Prompts longer
        than the largest bucket are fine (chunked prefill); the padded
        layout must fit the lane."""
        off = self._prefix_len(req)
        if len(req.prompt) < 1:
            raise ValueError("empty prompt (a prefix request still needs "
                             "at least one suffix token)")
        end = self._padded_end(len(req.prompt))
        if off + end > self.max_seq:
            raise ValueError(f"prefix {off} + prompt {len(req.prompt)} "
                             f"(padded to {end}) exceeds max_seq "
                             f"{self.max_seq}")
        if off + len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(f"prefix {off} + prompt {len(req.prompt)} + "
                             f"max_new {req.max_new} exceeds max_seq "
                             f"{self.max_seq}")
        if req.top_p > 0:
            self._use_top_p = True
        req.submitted_at = time.monotonic()
        # the trace attaches first: a shed arrival is what a postmortem
        # needs to see
        self._trace_req(req)
        if self._draining:
            self._shed_request(req)
            return
        if self.queue_limit is not None and \
                len(self.queue) >= self.queue_limit:
            if self.reject_policy == overload.SHED_OLDEST:
                self._shed_request(self.queue.pop(0))
            else:
                self._shed_request(req)
                return
        d = req.deadline_s if req.deadline_s is not None \
            else self.default_deadline_s
        if d is not None:
            req._deadline = time.monotonic() + max(0.0, d)
        self.queue.append(req)
        self.telemetry.submitted(id(req))

    def _shed_request(self, req: Request) -> None:
        """Terminal shed (full queue, drain, or a forecast that could
        never fit): exactly one terminal status, no lane."""
        req.done = True
        req.status = overload.STATUS_SHED
        self.stats["shed"] += 1
        self.telemetry.shed(id(req))
        self._finish_trace(req)
        self._push_drain_state()

    def _expire_queued(self) -> None:
        """Pre-admission deadline shedding: a request that expired while
        waiting retires from the queue with the deadline status and no
        output, before any prefill is spent on it."""
        if not self.queue:
            return
        now = time.monotonic()
        keep: list[Request] = []
        for req in self.queue:
            if req._deadline is not None and now >= req._deadline:
                req.done = True
                req.status = overload.STATUS_DEADLINE_EXCEEDED
                self.stats["deadline_exceeded"] += 1
                self.telemetry.deadline_exceeded(id(req), queued=True)
                self._finish_trace(req)
            else:
                keep.append(req)
        self.queue = keep

    def _shed_queue(self) -> None:
        while self.queue:
            self._shed_request(self.queue.pop(0))

    def _fire_fault(self, route: str) -> None:
        """Injection hook of a tpu.fake.WorkloadFaultPlan (none: no-op)."""
        if self.faults is not None:
            self.faults.fire(route)

    # ---- prefill bucket layout ----------------------------------------

    def _prefill_chunks(self, plen: int) -> list[tuple[int, int, int]]:
        try:
            return prefill_chunk_layout(plen, self.buckets)
        except BucketOverflowError:
            raise ValueError(f"length {plen} exceeds the largest bucket "
                             f"{self.buckets[-1]}") from None

    def _padded_end(self, plen: int) -> int:
        start, _, padded = self._prefill_chunks(plen)[-1]
        return start + padded

    # ---- stats --------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the counters and the telemetry (between a warm-up drain
        and a measured run)."""
        self.stats = {k: 0 for k in self.stats}
        self.telemetry.reset()

    def lane_efficiency(self) -> float | None:
        return lane_efficiency(self.stats)

    # ---- retire / harvest ---------------------------------------------

    def _retire(self, lane: int,
                status: str = overload.STATUS_COMPLETED) -> None:
        req = self.running.pop(lane)
        req.done = True
        req.status = status
        # the one SLO judgement per request; its verdict tags the trace
        violated = self.telemetry.retired(
            id(req), tokens=len(req.output), status=status)
        self._finish_trace(req, violated=violated)
        if status == overload.STATUS_COMPLETED:
            self.stats["completed"] += 1
        elif status == overload.STATUS_DEADLINE_EXCEEDED:
            self.stats["deadline_exceeded"] += 1
            self.telemetry.deadline_exceeded(id(req))
        elif status == overload.STATUS_OOM_QUARANTINED:
            self.stats["oom_quarantined"] += 1
        self.stats["requests_done"] += 1
        self.stats["tokens_emitted"] += len(req.output)
        self._push_drain_state()
        self._lengths.pop(lane, None)
        self._scrub_lane(lane)

    def _credit_first_tokens(self, wave: list, tokens: torch.Tensor,
                             logps: torch.Tensor) -> None:
        """One host sync for a whole admission wave: credit each admitted
        request its first token (sampled by admission; TTFT closes here)
        and retire those that are already done."""
        firsts, flogps = tokens.tolist(), logps.tolist()
        now = time.monotonic()
        for lane, req in wave:
            first = int(firsts[lane])
            req.output.append(first)
            req.logprobs.append(float(flogps[lane]))
            req.first_token_at = now
            self.telemetry.first_token(id(req))
            self._trace_mark(req, "first")
            if ((req.eos is not None and first == req.eos)
                    or len(req.output) >= req.max_new):
                self._retire(lane)

    def _host_read(self, toks: torch.Tensor,
                   lps: torch.Tensor) -> tuple[list, list]:
        """The harvest's blocking device read (the engine's one sync per
        decode chunk), under the watchdog when one is armed. The read
        may run on the watchdog's thread, whose current device and
        stream are its own: it reads on the engine's device and the
        stream the chunk was queued on."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def read():
            self._fire_fault("sync")
            if stream is None:
                return toks.tolist(), lps.tolist()
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                return toks.tolist(), lps.tolist()

        if self._watchdog is not None:
            # past the bound the engine reads degraded while the wait
            # goes on: the loop never proceeds while the read may still
            # touch the lane state
            return self._watchdog.call(read)
        return read()

    def _harvest(self, toks: torch.Tensor, lps: torch.Tensor,
                 snapshot: dict, t0: float | None = None,
                 n_steps: int = 0) -> None:
        """Pull one dispatched chunk to the host and credit each lane's
        tokens to the request that owned it at dispatch time; then retire
        requests whose deadline passed (partial output kept) and credit
        the admission controller one clean chunk."""
        toks, lps = self._host_read(toks, lps)
        kept = 0
        for lane, req in snapshot.items():
            if req.done:
                continue            # retired after dispatch: dead lanes
            if req._trace is not None:
                req._trace.bump("decode_chunks")
            for t, lp in zip(toks[lane], lps[lane]):
                req.output.append(int(t))
                req.logprobs.append(float(lp))
                kept += 1
                if ((req.eos is not None and int(t) == req.eos)
                        or len(req.output) >= req.max_new):
                    self._retire(lane)
                    break
        # dispatch -> harvest wall over the chunk's steps: the per-token
        # decode latency a caller sees
        if t0 is not None:
            self.telemetry.decode_chunk(n_steps, time.monotonic() - t0,
                                        kept)
        now = time.monotonic()
        for lane, req in list(self.running.items()):
            if req._deadline is not None and now >= req._deadline:
                self._retire(lane, status=overload.STATUS_DEADLINE_EXCEEDED)
        if self.admission is not None:
            self.admission.on_progress()
            self.telemetry.set_watermark(self.admission.watermark())

    # ---- OOM recovery --------------------------------------------------

    def _oom_bookkeeping(self) -> None:
        self.stats["oom_recoveries"] += 1
        self.telemetry.oom_recovery()
        if self.admission is not None:
            self.admission.on_oom()
            self.telemetry.set_watermark(self.admission.watermark())

    def _recover_dispatch_oom(self) -> None:
        """Survive an out-of-memory raised at dispatch before the chunk
        touched any state (the ``dispatch`` fault route fires first):
        quarantine the largest in-flight request with its partial
        output, cut the watermark, count the recovery."""
        self._oom_bookkeeping()
        if self.running:
            victim = max(self.running, key=self._victim_key)
            self._retire(victim, status=overload.STATUS_OOM_QUARANTINED)

    def _victim_key(self, lane: int):
        """Victim ranking for an OOM: the largest live length."""
        return self._lengths.get(lane, 0)

    def _recover_harvest_oom(self, snapshot: dict,
                             count: bool = True) -> None:
        """Survive an out-of-memory after the chunk started writing:
        every request in its snapshot has cache rows (and device
        lengths) ahead of tokens that never reached the host, so each is
        quarantined with its consistent partial output. The port's
        programs update the pool and the lane state in place, so a real
        out-of-memory inside a chunk lands here too (``_run_chunk``).
        ``count=False`` folds a second chunk of the same OOM into one
        recovery."""
        if count:
            self._oom_bookkeeping()
        for lane, req in snapshot.items():
            if not req.done and self.running.get(lane) is req:
                self._retire(lane, status=overload.STATUS_OOM_QUARANTINED)

    def _run_chunk(self, fn, snapshot: dict):
        """Run one decode chunk's device programs; a real out-of-memory
        inside them quarantines the chunk's snapshot (None returned)."""
        try:
            return fn()
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            self._recover_harvest_oom(snapshot)
            return None

    # ---- drain / health ------------------------------------------------

    def run(self, max_iters: int = 10_000) -> None:
        """Drain the queue and every running request."""
        for _ in range(max_iters):
            if not self.queue and not self.running:
                return
            self.step()
        raise self._drain_timeout(max_iters)

    def _drain_timeout(self, max_iters: int) -> overload.DrainTimeout:
        undrained = list(self.running.values()) + list(self.queue)
        return overload.DrainTimeout(
            f"serving loop did not drain after {max_iters} iterations "
            f"({len(self.running)} in flight, {len(self.queue)} queued)",
            undrained=undrained, queue_depth=len(self.queue))

    @property
    def degraded(self) -> bool:
        """True while a watchdogged device read is past its bound."""
        return self._watchdog is not None and self._watchdog.degraded

    @property
    def watchdog_trips(self) -> int:
        return self._watchdog.trips if self._watchdog is not None else 0

    @property
    def draining(self) -> bool:
        return self._draining

    def request_drain(self) -> None:
        """Stop admitting (thread-safe, idempotent — a signal watcher
        may call it while ``run()`` is live). Queued requests are shed by
        the next admission pass; in-flight requests finish."""
        self._draining = True
        self._push_drain_state()

    def cancel_drain(self) -> None:
        """Rescind a drain that has not finished; work already shed stays
        shed."""
        self._draining = False
        self.telemetry.set_drain_state(False, False)

    def _push_drain_state(self) -> None:
        """Publish drain progress (keys absent until a drain was
        requested); ``drained`` flips once nothing is queued or
        running."""
        if self._draining:
            self.telemetry.set_drain_state(
                True, not self.running and not self.queue)

    def drain(self, max_iters: int = 10_000) -> dict:
        """Graceful drain to empty: stop admitting, shed the queue with
        exact accounting, finish every in-flight request. Returns the
        stats; raises :class:`overload.DrainTimeout` at the bound."""
        self.request_drain()
        for _ in range(max_iters):
            if not self.queue and not self.running:
                return dict(self.stats)
            self.step()
        raise self._drain_timeout(max_iters)

    def healthz(self) -> dict:
        """Engine-local health: ok is False exactly while a device read
        is past its watchdog bound."""
        self._fire_fault("healthz")
        return {
            "ok": not self.degraded,
            "degraded": self.degraded,
            "draining": self._draining,
            "running": len(self.running),
            "queued": len(self.queue),
            "watermark": (self.admission.watermark()
                          if self.admission is not None
                          else self._lane_count),
        }


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------

class ServingEngine(_EngineCore):
    """Host-side continuous-batching loop over the slot programs.

    Usage::

        eng = ServingEngine(params, cfg, n_slots=4, max_seq=512)
        eng.submit(Request(prompt=[...], max_new=64))
        eng.run()          # drains the queue

    The engine owns a fixed batch of ``n_slots`` cache slots; a waiting
    request is admitted into a free slot by bucketed chunked prefill, and
    decode steps every slot together, ``chunk`` steps per dispatch,
    before the next admission / retirement pass.

    ``ring_rows`` (windowed models): allocate only that many cache rows
    per slot and let positions wrap — slot memory is O(window), requests
    still run to the ``max_seq`` logical bound. Exactness needs every
    in-band key resident across the widest single write (the largest
    padded bucket), hence the window + bucket floor.

    ``cfg.ragged_decode``: decode reads go through the ragged kernel (on
    the card) so the bytes read scale with each slot's live length;
    unservable configs raise ``KernelUnavailable`` at construction.

    ``cfg.kv_int8``: the slot caches hold the int8 codec (about half the
    bytes per row): admission chunks and decode steps quantize on write
    and read the int8 rows with their scales folded in (the ragged
    kernel's int8 rung under ``cfg.ragged_decode``); prefixes register
    quantized and copy both planes.

    ``pipeline=True``: dispatch chunk i+1 before harvesting chunk i, so
    the host's harvest/retire/admit work overlaps the device's chunk;
    outputs are identical to the plain loop.

    Overload defense (all off by default): ``queue_limit`` and
    ``reject_policy``, ``default_deadline_s``, ``admission`` (an
    ``overload.AdmissionController`` whose HBM gate charges each admit's
    K/V forecast in MiB), ``faults`` (``tpu.fake.WorkloadFaultPlan``)
    and ``sync_timeout_s`` (the harvest watchdog).

    The reference's ``draft``, ``mm`` and ``mesh`` raise
    ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(self, params: dict, cfg: TransformerConfig, n_slots: int,
                 max_seq: int, prompt_buckets: tuple[int, ...] = (32, 128),
                 chunk: int = 8, mm=None, seed: int = 0, top_k: int = 0,
                 pipeline: bool = False, ring_rows: int | None = None,
                 draft: tuple | None = None, mesh=None,
                 queue_limit: int | None = None,
                 reject_policy: str = overload.REJECT_NEW,
                 default_deadline_s: float | None = None,
                 admission: overload.AdmissionController | None = None,
                 faults=None, sync_timeout_s: float | None = None):
        _refuse_unported(draft=draft, mm=mm, mesh=mesh)
        self._init_core(params, cfg, n_slots, max_seq, prompt_buckets,
                        chunk, seed, top_k, queue_limit, reject_policy,
                        default_deadline_s, admission, faults,
                        sync_timeout_s)
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.cache_rows = max_seq
        if ring_rows is not None:
            if cfg.attn_window is None:
                raise ValueError("ring_rows requires cfg.attn_window "
                                 "(a dense cache cannot drop old rows)")
            rows = min(max_seq, ring_rows)
            floor = cfg.attn_window + max(self.buckets)
            if rows < floor:
                raise ValueError(
                    f"ring_rows {rows} < attn_window + largest bucket "
                    f"({floor}): a wrapped write could alias an in-band "
                    "row")
            self.cache_rows = rows
        if cfg.ragged_decode:
            check_ragged_config(cfg, self.cache_rows)
        # which read this engine serves with (the registry forbids a
        # silent swap: an explicit ragged read raises or runs)
        self.attn_impl = "ragged" if cfg.ragged_decode else "xla"
        self.slots = init_slots(cfg, n_slots, self.cache_rows, self.device)
        self.pipeline = pipeline
        # per-slot forecast charge (MiB) backing the admission HBM gate
        self._charged_mib: dict[int, float] = {}

    def register_prefix(self, name: str, tokens: list) -> None:
        """Prefill ``tokens`` once and keep the K/V; requests naming this
        prefix get it copied into their slot instead of recomputed. Every
        subscriber still holds its own copy of the prefix rows."""
        plen = len(tokens)
        if name in self.prefixes:
            # queued requests were checked against the old length
            raise ValueError(f"prefix {name!r} already registered")
        if plen < 1 or plen >= self.max_seq:
            raise ValueError(f"prefix length {plen} outside [1, max_seq)")
        if plen >= self.cache_rows:
            raise ValueError(f"prefix length {plen} exceeds the ring "
                             f"cache rows {self.cache_rows}")
        cache = init_cache(self.cfg, 1, plen, device=self.device)
        _, cache = prefill(self.params,
                           torch.tensor([tokens], device=self.device),
                           self.cfg, cache)
        self.prefixes[name] = (plen, {"k": cache["k"], "v": cache["v"]})

    def _forecast_mib(self, req: Request) -> float:
        """Marginal HBM forecast of admitting ``req``: the K/V rows its
        whole generation occupies (prefix + prompt + max_new, capped at
        the cache rows), every layer, K and V, at the model dtype's
        width (the reference's rule, also for int8 caches)."""
        cfg = self.cfg
        rows = min(self.cache_rows,
                   self._prefix_len(req) + len(req.prompt) + req.max_new)
        return overload.kv_cost_mib(cfg.n_layers, cfg.kv_heads,
                                    cfg.head_dim, rows, cfg.dtype.itemsize)

    def _admission_allows(self, occupancy: int) -> bool:
        """Gate the queue head through the admission controller: a head
        that could never fit under the cap is shed; one that does not
        fit now defers the pass."""
        if self.admission is None:
            return True
        while self.queue:
            req = self.queue[0]
            forecast = self._forecast_mib(req)
            if not self.admission.could_ever_fit(forecast):
                self.queue.pop(0)
                self._shed_request(req)
                continue
            used = self.admission.base_mib + sum(self._charged_mib.values())
            ok, _reason = self.admission.admit_ok(occupancy, forecast,
                                                  used_mib=used)
            self.telemetry.set_watermark(self.admission.watermark())
            return ok
        return False

    def _admit_waiting(self) -> None:
        self._expire_queued()
        if self._draining:
            # stop admitting: queued work is shed, in-flight slots finish
            self._shed_queue()
            return
        free = [i for i in range(self.n_slots) if i not in self.running]
        wave: list[tuple[int, Request]] = []
        while free and self.queue:
            if not self._admission_allows(len(self.running)):
                break
            slot, req = free.pop(0), self.queue.pop(0)
            self.telemetry.admit_start(id(req))
            self._trace_mark(req, "admit")
            plen = len(req.prompt)
            off = self._prefix_len(req)
            try:
                self._fire_fault("admit")
                self.telemetry.prefill_start(id(req))
                self._trace_mark(req, "prefill")
                # a registered prefix is a device copy, not a recompute;
                # the suffix chunks then start after it
                if off:
                    _, pkv = self.prefixes[req.prefix]
                    _install_prefix(self.slots, slot, pkv["k"], pkv["v"])
                gen = self._sampling_generator(slot, req)
                # chunked prefill over the shared layout; the final chunk
                # samples the first output token at the prompt's last
                # position
                for start, piece, padded_len in self._prefill_chunks(plen):
                    arr = torch.zeros((1, padded_len), dtype=torch.int64,
                                      device=self.device)
                    arr[0, :piece] = torch.tensor(
                        req.prompt[start:start + piece], dtype=torch.int64)
                    ingest_chunk(self.params, arr, self.slots, slot,
                                 off + start, off + start + piece, piece - 1,
                                 self.cfg, temp=req.temperature,
                                 generator=gen, top_k=self.top_k,
                                 top_p=req.top_p, use_top_p=self._use_top_p)
                    self.stats["prefill_chunks"] += 1
                    self.telemetry.prefill_chunk(padded_len)
                    if req._trace is not None:
                        req._trace.bump("prefill_chunks")
            except Exception as e:
                if not overload.is_resource_exhausted(e):
                    raise
                # quarantine the request, scrub the half-ingested slot,
                # keep serving everyone else
                self._quarantine_admit_oom(slot, req)
                free.append(slot)
                continue
            self.running[slot] = req
            self._lengths[slot] = off + plen
            self._charged_mib[slot] = self._forecast_mib(req)
            self.telemetry.admitted(id(req))
            wave.append((slot, req))
        if wave:
            self._credit_first_tokens(wave, self.slots["tokens"],
                                      self.slots["logps"])

    def sample_n(self, prompt: list, n: int, max_new: int,
                 temperature: float = 1.0, top_p: float = 0.0,
                 last_token_suffix: bool = True,
                 max_iters: int = 10_000) -> list[Request]:
        """Best-of-n parallel sampling: n stochastic continuations of one
        prompt, sharing its prefill through the prefix cache (the prompt
        minus its last token registers once; each request re-feeds only
        that last token). Submits n requests, drains the engine, returns
        them with outputs and logprobs filled."""
        if n < 1:
            raise ValueError(f"n {n} must be >= 1")
        if temperature <= 0:
            raise ValueError("sample_n needs temperature > 0: n greedy "
                             "continuations would be identical")
        # share only when the 1-token suffix layout fits (its padded
        # bucket costs rows the direct chunked prefill would not)
        off = len(prompt) - 1
        share = (last_token_suffix and len(prompt) > 1
                 and off + self._padded_end(1) <= self.max_seq
                 and off + 1 + max_new <= self.max_seq)
        name = None
        if share:
            name = f"_sample_n_{self._admitted}_{len(self.prefixes)}"
            self.register_prefix(name, prompt[:-1])
            reqs = [Request(prompt=[prompt[-1]], max_new=max_new,
                            temperature=temperature, top_p=top_p,
                            prefix=name) for _ in range(n)]
        else:
            reqs = [Request(prompt=list(prompt), max_new=max_new,
                            temperature=temperature, top_p=top_p)
                    for _ in range(n)]
        for r in reqs:
            self.submit(r)
        try:
            self.run(max_iters)
        except DrainTimeout:
            # partial results instead of losing the drained majority:
            # in-flight requests keep what they produced (done False);
            # our queued samples could never admit once the private
            # prefix drops below, so they are shed (matched by identity)
            ours = {id(x) for x in reqs}
            keep: list[Request] = []
            for q in self.queue:
                if id(q) in ours:
                    self._shed_request(q)
                else:
                    keep.append(q)
            self.queue = keep
        finally:
            if name is not None:
                # intra-call sharing, not a cache: keeping it would grow
                # memory per call
                self.prefixes.pop(name, None)
        return reqs

    def _scrub_lane(self, slot: int) -> None:
        """Retire-time cleanup: drop the slot's generator and HBM charge,
        deactivate the slot on the device."""
        self._generators.pop(slot, None)
        self._charged_mib.pop(slot, None)
        self.slots["active"][slot] = False
        self.slots["lengths"][slot] = 0

    def _dispatch(self):
        """Launch one decode chunk (device-async). Returns the pending
        harvest record — device tokens / logprobs, a snapshot of which
        request owned each slot at dispatch, the dispatch time and the
        step count — or None when a real out-of-memory inside the chunk
        quarantined its snapshot."""
        self._fire_fault("dispatch")
        # never let a slot run past its bound; only ever n in {chunk, 1}
        headroom = self.max_seq - 1 - max(self._lengths[s]
                                          for s in self.running)
        n = self.chunk if headroom >= self.chunk else 1
        snapshot = dict(self.running)
        t0 = time.monotonic()
        out = self._run_chunk(lambda: slot_decode_chunk(
            self.params, self.slots, self.cfg, n, top_k=self.top_k,
            use_top_p=self._use_top_p, rope_len=self.max_seq,
            generators=self._generators), snapshot)
        if out is None:
            return None
        toks, lps, self.slots = out
        self.stats["chunks"] += 1
        self.stats["lane_steps"] += n * self.n_slots
        for slot in self.running:
            self._lengths[slot] += n
        return toks, lps, snapshot, t0, n

    def step(self) -> None:
        """Admit, decode one chunk, retire finished requests. An
        out-of-memory at dispatch (before the chunk runs) costs one
        heuristic victim; one at the harvest, or inside the chunk, the
        chunk's whole snapshot."""
        self._admit_waiting()
        if not self.running:
            if self.queue:
                # admission deferred everything with nothing in flight:
                # yield so run()'s bound spans real time
                time.sleep(0.01)
            return
        try:
            pending = self._dispatch()
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            self._recover_dispatch_oom()
            return
        if pending is None:
            return
        try:
            self._harvest(*pending)
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            self._recover_harvest_oom(pending[2])

    def run(self, max_iters: int = 10_000) -> None:
        """Drain queue and running requests. With ``pipeline=True`` chunk
        i+1 is dispatched before chunk i is harvested; a retirement is then
        discovered one chunk later, whose lanes are discarded, so outputs
        equal the plain loop's."""
        if not self.pipeline:
            return super().run(max_iters)
        pending = None
        for _ in range(max_iters):
            if pending is None and not self.queue and not self.running:
                return
            nxt = None
            try:
                nxt = self._dispatch() if self.running else None
            except Exception as e:
                if not overload.is_resource_exhausted(e):
                    raise
                self._recover_dispatch_oom()     # before the chunk ran
            if pending is not None:
                try:
                    self._harvest(*pending)
                except Exception as e:
                    if not overload.is_resource_exhausted(e):
                        raise
                    # both in-flight chunks advanced the caches past what
                    # the host will see: quarantine both snapshots
                    self._recover_harvest_oom(pending[2])
                    if nxt is not None:
                        self._recover_harvest_oom(nxt[2], count=False)
                        nxt = None
            pending = nxt
            self._admit_waiting()
        raise self._drain_timeout(max_iters)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

class PagedServingEngine(_EngineCore):
    """Block-paged KV pool + true continuous batching.

    HBM is one page pool ``(L, n_pages, page_size, Hkv, hd)``; each
    request holds only the pages its live tokens occupy, through its
    lane's block table (``paging.PageAllocator``, the host free list).
    Lane ``i``'s row ``r`` lives at ``pool[layer, tables[i, r // ps],
    r % ps]``; retired lanes' tables are zeroed and page 0 is never
    issued, so dead-lane writes land in a reserved trash page.

    ``step()`` runs admission every iteration; when a queued request
    could join right now the next dispatch shortens to one step, so new
    requests join the running wave mid-flight. Admission forecasts
    pages (prompt + expected decode) against the free pool net of growth
    already promised; a forecast beyond the whole pool is shed. Pool
    exhaustion mid-decode (only under ``decode_forecast_fraction`` < 1)
    quarantines the request whose eviction frees the most pages.

    ``kv_codec`` is the pool's storage format (``consts.KV_CODECS``):
    "bf16" stores the model dtype; "int8" stores each of K/V as ``{"q":
    int8 pages, "s": fp32 per-(row, head) scales}``, quantized at page
    install and at every decode write, dequantized at every read — about
    half the bytes per page (``paging.kv_bytes_per_el``), so equal pool
    HBM buys about twice the pages and admits deeper concurrency under
    the same admission math. ``cfg.kv_int8`` (the slot cache's knob) is
    refused: the admission scratch is dense and the pool owns the codec.

    ``attn_impl``: "paged" reads through the CUDA paged-decode kernel
    (its int8 rung for an int8 pool), "xla" through the gather twin,
    "auto" picks the kernel where the pool lives on a CUDA device
    (counted fallback otherwise).

    Overload defense as the slot engine's; the admission controller's
    gate here is pages (``AdmissionController.admit_ok_pages``: the
    forecast against the free pool net of promised growth).
    """

    def __init__(self, params: dict, cfg: TransformerConfig, n_lanes: int,
                 max_seq: int, n_pages: int, page_size: int = 32,
                 prompt_buckets: tuple[int, ...] = (32, 128),
                 chunk: int = 8, seed: int = 0, top_k: int = 0,
                 attn_impl: str = "auto", kv_codec: str = "bf16",
                 decode_forecast_fraction: float = 1.0,
                 queue_limit: int | None = None,
                 reject_policy: str = overload.REJECT_NEW,
                 default_deadline_s: float | None = None,
                 admission: overload.AdmissionController | None = None,
                 faults=None, sync_timeout_s: float | None = None):
        check_paged_config(cfg, kv_codec=kv_codec)
        self._init_core(params, cfg, n_lanes, max_seq, prompt_buckets,
                        chunk, seed, top_k, queue_limit, reject_policy,
                        default_deadline_s, admission, faults,
                        sync_timeout_s)
        self.device = params["embed"].device
        self.n_lanes = n_lanes
        self.kv_codec = kv_codec
        self.attn_impl = resolve_paged_impl(attn_impl, self.device.type,
                                            kv_codec)
        self.alloc = paging.PageAllocator(n_pages, page_size, reserved=1)
        # the pool's HBM under its codec and one row's bytes: riders on
        # every telemetry snapshot
        self.pool_mib = paging.pool_hbm_mib(n_pages, page_size, cfg.n_layers,
                                            cfg.kv_heads, cfg.head_dim,
                                            kv_codec)
        self.telemetry.set_kv_codec(kv_codec, paging.kv_bytes_per_token(
            cfg.n_layers, cfg.kv_heads, cfg.head_dim, kv_codec))
        self.telemetry.set_pool_shard_mib(self.pool_mib)
        self.max_pages_per_lane = paging.pages_for_rows(max_seq, page_size)
        self.decode_forecast_fraction = decode_forecast_fraction
        # validate the knob eagerly
        paging.forecast_request_pages(1, 1, page_size, max_seq,
                                      decode_forecast_fraction)
        self.state = {**init_page_pool(cfg, n_pages, page_size,
                                       kv_codec=kv_codec,
                                       device=self.device),
                      **init_page_state(cfg, n_lanes,
                                        self.max_pages_per_lane,
                                        self.device)}
        # forecast charges backing the admission gate
        self._charged_pages: dict[int, int] = {}
        self.stats["page_evictions"] = 0
        self.stats["peak_running"] = 0

    def _prefix_len(self, req: Request) -> int:
        if req.prefix is not None:
            raise NotImplementedError(
                "shared-prefix pages are not ported to the paged engine "
                "yet: ROADMAP A.3 (the slot engine's register_prefix "
                "serves prefixes by copy)")
        return 0

    # ---- page accounting ----------------------------------------------

    def _publish_pages(self) -> None:
        a = self.alloc
        pinned = sum(len(ids) for _, ids in self.prefixes.values())
        self.telemetry.set_pages(a.usable_pages, a.pages_in_use(),
                                 round(a.fragmentation_pct(), 1),
                                 shared=a.shared_pages(), pinned=pinned)

    def _forecast_pages(self, req: Request) -> int:
        return paging.forecast_request_pages(
            self._padded_end(len(req.prompt)), req.max_new,
            self.alloc.page_size, self.max_seq,
            self.decode_forecast_fraction)

    def _eager_pages(self, req: Request) -> int:
        """Pages admission must take now (decode growth stays lazy)."""
        return paging.pages_for_rows(self._padded_end(len(req.prompt)),
                                     self.alloc.page_size)

    def _reserved_growth(self) -> int:
        """Pages promised to running lanes but not yet allocated."""
        return sum(max(0, charged - self.alloc.owned_pages(lane))
                   for lane, charged in self._charged_pages.items()
                   if lane in self.running)

    def _table_row(self, lane: int) -> torch.Tensor:
        t = self.alloc.table(lane)
        return torch.tensor(t + [0] * (self.max_pages_per_lane - len(t)),
                            dtype=torch.int32, device=self.device)

    def _sync_table(self, lane: int) -> None:
        self.state["tables"][lane] = self._table_row(lane)

    def _scrub_lane(self, lane: int) -> None:
        """Recycle the lane's pages, zero its table row (future dead-lane
        writes land in the trash page), deactivate."""
        self._charged_pages.pop(lane, None)
        self._generators.pop(lane, None)
        if self.alloc.owned_pages(lane):
            self.alloc.release(lane)
        self.state["active"][lane] = False
        self.state["lengths"][lane] = 0
        self.state["tables"][lane] = 0
        self._publish_pages()

    # ---- admission ----------------------------------------------------

    def _never_fits(self, forecast_pages: int) -> bool:
        """The terminal-shed predicate: could this forecast never fit
        even an idle pool? (Through the admission controller when one
        is installed.)"""
        if self.admission is not None:
            return not self.admission.could_ever_fit_pages(
                forecast_pages, self.alloc.usable_pages)
        return forecast_pages > self.alloc.usable_pages

    def _admit_gate(self, occupancy: int) -> bool:
        """May the queue head be admitted now? Sheds heads that could
        never fit; defers otherwise (watermark, pressure, pages) until
        retirements free room."""
        while self.queue:
            req = self.queue[0]
            forecast = self._forecast_pages(req)
            if self._never_fits(forecast):
                self.queue.pop(0)
                self._shed_request(req)
                continue
            free_eff = self.alloc.free_pages() - self._reserved_growth()
            if self.admission is not None:
                ok, _reason = self.admission.admit_ok_pages(
                    occupancy, forecast, free_eff)
                self.telemetry.set_watermark(self.admission.watermark())
                if not ok:
                    return False
            elif forecast > free_eff:
                return False
            # the prompt's pages are taken at admit; decode growth is lazy
            return self._eager_pages(req) <= self.alloc.free_pages()
        return False

    def _run_prefill_chunks(self, sk, sv, prompt: list):
        logits = None
        for start, piece, padded_len in self._prefill_chunks(len(prompt)):
            arr = torch.zeros((1, padded_len), dtype=torch.int64,
                              device=self.device)
            arr[0, :piece] = torch.tensor(prompt[start:start + piece],
                                          dtype=torch.int64)
            logits, sk, sv = _paged_prefill_chunk(
                self.params, arr, sk, sv, start, piece - 1, self.cfg)
            self.stats["prefill_chunks"] += 1
            self.telemetry.prefill_chunk(padded_len)
        return logits, sk, sv

    def _admit_waiting(self) -> None:
        self._expire_queued()
        if self._draining:
            # stop admitting: queued work is shed, in-flight lanes finish
            self._shed_queue()
            return
        free = [i for i in range(self.n_lanes) if i not in self.running]
        wave: list[tuple[int, Request]] = []
        while free and self.queue:
            if not self._admit_gate(len(self.running)):
                break
            lane, req = free.pop(0), self.queue.pop(0)
            self.telemetry.admit_start(id(req))
            self._trace_mark(req, "admit")
            plen = len(req.prompt)
            padded = self._padded_end(plen)
            ps = self.alloc.page_size
            try:
                self._fire_fault("admit")
                self.alloc.ensure(lane, padded)
                gen = self._sampling_generator(lane, req)
                # page-rounded scratch: the transient prefill band costs
                # O(prompt), not O(max_seq)
                scratch = init_cache(self.cfg, 1,
                                     paging.page_rounded_rows(padded, ps),
                                     device=self.device)
                self.telemetry.prefill_start(id(req))
                self._trace_mark(req, "prefill")
                if req._trace is not None:
                    req._trace.bump("prefill_chunks",
                                    len(self._prefill_chunks(plen)))
                logits, sk, sv = self._run_prefill_chunks(
                    scratch["k"], scratch["v"], req.prompt)
                table = self.alloc.table(lane)
                _install_pages(self.state["k"], self.state["v"], sk, sv,
                               torch.tensor(table, dtype=torch.int64,
                                            device=self.device))
                _paged_admit_commit(self.state, lane, self._table_row(lane),
                                    plen, logits, req.temperature,
                                    req.top_p, gen, top_k=self.top_k,
                                    use_top_p=self._use_top_p)
            except paging.PagePoolExhausted:
                # raced below the gate's estimate: put the head back and
                # let the next step's retirements free room
                if self.alloc.owned_pages(lane):
                    self.alloc.release(lane)
                self.queue.insert(0, req)
                free.append(lane)
                break
            except Exception as e:
                if not overload.is_resource_exhausted(e):
                    raise
                # the lane's table row is committed last, so a failed
                # admission's writes sit in its own pages (released by
                # the scrub) or the trash page
                self._quarantine_admit_oom(lane, req)
                free.append(lane)
                continue
            self.running[lane] = req
            self._lengths[lane] = plen
            self.alloc.note_rows(lane, plen)
            self._charged_pages[lane] = self._forecast_pages(req)
            self.telemetry.admitted(id(req))
            wave.append((lane, req))
        self.stats["peak_running"] = max(self.stats["peak_running"],
                                         len(self.running))
        self._publish_pages()
        if wave:
            self._credit_first_tokens(wave, self.state["tokens"],
                                      self.state["logps"])

    # ---- decode -------------------------------------------------------

    def _ensure_pages(self, n: int) -> bool:
        """Grow every running lane's table to cover its next ``n`` rows
        before dispatch. On pool exhaustion quarantine the lane whose
        eviction frees the most pages and retry; False when nothing is
        left running."""
        while self.running:
            try:
                for lane in sorted(self.running):
                    rows = min(self._lengths[lane] + n, self.max_seq)
                    if self.alloc.ensure(lane, rows):
                        self._sync_table(lane)
                return True
            except paging.PagePoolExhausted:
                victim = max(self.running, key=self._victim_key)
                self._retire(victim, status=overload.STATUS_OOM_QUARANTINED)
                self.stats["page_evictions"] += 1
                if self.admission is not None:
                    self.admission.on_oom()
                    self.telemetry.set_watermark(
                        self.admission.watermark())
        return False

    def _victim_key(self, lane: int):
        """Pages a quarantine would recycle (private pages), length as
        the tiebreak."""
        return (self.alloc.private_pages(lane), self._lengths.get(lane, 0))

    def _could_admit_now(self) -> bool:
        """Side-effect-free peek: would the queue head be admitted if
        admission ran right now? A head deferred anyway must not drag
        the engine into one-step dispatches."""
        if not self.queue or len(self.running) >= self.n_lanes:
            return False
        req = self.queue[0]
        forecast = self._forecast_pages(req)
        if self._never_fits(forecast):
            return True     # the head will be shed: run the admission pass
        if self.admission is not None:
            if len(self.running) >= self.admission.watermark():
                return False
            if self.admission.pressure_deferring(len(self.running)):
                return False
        if forecast > self.alloc.free_pages() - self._reserved_growth():
            return False
        return self._eager_pages(req) <= self.alloc.free_pages()

    def _next_chunk(self) -> int:
        """Full ``chunk`` normally, one step whenever a queued request
        could join the wave right now (continuous batching)."""
        headroom = self.max_seq - 1 - max(self._lengths[s]
                                          for s in self.running)
        n = self.chunk if headroom >= self.chunk else 1
        if n > 1 and self._could_admit_now():
            n = 1
        return n

    def _rung_for_rows(self, rows: int) -> int:
        """Power-of-two table read width covering ``rows``."""
        need = paging.pages_for_rows(min(rows, self.max_seq),
                                     self.alloc.page_size)
        w = self.max_pages_per_lane
        while w > 1 and w // 2 >= need:
            w //= 2
        return w

    def _gather_rung(self, n: int) -> int:
        return self._rung_for_rows(
            max(self._lengths[s] for s in self.running) + n)

    def _dispatch(self, n: int):
        """Launch one decode chunk (device-async); the slot engine's
        pending-harvest contract."""
        self._fire_fault("dispatch")
        if not self._ensure_pages(n):
            return None
        self._publish_pages()
        snapshot = dict(self.running)
        t0 = time.monotonic()
        out = self._run_chunk(lambda: paged_decode_chunk(
            self.params, self.state, self.cfg, n, top_k=self.top_k,
            use_top_p=self._use_top_p, rope_len=self.max_seq,
            impl=self.attn_impl, gather_pages_w=self._gather_rung(n),
            generators=self._generators), snapshot)
        if out is None:
            return None
        toks, lps, self.state = out
        self.stats["chunks"] += 1
        self.stats["lane_steps"] += n * self.n_lanes
        for lane in self.running:
            self._lengths[lane] += n
            self.alloc.note_rows(lane, min(self._lengths[lane],
                                           self.max_seq))
        return toks, lps, snapshot, t0, n

    def step(self) -> None:
        """Admit (every step), decode one chunk, harvest, retire, with
        the slot engine's out-of-memory split; pool exhaustion is
        handled in ``_ensure_pages`` (victim quarantine)."""
        self._fire_fault("step")
        self._admit_waiting()
        if not self.running:
            if self.queue:
                time.sleep(0.01)
            return
        try:
            pending = self._dispatch(self._next_chunk())
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            self._recover_dispatch_oom()
            return
        if pending is None:
            return
        try:
            self._harvest(*pending)
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            self._recover_harvest_oom(pending[2])
