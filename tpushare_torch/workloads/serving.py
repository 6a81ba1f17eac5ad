"""Block-paged continuous-batching serving engine — the port of the
paged half of ``tpushare/workloads/serving.py``.

What this slice carries over: ``Request``; a reduced ``_EngineCore``
(the submit queue, ``run``/``step``, harvest/retire credit, stats and
lane efficiency); the paged device programs (``init_page_state``,
``_paged_step``, ``paged_decode_chunk``, ``_paged_prefill_chunk``,
``_install_pages``, ``_paged_admit_commit``); and
``PagedServingEngine`` with a bf16 pool on one device, ``attn_impl``
auto/paged/xla, and page-forecast admission — pool exhaustion defers a
request, a forecast that could never fit sheds it.

Left for later slices (ROADMAP.md): telemetry/tracing/SLO, the AIMD
admission controller, watchdog, deadlines, OOM quarantine and drain,
shared prefixes with copy-on-write, speculative decoding, fleet
handoff, the slot engine.

The reference's jitted programs become eager functions that update the
pool and the lane state IN PLACE; the host loop keeps the reference's
one device sync per decode chunk (the harvest) and one per admission
wave.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpushare_torch.workloads import overload, paging
from tpushare_torch.workloads.decode import (
    BucketOverflowError, check_paged_config, chunk_step, init_cache,
    init_page_pool, make_paged_attn_core, pool_page_size,
    prefill_chunk_layout, scatter_scratch_pages, truncate_top_k,
    truncate_top_p)
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, embed_lookup, layer_block, layer_params, lm_head,
    rope_tables)
from tpushare_torch.workloads.ops.paged_attention import resolve_paged_impl

__all__ = ["init_page_state", "paged_decode_chunk", "lane_efficiency",
           "Request", "PagedServingEngine"]


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
    nucleus ``top_p``."""

    prompt: list
    max_new: int
    eos: int | None = None
    temperature: float = 0.0
    top_p: float = 0.0
    output: list = dataclasses.field(default_factory=list)
    # logprob of each output token under the untruncated distribution
    logprobs: list = dataclasses.field(default_factory=list)
    done: bool = False
    # terminal disposition, set exactly once (consts.TERMINAL_STATUSES)
    status: str | None = None
    # host monotonic clock at submit and when the first token reached the
    # host (the admission wave's sync) — time to first token
    submitted_at: float | None = None
    first_token_at: float | None = None


# ---------------------------------------------------------------------------
# device programs
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
        core = make_paged_attn_core(state["k"][i], state["v"][i],
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
    rope = rope_tables(cfg, rope_len, state["k"].device)
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
    """Host-side machinery: the submit queue, the harvest/retire credit
    loop, stats. The engine plugs its cache model in through ``step()``
    and ``_scrub_lane(lane)``."""

    def _init_core(self, params: dict, cfg: TransformerConfig, n_lanes: int,
                   max_seq: int, prompt_buckets: tuple[int, ...],
                   chunk: int, seed: int, top_k: int) -> None:
        self.params, self.cfg = params, cfg
        self.max_seq, self.chunk, self.top_k = max_seq, chunk, top_k
        self.seed = seed
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
        # host mirror of per-lane lengths (no device fetch on the admit
        # path)
        self._lengths: dict[int, int] = {}
        self.stats = {"requests_done": 0, "tokens_emitted": 0,
                      "lane_steps": 0, "chunks": 0, "prefill_chunks": 0,
                      "completed": 0, "shed": 0, "oom_quarantined": 0}

    def step(self) -> None:  # pragma: no cover — abstract
        raise NotImplementedError

    def _scrub_lane(self, lane: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def submit(self, req: Request) -> None:
        """Reject impossible requests here: once queued a request is owed
        an answer. Prompts longer than the largest bucket are fine
        (chunked prefill); the padded layout must fit the lane."""
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        end = self._padded_end(len(req.prompt))
        if end > self.max_seq:
            raise ValueError(f"prompt {len(req.prompt)} (padded to {end}) "
                             f"exceeds max_seq {self.max_seq}")
        if len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(f"prompt {len(req.prompt)} + max_new "
                             f"{req.max_new} exceeds max_seq {self.max_seq}")
        if req.top_p > 0:
            self._use_top_p = True
        req.submitted_at = time.monotonic()
        self.queue.append(req)

    def _shed_request(self, req: Request) -> None:
        """Terminal shed (a forecast that could never fit): exactly one
        terminal status, no lane."""
        req.done = True
        req.status = overload.STATUS_SHED
        self.stats["shed"] += 1

    def _prefill_chunks(self, plen: int) -> list[tuple[int, int, int]]:
        try:
            return prefill_chunk_layout(plen, self.buckets)
        except BucketOverflowError:
            raise ValueError(f"length {plen} exceeds the largest bucket "
                             f"{self.buckets[-1]}") from None

    def _padded_end(self, plen: int) -> int:
        start, _, padded = self._prefill_chunks(plen)[-1]
        return start + padded

    def reset_stats(self) -> None:
        self.stats = {k: 0 for k in self.stats}

    def lane_efficiency(self) -> float | None:
        return lane_efficiency(self.stats)

    def _retire(self, lane: int,
                status: str = overload.STATUS_COMPLETED) -> None:
        req = self.running.pop(lane)
        req.done = True
        req.status = status
        if status == overload.STATUS_COMPLETED:
            self.stats["completed"] += 1
        elif status == overload.STATUS_OOM_QUARANTINED:
            self.stats["oom_quarantined"] += 1
        self.stats["requests_done"] += 1
        self.stats["tokens_emitted"] += len(req.output)
        self._lengths.pop(lane, None)
        self._scrub_lane(lane)

    def _harvest(self, toks: torch.Tensor, lps: torch.Tensor,
                 snapshot: dict) -> None:
        """Pull one dispatched chunk to the host (the engine's one sync
        per chunk) and credit each lane's tokens to the request that
        owned it at dispatch time."""
        toks, lps = toks.tolist(), lps.tolist()
        for lane, req in snapshot.items():
            if req.done:
                continue
            for t, lp in zip(toks[lane], lps[lane]):
                req.output.append(int(t))
                req.logprobs.append(float(lp))
                if ((req.eos is not None and int(t) == req.eos)
                        or len(req.output) >= req.max_new):
                    self._retire(lane)
                    break

    def run(self, max_iters: int = 10_000) -> None:
        """Drain the queue and every running request."""
        for _ in range(max_iters):
            if not self.queue and not self.running:
                return
            self.step()
        raise RuntimeError(
            f"serving loop did not drain after {max_iters} iterations "
            f"({len(self.running)} in flight, {len(self.queue)} queued)")


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

    ``attn_impl``: "paged" reads through the CUDA paged-decode kernel,
    "xla" through the gather twin, "auto" picks the kernel where the
    pool lives on a CUDA device (counted fallback otherwise).
    """

    def __init__(self, params: dict, cfg: TransformerConfig, n_lanes: int,
                 max_seq: int, n_pages: int, page_size: int = 32,
                 prompt_buckets: tuple[int, ...] = (32, 128),
                 chunk: int = 8, seed: int = 0, top_k: int = 0,
                 attn_impl: str = "auto",
                 decode_forecast_fraction: float = 1.0):
        check_paged_config(cfg)
        self._init_core(params, cfg, n_lanes, max_seq, prompt_buckets,
                        chunk, seed, top_k)
        self.device = params["embed"].device
        self.n_lanes = n_lanes
        self.attn_impl = resolve_paged_impl(attn_impl, self.device.type)
        self.alloc = paging.PageAllocator(n_pages, page_size, reserved=1)
        self.max_pages_per_lane = paging.pages_for_rows(max_seq, page_size)
        self.decode_forecast_fraction = decode_forecast_fraction
        # validate the knob eagerly
        paging.forecast_request_pages(1, 1, page_size, max_seq,
                                      decode_forecast_fraction)
        self.state = {**init_page_pool(cfg, n_pages, page_size,
                                       device=self.device),
                      **init_page_state(cfg, n_lanes,
                                        self.max_pages_per_lane,
                                        self.device)}
        # per-lane sampling generators (sampling lanes only) and forecast
        # charges backing the admission gate
        self._generators: dict[int, torch.Generator] = {}
        self._charged_pages: dict[int, int] = {}
        self.stats["page_evictions"] = 0
        self.stats["peak_running"] = 0

    # ---- page accounting ----------------------------------------------

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

    # ---- admission ----------------------------------------------------

    def _never_fits(self, forecast_pages: int) -> bool:
        return forecast_pages > self.alloc.usable_pages

    def _fits_now(self, req: Request) -> bool:
        """Does ``req``'s forecast fit the free pool net of promised
        growth, with its prompt pages free to take this step?"""
        if (self._forecast_pages(req)
                > self.alloc.free_pages() - self._reserved_growth()):
            return False
        return self._eager_pages(req) <= self.alloc.free_pages()

    def _admit_gate(self) -> bool:
        """May the queue head be admitted now? Sheds heads that could
        never fit; defers otherwise until retirements free pages."""
        while self.queue:
            req = self.queue[0]
            if self._never_fits(self._forecast_pages(req)):
                self.queue.pop(0)
                self._shed_request(req)
                continue
            return self._fits_now(req)
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
        return logits, sk, sv

    def _admit_waiting(self) -> None:
        free = [i for i in range(self.n_lanes) if i not in self.running]
        wave: list[tuple[int, Request]] = []
        while free and self.queue:
            if not self._admit_gate():
                break
            lane, req = free.pop(0), self.queue.pop(0)
            plen = len(req.prompt)
            padded = self._padded_end(plen)
            ps = self.alloc.page_size
            try:
                self.alloc.ensure(lane, padded)
            except paging.PagePoolExhausted:
                # raced below the gate's estimate: put the head back and
                # let the next step's retirements free room
                self.queue.insert(0, req)
                free.append(lane)
                break
            self._admitted += 1
            gen = None
            if req.temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.seed * 1_000_003 + self._admitted)
                self._generators[lane] = gen
            # page-rounded scratch: the transient prefill band costs
            # O(prompt), not O(max_seq)
            scratch = init_cache(self.cfg, 1,
                                 paging.page_rounded_rows(padded, ps),
                                 device=self.device)
            logits, sk, sv = self._run_prefill_chunks(
                scratch["k"], scratch["v"], req.prompt)
            table = self.alloc.table(lane)
            _install_pages(self.state["k"], self.state["v"], sk, sv,
                           torch.tensor(table, dtype=torch.int64,
                                        device=self.device))
            _paged_admit_commit(self.state, lane, self._table_row(lane),
                                plen, logits, req.temperature, req.top_p,
                                gen, top_k=self.top_k,
                                use_top_p=self._use_top_p)
            self.running[lane] = req
            self._lengths[lane] = plen
            self.alloc.note_rows(lane, plen)
            self._charged_pages[lane] = self._forecast_pages(req)
            wave.append((lane, req))
        self.stats["peak_running"] = max(self.stats["peak_running"],
                                         len(self.running))
        if not wave:
            return
        # one host sync for the whole admission wave
        firsts = self.state["tokens"].tolist()
        flogps = self.state["logps"].tolist()
        now = time.monotonic()
        for lane, req in wave:
            first = int(firsts[lane])
            req.output.append(first)
            req.logprobs.append(float(flogps[lane]))
            req.first_token_at = now
            if ((req.eos is not None and first == req.eos)
                    or len(req.output) >= req.max_new):
                self._retire(lane)

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
        return False

    def _victim_key(self, lane: int):
        return (self.alloc.owned_pages(lane), self._lengths.get(lane, 0))

    def _could_admit_now(self) -> bool:
        """Side-effect-free peek: would the queue head be admitted if
        admission ran right now?"""
        if not self.queue or len(self.running) >= self.n_lanes:
            return False
        req = self.queue[0]
        # a head that will be shed also warrants the admission pass
        return (self._never_fits(self._forecast_pages(req))
                or self._fits_now(req))

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
        """Launch one decode chunk (device-async)."""
        if not self._ensure_pages(n):
            return None
        toks, lps, self.state = paged_decode_chunk(
            self.params, self.state, self.cfg, n, top_k=self.top_k,
            use_top_p=self._use_top_p, rope_len=self.max_seq,
            impl=self.attn_impl, gather_pages_w=self._gather_rung(n),
            generators=self._generators)
        self.stats["chunks"] += 1
        self.stats["lane_steps"] += n * self.n_lanes
        for lane in self.running:
            self._lengths[lane] += n
            self.alloc.note_rows(lane, min(self._lengths[lane],
                                           self.max_seq))
        return toks, lps, dict(self.running)

    def step(self) -> None:
        """Admit (every step), decode one chunk, harvest, retire."""
        self._admit_waiting()
        if not self.running:
            return
        pending = self._dispatch(self._next_chunk())
        if pending is not None:
            self._harvest(*pending)
