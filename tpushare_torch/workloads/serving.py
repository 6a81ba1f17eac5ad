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
registry lookup and its registration preamble, and the draft contract
of speculative decoding (``_validate_draft``, ``_spec_skip``,
``_spec_account``);

- the slot engine: its device programs (``init_slots``,
  ``ingest_chunk``, ``admit``, ``_install_prefix``, ``_slot_step``,
  ``slot_decode_chunk``) and ``ServingEngine`` — a fixed batch of slot
  caches (L, n_slots, rows, Hkv, hd), dense or int8 (``cfg.kv_int8``),
  the ring cache of windowed models (``ring_rows``), the ragged read
  (``cfg.ragged_decode``: the CUDA ragged-decode kernel on the card, its
  int8 rung for int8 caches), prefix caching by copy, ``sample_n``, the
  pipelined loop, and speculative rounds at single occupancy
  (``draft=``, ``spec.spec_slot_round``);
- the paged engine: its device programs (``init_page_state``,
  ``_paged_step``, ``paged_decode_chunk``, ``_paged_prefill_chunk``,
  ``_install_pages``, ``_paged_admit_commit``, ``_draft_ingest_chunk``,
  ``_spec_paged_round``) and ``PagedServingEngine`` with a bf16 or int8
  pool (``kv_codec``) on one device, ``attn_impl`` auto/paged/xla,
  page-forecast admission — pool exhaustion defers a request, a forecast
  that could never fit sheds it —, shared-prefix pages with
  copy-on-write (``register_prefix``, ``drop_prefix``, ``_cow_guard``)
  and batched speculative rounds over a draft pool whose block tables
  mirror the target's.

Both engines take the reference's weight paths: ``mm=quant.qmm`` with
an int8 parameter mirror (``quant.quantize_params``) flows to every
program the reference gives it — admission, the slot and paged steps,
prefix registration and ``sample_n`` — and composes with both KV
codecs; a MoE config (``models/moe.MoEConfig``) serves through
``decode.model_layer``, expert capacity following the chunk's width,
pads included, so under drop pressure chunked admission may drop other
tokens than the offline ``moe_decode.moe_prefill`` (the reference's
note). MoE prefixes (``ERR_PREFIX_MOE``), speculative rounds over int8
weights or MoE (``ERR_SPEC_MM``, ``ERR_SPEC_MOE``) are refused as in
the reference.

The fleet's seam (``workloads/fleet.py``): ``take_queue`` on both
engines; on the paged engine ``pool_layout``, ``extract_request`` ->
``install_request`` -> ``detach_request`` (the pages move byte for byte,
an int8 pool's ``q`` and ``s`` planes together, a sampling lane's
generator state with them), ``cancel_request``, ``can_install``,
``extract_prefix`` / ``install_prefix_pages`` (replication without a
prefill) and ``prefill_step`` (a disaggregated prefill member's
admission-only iteration).

Meshes (``parallel/mesh.Mesh``): ``PagedServingEngine(mesh=)`` over a
tp×pp serving mesh splits the pool's KV heads over tp and its layers
over pp and runs every pool-touching program shard by shard
(``workloads/sharded_pool.py``: the split model step, per-shard K5
reads, the GPipe'd chunked prefill, sharded page movers and spec
verify); host accounting stays in global pages. ``ServingEngine(mesh=)``
reads its ragged slot caches through the sharded K4 form (heads over
tp, slots over dp where they tile; each shard read in place where it
shares the caches' device); every other slot program runs on the
weights' device, as the reference's GSPMD leaves them replicated.

The reference's jitted programs become eager functions that update the
pool and the lane state IN PLACE; the host loop keeps the reference's
one device sync per decode chunk or speculative round (the harvest) and
one per admission wave. Because a chunk writes in place, a real
out-of-memory inside it (not only at its sync) leaves every running
lane's device state ahead of its host mirror: the engines quarantine
the chunk's whole snapshot then, as the reference does for an OOM at
the harvest. A copy-on-write page copy is queued before the table row
that points at the copy, on the same stream.

Step spans (``tracing.step_span``; off unless ``tracing.
start_step_spans`` or ``profiling.trace`` turned them on): each
``step()`` of either engine is one trace, ``serve.step``. Under it the
paged engine records ``serve.admit_wave`` (a wave over a non-empty
queue), one ``serve.admit`` a request popped, with its
``serve.prefill_chunk`` spans (device-timed; the real prompt
``tokens`` they carry; over a mesh one a dispatched group of chunks)
and its ``serve.page_install``, the wave's ``serve.first_tokens``,
``serve.decode_dispatch`` (``steps``; ``launched``: whether a chunk
went out) and ``serve.harvest``; the slot engine records
``serve.step``, ``serve.first_tokens`` and ``serve.harvest``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpushare_torch import consts, tracing
from tpushare_torch.workloads import overload, paging
from tpushare_torch.workloads.decode import (
    BucketOverflowError, cache_max_seq, check_paged_config,
    check_ragged_config, chunk_step, copy_pool_page, extract_request_pages,
    init_cache, init_page_pool, install_request_pages, kv_view,
    load_pool_pages, make_cached_attn_core,
    make_paged_attn_core, make_paged_chunk_core, make_ragged_attn_core,
    model_layer, pool_page_size, prefill, prefill_chunk_layout,
    scatter_scratch_pages, slot_unview, slot_view, spec_draft_scan,
    truncate_top_k, truncate_top_p)
from tpushare_torch.workloads.models.transformer import (
    TransformerConfig, embed_lookup, layer_params, lm_head, rope_freqs,
    rope_tables)
from tpushare_torch.workloads.ops.paged_attention import resolve_paged_impl
from tpushare_torch.workloads.overload import DrainTimeout  # re-export
from tpushare_torch.workloads.parallel.mesh import serving_degrees
from tpushare_torch.workloads.telemetry import EngineTelemetry

__all__ = ["init_slots", "admit", "ingest_chunk", "slot_decode_chunk",
           "init_page_state", "paged_decode_chunk", "lane_efficiency",
           "Request", "ServingEngine", "PagedServingEngine",
           "DrainTimeout"]

def params_device(params: dict) -> torch.device:
    """The device the weights live on (the embedding table, dense or an
    int8 ``{q, s}`` leaf)."""
    e = params["embed"]
    return (e["q"] if isinstance(e, dict) else e).device


def lane_efficiency(stats: dict) -> float | None:
    """Decode-lane tokens per dispatched lane-step (None with zero
    lane-steps). Each request's first token is sampled by admission,
    not by a decode lane, so one token per retired request is
    subtracted, and so are the tokens speculative rounds kept
    (``spec_emitted``): they cost no decode lane."""
    if not stats["lane_steps"]:
        return None
    decode_lane_tokens = (stats["tokens_emitted"] - stats["requests_done"]
                          - stats["spec_emitted"])
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
                 cfg: TransformerConfig, mm=None, temp: float = 0.0,
                 generator: torch.Generator | None = None, top_k: int = 0,
                 top_p: float = 0.0, use_top_p: bool = False) -> dict:
    """Run a (1, Q) token chunk through ``slot``'s cache at position
    ``start`` (``decode.chunk_step`` over the slot's view, writing in
    place) — the chunked-prefill admission primitive. Sets the slot's
    length to ``new_len``, marks it active and stores the token sampled
    at in-chunk position ``rel_last`` (only the final chunk's matters)."""
    sub = {"k": slot_view(slots["k"], slot), "v": slot_view(slots["v"], slot),
           "length": start}
    logits, _ = chunk_step(params, tokens, sub, cfg, mm=mm,
                           logit_pos=rel_last)
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
    slot_unview(slots["k"], pk, slot)
    slot_unview(slots["v"], pv, slot)
    return slots


def admit(params: dict, prompt: torch.Tensor, slots: dict, slot: int,
          plen: int, cfg: TransformerConfig, mm=None) -> dict:
    """Install a bucket-padded (1, P) prompt in ``slot``: the start=0
    case of :func:`ingest_chunk`. ``plen`` is the true prompt length;
    the causal mask keeps the pad tail out of every real position and
    decode later overwrites the pad K/V."""
    return ingest_chunk(params, prompt, slots, slot, 0, plen, plen - 1, cfg,
                        mm=mm)


def _slot_step(params: dict, slots: dict, cfg: TransformerConfig, rope,
               mm=None, top_k: int = 0, use_top_p: bool = False,
               max_len: int | None = None,
               generators: dict | None = None, mesh=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every slot, updating ``slots`` in place.
    Active slots advance one token; inactive slots compute dead lanes
    and stay put. With ``cfg.ragged_decode`` each layer reads through
    :func:`decode.make_ragged_attn_core` (the ragged kernel on the card),
    else through :func:`decode.make_cached_attn_core` with the per-slot
    position vector. ``max_len`` is the logical sequence bound (rope
    rows); it equals the cache rows except under a ring cache, whose
    core wraps the writes. ``mesh`` shards the ragged read (heads over
    tp, slots over dp). Returns (tokens, logprobs)."""
    lengths, active = slots["lengths"], slots["active"]
    max_seq = max_len or cache_max_seq(slots)
    cos_t, sin_t = rope
    cos = cos_t[lengths][:, None]                  # (B, 1, half) per row
    sin = sin_t[lengths][:, None]
    x = embed_lookup(params["embed"], slots["tokens"], cfg.dtype)[:, None]
    slot_ids = torch.arange(cache_max_seq(slots), device=lengths.device)
    for i in range(cfg.n_layers):
        if cfg.ragged_decode:
            core = make_ragged_attn_core(slots["k"], slots["v"], i, lengths,
                                         cfg, mesh=mesh)
        else:
            core = make_cached_attn_core(kv_view(slots["k"], i),
                                         kv_view(slots["v"], i), lengths,
                                         cfg, slot_ids)
        x, _ = model_layer(x, layer_params(params, i), cfg, cos, sin, core,
                           mm=mm)
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
                      n_steps: int, mm=None, top_k: int = 0,
                      use_top_p: bool = False,
                      rope_len: int | None = None,
                      generators: dict | None = None, mesh=None
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
        nxt, lp = _slot_step(params, slots, cfg, rope, mm=mm, top_k=top_k,
                             use_top_p=use_top_p, max_len=rope_len,
                             generators=generators, mesh=mesh)
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
                mm=None, top_k: int = 0, use_top_p: bool = False,
                max_len: int | None = None, impl: str = "xla",
                gather_pages_w: int | None = None,
                generators: dict | None = None, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every lane over the paged pool: active lanes
    advance one token, inactive lanes compute dead lanes into the trash
    page and stay put. Under a serving ``mesh`` the layer stack runs
    over the sharded pool (``sharded_pool.decode_layers``). Updates
    ``state`` in place; returns (tokens, logprobs)."""
    lengths, active = state["lengths"], state["active"]
    cos_t, sin_t = rope
    cos = cos_t[lengths][:, None]                  # (B, 1, half) per row
    sin = sin_t[lengths][:, None]
    x = embed_lookup(params["embed"], state["tokens"], cfg.dtype)[:, None]
    if mesh is not None:
        from tpushare_torch.workloads.sharded_pool import decode_layers
        x = decode_layers(params, state, x, cfg, cos, sin, impl, mesh,
                          gather_pages_w)
    else:
        for i in range(cfg.n_layers):
            core = make_paged_attn_core(kv_view(state["k"], i),
                                        kv_view(state["v"], i),
                                        state["tables"], lengths, cfg,
                                        impl=impl,
                                        gather_pages_w=gather_pages_w)
            x, _ = model_layer(x, layer_params(params, i), cfg, cos, sin,
                               core, mm=mm)
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
                       n_steps: int, mm=None, top_k: int = 0,
                       use_top_p: bool = False,
                       rope_len: int | None = None, impl: str = "xla",
                       gather_pages_w: int | None = None,
                       generators: dict | None = None, mesh=None
                       ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``n_steps`` decode steps for the whole lane wave (device-async; the
    caller syncs once at harvest). The engine keeps every running lane's
    table covering ``length + n_steps`` rows before dispatch. A serving
    ``mesh`` takes a sharded state (``sharded_pool.place_state``).
    Returns (tokens (B, n_steps), logprobs (B, n_steps), state)."""
    pool = state["k"] if mesh is None else state["k"][0][0]
    rope_len = rope_len or (state["tables"].shape[1] * pool_page_size(pool))
    rope = rope_tables(cfg, rope_len, state["tables"].device)
    toks, lps = [], []
    for _ in range(n_steps):
        nxt, lp = _paged_step(params, state, cfg, rope, mm=mm, top_k=top_k,
                              use_top_p=use_top_p, max_len=rope_len,
                              impl=impl, gather_pages_w=gather_pages_w,
                              generators=generators, mesh=mesh)
        toks.append(nxt)
        lps.append(lp)
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1), state


def _paged_prefill_chunk(params: dict, tokens: torch.Tensor, sk, sv,
                         start: int, rel_last: int, cfg: TransformerConfig,
                         mm=None):
    """One bucket-padded admission chunk against the lane's contiguous
    prefill scratch — exactly ``decode.chunk_step``."""
    logits, cache = chunk_step(params, tokens,
                               {"k": sk, "v": sv, "length": start}, cfg,
                               mm=mm, logit_pos=rel_last)
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


def _handoff_commit(state: dict, lane: int, table_row: torch.Tensor,
                    new_len: int, token: int, temp: float, top_p: float,
                    logp: float) -> dict:
    """Commit a handed-off request into ``lane`` once its pages landed
    (``decode.install_request_pages``), in place: table row, length,
    active flag and the live sampling state — the next input token (the
    last one emitted), temperature, top_p, last logprob. The cross-pool
    twin of :func:`_paged_admit_commit` without its sampling: the
    source engine sampled every token the host has seen. The lane's
    generator is the engine's business (``install_request``)."""
    state["tables"][lane] = table_row
    state["lengths"][lane] = new_len
    state["active"][lane] = True
    state["tokens"][lane] = token
    state["temps"][lane] = temp
    state["top_ps"][lane] = top_p
    state["logps"][lane] = logp
    return state


def _draft_ingest_chunk(dparams: dict, dstate: dict, lane: int,
                        tokens: torch.Tensor, start: int, new_len: int,
                        dcfg: TransformerConfig,
                        gather_pages_w: int | None = None) -> dict:
    """Teacher-forced ingest of one bucket-padded (1, Q) chunk into
    ``lane``'s draft pages at ``start`` — how the draft mirror acquires
    the prompt at admission and the batch-phase gap before a spec round
    (the tokens are decided; only their draft K/V is wanted, so no
    logits are computed). Writes go through
    :func:`decode.make_paged_chunk_core`, in place; pad rows land in the
    lane's own pages past its length, masked until overwritten. A stale
    mirror costs acceptance, never correctness."""
    tbl = dstate["tables"][lane:lane + 1]                      # (1, P)
    dev = tokens.device
    Q = tokens.shape[1]
    # direct per-position phases (chunk_step's rope=None branch)
    angles = ((start + torch.arange(Q, device=dev)).float()[:, None]
              * rope_freqs(dcfg, dev)[None, :])
    cos, sin = torch.cos(angles), torch.sin(angles)
    starts = torch.tensor([start], dtype=torch.int32, device=dev)
    x = embed_lookup(dparams["embed"], tokens, dcfg.dtype)
    for i in range(dcfg.n_layers):
        core = make_paged_chunk_core(kv_view(dstate["k"], i),
                                     kv_view(dstate["v"], i), tbl, starts,
                                     dcfg, gather_pages_w=gather_pages_w)
        x, _ = model_layer(x, layer_params(dparams, i), dcfg, cos, sin, core)
    dstate["lengths"][lane] = new_len
    return dstate


def _spec_paged_round(params: dict, dparams: dict, state: dict,
                      dstate: dict, cfg: TransformerConfig,
                      dcfg: TransformerConfig, k: int, rope_len: int,
                      gather_pages_w: int | None = None, mesh=None):
    """One batched draft-k / verify-1 round over the paged pools: every
    active lane drafts ``k`` greedy tokens against its draft block-table
    mirror (:func:`decode.spec_draft_scan`), then the target scores all
    lanes' (k+1)-token candidates in one multi-token paged pass
    (:func:`decode.make_paged_chunk_core`), and each lane accepts its
    longest matching prefix, capped at k-1, plus the target's own next
    token. Both reads are the plain gather, as in the reference: the
    round launches no paged kernel.

    The caller pre-grew every active lane's tables (target k+1 rows,
    draft k) behind the copy-on-write fence; rows past the accepted
    length are garbage the length mask hides until truncation releases
    their pages. Writes both pools and both lane states in place. Under
    a serving ``mesh`` the verify runs over the sharded target pool
    (``sharded_pool.verify_layers``); the draft is not split.
    Returns (g (B, k+1) target greedy tokens, logp (B, k+1), a (B,)
    accepted counts, state, dstate)."""
    lengths, active = state["lengths"], state["active"]
    dev = lengths.device
    rope_t = rope_tables(cfg, rope_len, dev)
    rope_d = rope_tables(dcfg, rope_len, dev)
    drafts, _, _ = spec_draft_scan(dparams, dstate, state["tokens"], active,
                                   dcfg, rope_d, k,
                                   gather_pages_w=gather_pages_w)
    Q = k + 1
    chunk = torch.cat([state["tokens"][:, None], drafts], dim=1)
    pos = lengths[:, None] + torch.arange(Q, device=dev)[None, :]
    cos, sin = rope_t[0][pos], rope_t[1][pos]                  # (B, Q, half)
    x = embed_lookup(params["embed"], chunk, cfg.dtype)
    if mesh is not None:
        from tpushare_torch.workloads.sharded_pool import verify_layers
        x = verify_layers(params, state, x, cfg, cos, sin, mesh,
                          gather_pages_w)
    else:
        for i in range(cfg.n_layers):
            core = make_paged_chunk_core(kv_view(state["k"], i),
                                         kv_view(state["v"], i),
                                         state["tables"], lengths, cfg,
                                         gather_pages_w=gather_pages_w)
            x, _ = model_layer(x, layer_params(params, i), cfg, cos, sin,
                               core)
    logits = lm_head(params, x)                                # (B, Q, V)
    g = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits.float(), dim=-1).gather(
        -1, g[..., None])[..., 0]
    ok = (drafts == g[:, :k]).to(torch.int32)
    acc = torch.cumprod(ok, dim=1).sum(dim=1)                  # (B,) 0..k
    a = torch.where(active, torch.clamp(acc, max=k - 1),
                    torch.zeros_like(acc))
    new_len = torch.where(active, lengths + a + 1, lengths).to(torch.int32)
    nxt = g.gather(1, a[:, None])[:, 0]
    nlp = logp.gather(1, a[:, None])[:, 0]
    state["lengths"] = new_len
    state["tokens"] = torch.where(active, nxt, state["tokens"])
    state["logps"] = torch.where(active, nlp, state["logps"])
    dstate["lengths"] = torch.where(active, new_len, dstate["lengths"])
    return g, logp, a, state, dstate


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
                   chunk: int, mm, seed: int, top_k: int,
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
        # mm: the weight path (quant.qmm over an int8 parameter mirror)
        self.params, self.cfg, self.mm = params, cfg, mm
        self.device = params_device(params)
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
                      "spec_rounds": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_emitted": 0,
                      "spec_rounds_skipped": {},
                      "completed": 0, "shed": 0, "deadline_exceeded": 0,
                      "oom_quarantined": 0, "oom_recoveries": 0}
        # speculative decoding, shared by both engines: the (params_d,
        # cfg_d, k) draft and the per-lane draft-cache length mirror (the
        # batched chunk path advances only the target cache, so a lane's
        # draft catches up on the tokens decoded since before a round)
        self.draft: tuple | None = None
        self._dlengths: dict[int, int] = {}
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

    def _validate_prefix_registration(self, name: str,
                                      tokens: list) -> int:
        """The register_prefix preamble of both engines (one set of
        guards): dense only, no re-registration — queued requests were
        checked against the old length —, length inside [1, max_seq).
        Returns the prefix length."""
        plen = len(tokens)
        if hasattr(self.cfg, "n_experts"):
            raise NotImplementedError(consts.ERR_PREFIX_MOE)
        if name in self.prefixes:
            raise ValueError(f"prefix {name!r} already registered")
        if plen < 1 or plen >= self.max_seq:
            raise ValueError(f"prefix length {plen} outside [1, max_seq)")
        return plen

    def _validate_draft(self, draft: tuple | None) -> None:
        """The draft-config contract both engines run at construction
        (``consts.ERR_SPEC_*``); engine-specific floors (the slot ring's
        windowed-draft bound, the pool's ``check_paged_config``) follow in
        each constructor."""
        if draft is None:
            return
        _dparams, dcfg, dk = draft
        if self.mm is not None:
            raise ValueError(consts.ERR_SPEC_MM)
        if hasattr(self.cfg, "n_experts") or hasattr(dcfg, "n_experts"):
            raise ValueError(consts.ERR_SPEC_MOE)
        if dk < 2:
            raise ValueError(consts.ERR_SPEC_K_FMT.format(k=dk))
        if dcfg.vocab != self.cfg.vocab:
            raise ValueError(consts.ERR_SPEC_VOCAB)

    def _spec_skip(self, reason: str) -> None:
        """Count one skipped speculative round by reason: a quiet spec
        path must be explainable, never silent."""
        skipped = self.stats["spec_rounds_skipped"]
        skipped[reason] = skipped.get(reason, 0) + 1

    def _spec_account(self, lane: int, g, logp, a: int, k: int) -> int:
        """Greedy accept/reject accounting for one lane's draft-k /
        verify-1 round: count the round, credit the accepted prefix plus
        the target's own next token to the lane's request (stopping at
        eos / max_new, which retires it), publish the spec counters, and
        apply the deadline check at the round boundary (a spec round
        never passes through ``_harvest``). The caller has advanced the
        lengths; returns the tokens kept."""
        req = self.running[lane]
        self.stats["spec_rounds"] += 1
        self.stats["spec_drafted"] += k
        self.stats["spec_accepted"] += a
        if req._trace is not None:
            req._trace.bump("spec_rounds")
        kept = 0
        for t, lp in zip(g[:a + 1], logp[:a + 1]):
            req.output.append(int(t))
            req.logprobs.append(float(lp))
            kept += 1
            # the tokens kept (a round cut by eos / max_new keeps fewer
            # than a+1), so lane_efficiency's subtraction matches
            self.stats["spec_emitted"] += 1
            if ((req.eos is not None and int(t) == req.eos)
                    or len(req.output) >= req.max_new):
                self._retire(lane)
                break
        self.telemetry.set_spec_stats(
            self.stats["spec_rounds"], self.stats["spec_drafted"],
            self.stats["spec_accepted"], self.stats["spec_emitted"])
        if (self.running.get(lane) is req and req._deadline is not None
                and time.monotonic() >= req._deadline):
            self._retire(lane, status=overload.STATUS_DEADLINE_EXCEEDED)
        return kept

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

    def take_queue(self) -> list[Request]:
        """Remove and return every queued (never admitted) request — the
        fleet router's re-route hook when it drains or evacuates a
        member. The requests stay live (no terminal status: the router
        owes them a resubmit elsewhere), so telemetry releases their
        queue slots without counting a shed. Running lanes are not
        touched."""
        taken, self.queue = self.queue, []
        for req in taken:
            self.telemetry.requeued(id(req))
        return taken

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
        self.stats = {k: ({} if isinstance(v, dict) else 0)
                      for k, v in self.stats.items()}
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
        with tracing.step_span("serve.first_tokens"):
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

    def _host_read(self, *tensors: torch.Tensor) -> tuple[list, ...]:
        """The harvest's blocking device read (the engine's one sync per
        decode chunk or paged speculative round), under the watchdog when
        one is armed. The read may run on the watchdog's thread, whose
        current device and stream are its own: it reads on the engine's
        device and the stream the chunk was queued on."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def read():
            self._fire_fault("sync")
            if stream is None:
                return tuple(t.tolist() for t in tensors)
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                return tuple(t.tolist() for t in tensors)

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
        with tracing.step_span("serve.harvest"):
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
            # dispatch -> harvest wall over the chunk's steps: the
            # per-token decode latency a caller sees
            if t0 is not None:
                self.telemetry.decode_chunk(n_steps, time.monotonic() - t0,
                                            kept)
            now = time.monotonic()
            for lane, req in list(self.running.items()):
                if req._deadline is not None and now >= req._deadline:
                    self._retire(lane,
                                 status=overload.STATUS_DEADLINE_EXCEEDED)
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

    ``draft=(params_d, cfg_d, k)``: at single occupancy with a greedy,
    prefix-free request the engine decodes through speculative rounds
    (``spec.spec_slot_round``: draft k tokens, verify them in one target
    chunk) over a draft slot cache mirrored at admission; above one
    running request, for a sampling request or without k+1 rows of
    headroom it runs the normal chunk. Not with ``pipeline=True``; under
    a ring cache the draft must be windowed with the same floor. The
    rounds read the target through ``chunk_step``'s cached read (the
    offset flash kernel for a bf16 cache on the card, else the einsum),
    also under ``cfg.ragged_decode``: exact in f32, bf16 near-ties may
    break differently across the two reads.

    ``mm=quant.qmm`` with ``quant.quantize_params``' int8 mirror serves
    int8 weights on every program above (not with ``draft``: the
    reference's ``ERR_SPEC_MM``). A ``MoEConfig`` serves its experts
    through ``decode.model_layer``; prefixes and drafts are dense-only.

    ``mesh`` (a ``parallel/mesh.Mesh`` with ``tp`` and optionally
    ``dp`` axes) shards the ragged read under ``cfg.ragged_decode``:
    each (dp, tp) shard's slots and heads are read by K4 on its device
    — in place when that is the caches' device, else from a copy — and
    the outputs concatenated in rank order
    (``registry._build_decode_ragged``); a mesh whose tp does not tile
    the heads is refused at construction. The other slot programs run on
    the weights' device, as the reference's GSPMD keeps them replicated.
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
        self._init_core(params, cfg, n_slots, max_seq, prompt_buckets,
                        chunk, mm, seed, top_k, queue_limit, reject_policy,
                        default_deadline_s, admission, faults,
                        sync_timeout_s)
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
        self.mesh = mesh
        if cfg.ragged_decode:
            check_ragged_config(cfg, self.cache_rows, mesh=mesh)
        # which read this engine serves with (the registry forbids a
        # silent swap: an explicit ragged read raises or runs)
        self.attn_impl = "ragged" if cfg.ragged_decode else "xla"
        self.slots = init_slots(cfg, n_slots, self.cache_rows, self.device)
        self.pipeline = pipeline
        self._validate_draft(draft)
        self.draft = draft
        self.dslots = None
        if draft is not None:
            _dparams, dcfg, dk = draft
            if pipeline:
                # the pipelined loop dispatches chunks and never consults
                # the spec path: the draft prefill would buy nothing
                raise ValueError(consts.ERR_SPEC_PIPELINE)
            if self.cache_rows < max_seq:
                if self.cache_rows < cfg.attn_window + dk + 1:
                    # a verify chunk of k+1 must never wrap its own band
                    raise ValueError(
                        f"ring cache rows {self.cache_rows} < attn_window"
                        f" + k + 1 ({cfg.attn_window + dk + 1})")
                # the draft cache shares the ring rows, so the draft must
                # be windowed with the same exactness floor
                dfloor = ((dcfg.attn_window or 0)
                          + max(max(self.buckets), dk + 1))
                if dcfg.attn_window is None or self.cache_rows < dfloor:
                    raise ValueError(
                        f"ring cache needs a windowed draft with rows >= "
                        f"window + max(bucket, k+1) (rows "
                        f"{self.cache_rows}, draft window "
                        f"{dcfg.attn_window})")
            self.dslots = init_slots(dcfg, n_slots, self.cache_rows,
                                     self.device)
            # zero counters from construction: "spec armed but quiet" is
            # distinguishable from no spec at all
            self.telemetry.set_spec_stats(0, 0, 0, 0)
        # per-slot forecast charge (MiB) backing the admission HBM gate
        self._charged_mib: dict[int, float] = {}

    def register_prefix(self, name: str, tokens: list) -> None:
        """Prefill ``tokens`` once and keep the K/V; requests naming this
        prefix get it copied into their slot instead of recomputed. Every
        subscriber still holds its own copy of the prefix rows
        (``PagedServingEngine`` shares the pages instead)."""
        plen = self._validate_prefix_registration(name, tokens)
        if plen >= self.cache_rows:
            raise ValueError(f"prefix length {plen} exceeds the ring "
                             f"cache rows {self.cache_rows}")
        cache = init_cache(self.cfg, 1, plen, device=self.device)
        _, cache = prefill(self.params,
                           torch.tensor([tokens], device=self.device),
                           self.cfg, cache, mm=self.mm)
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
                                 self.cfg, mm=self.mm, temp=req.temperature,
                                 generator=gen, top_k=self.top_k,
                                 top_p=req.top_p, use_top_p=self._use_top_p)
                    self.stats["prefill_chunks"] += 1
                    self.telemetry.prefill_chunk(padded_len)
                    if req._trace is not None:
                        req._trace.bump("prefill_chunks")
                    if (self.dslots is not None and req.prefix is None
                            and req.temperature == 0):
                        # mirror the prompt into the draft cache so a spec
                        # round verifies against the same history (prefix
                        # and sampling requests never take a round)
                        dparams, dcfg, _ = self.draft
                        ingest_chunk(dparams, arr, self.dslots, slot,
                                     off + start, off + start + piece,
                                     piece - 1, dcfg)
                        self._dlengths[slot] = off + start + piece
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
        # bucket costs rows the direct chunked prefill would not) and the
        # model is dense (prefixes are)
        off = len(prompt) - 1
        share = (last_token_suffix and len(prompt) > 1
                 and not hasattr(self.cfg, "n_experts")
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
        """Retire-time cleanup: drop the slot's generator, draft mirror
        and HBM charge, deactivate the slot on the device."""
        self._generators.pop(slot, None)
        self._dlengths.pop(slot, None)
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
            self.params, self.slots, self.cfg, n, mm=self.mm,
            top_k=self.top_k,
            use_top_p=self._use_top_p, rope_len=self.max_seq,
            generators=self._generators, mesh=self.mesh), snapshot)
        if out is None:
            return None
        toks, lps, self.slots = out
        self.stats["chunks"] += 1
        self.stats["lane_steps"] += n * self.n_slots
        for slot in self.running:
            self._lengths[slot] += n
        return toks, lps, snapshot, t0, n

    def _spec_slot(self) -> int | None:
        """The slot a speculative round may run on, or None: exactly one
        greedy, prefix-free, mirrored request live, nothing queued, and
        k+1 rows of headroom. Above one request the slot batch already
        amortizes the weight read, so the chunk path wins."""
        if self.draft is None or len(self.running) != 1 or self.queue:
            return None
        slot, req = next(iter(self.running.items()))
        k = self.draft[2]
        if (req.temperature != 0 or req.prefix is not None
                or slot not in self._dlengths
                or self._lengths[slot] + k + 1 > self.max_seq):
            return None
        return slot

    def _spec_catchup(self, slot: int) -> None:
        """Bring the draft cache up to the target length before a round:
        the batched chunk path advances only the target cache, and
        drafting over unwritten rows would collapse acceptance. Every
        missing token is in ``req.output``; the gap re-ingests through
        the admission's bucket-padded chunks."""
        L, dL = self._lengths[slot], self._dlengths[slot]
        if dL >= L:
            return
        req = self.running[slot]
        plen = len(req.prompt)
        # positions plen..L-1 hold output[0..L-plen-1]
        gap = req.output[dL - plen:L - plen]
        dparams, dcfg, _ = self.draft
        for start, piece, padded_len in self._prefill_chunks(len(gap)):
            arr = torch.zeros((1, padded_len), dtype=torch.int64,
                              device=self.device)
            arr[0, :piece] = torch.tensor(gap[start:start + piece],
                                          dtype=torch.int64)
            ingest_chunk(dparams, arr, self.dslots, slot, dL + start,
                         dL + start + piece, piece - 1, dcfg)
        self._dlengths[slot] = L

    def _spec_round(self, slot: int) -> None:
        """One draft-k / verify-1 round on ``slot``
        (``spec.spec_slot_round``); credit the accepted prefix plus the
        target's own next token."""
        from tpushare_torch.workloads.spec import spec_slot_round
        self._spec_catchup(slot)
        dparams, dcfg, k = self.draft
        t0 = time.monotonic()
        g, logp, a, self.slots, self.dslots = spec_slot_round(
            self.params, dparams, self.slots, self.dslots, slot, self.cfg,
            dcfg, k, length=self._lengths[slot])
        # one read per round: the accepted count decides what the host
        # may emit before the next round
        g, logp, a = g.tolist(), logp.tolist(), int(a)
        self._lengths[slot] += a + 1
        self._dlengths[slot] = self._lengths[slot]
        kept = self._spec_account(slot, g, logp, a, k)
        # a round emits a+1 tokens in one draft + verify span
        self.telemetry.decode_chunk(a + 1, time.monotonic() - t0, kept)

    def step(self) -> None:
        """Admit, decode one chunk (or one speculative round), retire
        finished requests. An out-of-memory at dispatch (before the chunk
        runs) costs one heuristic victim; one at the harvest, or inside
        the chunk, the chunk's whole snapshot. A round runs at single
        occupancy, so its one request is the victim either way."""
        with tracing.step_span("serve.step", root=True):
            self._admit_waiting()
            if not self.running:
                if self.queue:
                    # admission deferred everything with nothing in
                    # flight: yield so run()'s bound spans real time
                    time.sleep(0.01)
                return
            slot = self._spec_slot()
            if slot is not None:
                try:
                    self._spec_round(slot)
                except Exception as e:
                    if not overload.is_resource_exhausted(e):
                        raise
                    self._recover_dispatch_oom()
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

    Shared-prefix pages: ``register_prefix`` prefills a system prompt
    once into pinned pool pages; a request naming it gets the prefix's
    full pages spliced into its block table by reference
    (``PageAllocator.share``), so N subscribers hold one physical copy,
    and admission charges them only their private pages
    (``paging.forecast_subscriber_pages``). Writes are fenced by
    copy-on-write at the page boundary: the prefix's partial tail page
    is materialized privately with the suffix install, and a decode
    write that would touch a still-shared page first copies it into a
    private page and swaps the table entry (``_cow_guard``).

    ``kv_codec`` is the pool's storage format (``consts.KV_CODECS``):
    "bf16" stores the model dtype; "int8" stores each of K/V as ``{"q":
    int8 pages, "s": fp32 per-(row, head) scales}``, quantized at page
    install and at every decode write, dequantized at every read — about
    half the bytes per page (``paging.kv_bytes_per_el``), so equal pool
    HBM buys about twice the pages and admits deeper concurrency under
    the same admission math. ``cfg.kv_int8`` (the slot cache's knob) is
    refused: the admission scratch is dense and the pool owns the codec.
    Pinned prefix pages are quantized once at registration; a CoW clone
    copies ``q`` and ``s`` byte for byte; a subscriber's private
    prefix-tail page goes through the dense admission scratch and is
    quantized again, so its prefix rows may differ from the registration
    by one quantization step (the reference's rule).

    ``attn_impl``: "paged" reads through the CUDA paged-decode kernel
    (its int8 rung for an int8 pool), "xla" through the gather twin,
    "auto" picks the kernel where the pool lives on a CUDA device
    (counted fallback otherwise). Both read tables whose prefix entries
    alias across lanes.

    ``draft=(params_d, cfg_d, k)`` arms batched speculative rounds: the
    draft model runs over its own page pool, whose per-lane block
    tables mirror the target's (the prompt ingested at admission, prefix
    registrations pinned in both pools, batch-phase gaps caught up
    before a round). When every running lane is greedy, mirrored and has
    k+1 rows of headroom, and no queued request could join now, one
    round drafts k tokens for all lanes and verifies them in one
    multi-token pass (``_spec_paged_round``, plain gather reads); a
    rejected tail is a block-table truncation and a page release in
    both allocators. The page forecast grows by the round's k+1-row
    tail; rounds that cannot fire are counted by reason
    (``stats["spec_rounds_skipped"]``).

    ``mm`` and a ``MoEConfig`` as the slot engine's: int8 weights on
    admission, decode steps and prefix registration, with either pool
    codec; MoE layers through ``decode.model_layer`` (the kernel read
    serves their attention as it does a dense model's).

    Overload defense as the slot engine's; the admission controller's
    gate here is pages (``AdmissionController.admit_ok_pages``: the
    forecast against the free pool net of promised growth).

    ``mesh`` (``parallel/mesh.make_serving_mesh(tp, pp)``) with tp*pp > 1
    shards the engine: the weights are placed by
    ``mesh.place_serving_params``, the pool splits its KV heads over tp
    and its layers over pp, and every program that touches the pool runs
    through ``workloads/sharded_pool.py`` — per-shard K5 reads, the
    GPipe'd chunked prefill (prefix registrations too), sharded page
    install / load / copy, the sharded verify of a speculative round
    (the draft stays whole), handoff records split like the pool.
    Admission, the allocator, prefixes and rounds keep counting global
    pages; the telemetry reports the mesh degrees and the pool's bytes
    per shard, and a handoff only lands in a pool of the same layout,
    mesh included. int8 weights (``mm``) and MoE configs are refused
    under a mesh, as in the reference.
    """

    # the fleet router catches ``eng._paging.PagePoolExhausted`` around a
    # prefix replication, on local and remote members alike
    _paging = paging

    def __init__(self, params: dict, cfg: TransformerConfig, n_lanes: int,
                 max_seq: int, n_pages: int, page_size: int = 32,
                 prompt_buckets: tuple[int, ...] = (32, 128),
                 chunk: int = 8, mm=None, seed: int = 0, top_k: int = 0,
                 attn_impl: str = "auto", kv_codec: str = "bf16",
                 draft: tuple | None = None, mesh=None,
                 decode_forecast_fraction: float = 1.0,
                 queue_limit: int | None = None,
                 reject_policy: str = overload.REJECT_NEW,
                 default_deadline_s: float | None = None,
                 admission: overload.AdmissionController | None = None,
                 faults=None, sync_timeout_s: float | None = None):
        check_paged_config(cfg, mesh=mesh, kv_codec=kv_codec)
        self.mesh = mesh
        self._tp, self._pp = serving_degrees(mesh)
        self._shards = self._tp * self._pp
        self._sharded = self._shards > 1
        if self._sharded:
            if mm is not None:
                raise ValueError(
                    "sharded serving uses the plain weight path "
                    "(mm=None): int8 WEIGHTS under the fully-manual "
                    "mesh step are a ROADMAP follow-up")
            if hasattr(cfg, "n_experts"):
                raise NotImplementedError(
                    "sharded serving is dense-only: the manual mesh "
                    "step has no MoE layer body yet")
            from tpushare_torch.workloads import sharded_pool
            from tpushare_torch.workloads.parallel.mesh import (
                place_serving_params)
            self._shp = sharded_pool
            params = place_serving_params(params, mesh)
        self._init_core(params, cfg, n_lanes, max_seq, prompt_buckets,
                        chunk, mm, seed, top_k, queue_limit, reject_policy,
                        default_deadline_s, admission, faults,
                        sync_timeout_s)
        self.n_lanes = n_lanes
        self.kv_codec = kv_codec
        self.attn_impl = resolve_paged_impl(attn_impl, self.device.type,
                                            kv_codec)
        self.alloc = paging.PageAllocator(n_pages, page_size, reserved=1)
        # the pool's HBM under its codec (all shards), and one row's
        # bytes and the pool per shard: riders on every telemetry snapshot
        self.pool_mib = paging.pool_hbm_mib(n_pages, page_size, cfg.n_layers,
                                            cfg.kv_heads, cfg.head_dim,
                                            kv_codec)
        self.telemetry.set_kv_codec(kv_codec, paging.kv_bytes_per_token(
            cfg.n_layers, cfg.kv_heads, cfg.head_dim, kv_codec,
            shards=self._shards))
        self.telemetry.set_pool_shard_mib(paging.pool_hbm_mib(
            n_pages, page_size, cfg.n_layers, cfg.kv_heads, cfg.head_dim,
            kv_codec, shards=self._shards))
        if self._sharded:
            # the mesh degrees ride sharded engines' snapshots only
            self.telemetry.set_mesh(self._tp, self._pp)
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
        if self._sharded:
            # pool leaves split (layers over pp, KV heads over tp); the
            # lane state stays whole on the mesh's first device
            self.state = self._shp.place_state(self.state, mesh, kv_codec)
        # forecast charges backing the admission gate
        self._charged_pages: dict[int, int] = {}
        # shared-prefix registry: name -> (token length, pinned page ids),
        # allocated under the pin owner until drop_prefix
        self.prefixes: dict[str, tuple[int, list[int]]] = {}
        self.stats["page_evictions"] = 0
        self.stats["peak_running"] = 0
        self.stats["peak_shared_pages"] = 0
        self.stats["prefix_hits"] = 0
        self.stats["cow_copies"] = 0
        self.stats["handoffs_out"] = 0
        self.stats["handoffs_in"] = 0
        # speculative decoding: the draft model's own pool and allocator,
        # per-lane block tables mirroring the target lanes
        self._validate_draft(draft)
        self.draft = draft
        self._dalloc: paging.PageAllocator | None = None
        self.dstate: dict | None = None
        # the draft half of the prefix registry: name -> (token length,
        # pinned draft page ids, the partial tail page's tokens a
        # subscriber re-ingests privately — the splice shares full pages)
        self._dprefixes: dict[str, tuple[int, list[int], list[int]]] = {}
        if draft is not None:
            _dparams, dcfg, _dk = draft
            # the draft pool passes the same config gate as the target's;
            # a sharded engine keeps the draft whole, so it owes the mesh
            # no tiling
            check_paged_config(dcfg, kv_codec=kv_codec)
            self._dalloc = paging.PageAllocator(n_pages, page_size,
                                                reserved=1)
            page_state = init_page_state(dcfg, n_lanes,
                                         self.max_pages_per_lane,
                                         self.device)
            self.dstate = {**init_page_pool(dcfg, n_pages, page_size,
                                            kv_codec=kv_codec,
                                            device=self.device),
                           "tables": page_state["tables"],
                           "lengths": page_state["lengths"]}
            if self._sharded:
                self.dstate = self._shp.replicate(self.dstate, mesh)
            self.telemetry.set_spec_stats(0, 0, 0, 0)
        self._publish_pages()

    # ---- shared-prefix registry ---------------------------------------

    @staticmethod
    def _prefix_owner(name: str) -> tuple:
        """The allocator owner pinning a registration's pages (never a
        lane index, so no admission can collide with it)."""
        return ("__prefix__", name)

    def register_prefix(self, name: str, tokens: list) -> None:
        """Prefill ``tokens`` once into pinned pool pages; every request
        naming this prefix gets those page ids spliced into its block
        table by reference instead of recomputing or copying the prefix.
        On the card the prefill runs the flash forward (K1), on a
        sharded engine at each shard's heads
        (``sharded_pool.sharded_prefill``). Raises ``PagePoolExhausted``
        when the pool cannot hold it."""
        plen = self._validate_prefix_registration(name, tokens)
        owner = self._prefix_owner(name)
        ids = self.alloc.ensure(owner, plen)
        try:
            rows = paging.page_rounded_rows(plen, self.alloc.page_size)
            cache = init_cache(self.cfg, 1, rows, device=self.device)
            # the install quantizes a dense scratch into the pool codec; a
            # {q, s} scratch means cfg grew kv_int8 after construction
            if isinstance(cache["k"], dict):
                raise ValueError(consts.ERR_KV_CODEC_MISMATCH_FMT.format(
                    pool=self.kv_codec, cache="int8 (cfg.kv_int8)"))
            if self._sharded:
                sk, sv = self._shp.place_scratch(cache["k"], cache["v"],
                                                 self.mesh)
                sk, sv = self._shp.sharded_prefill(
                    self.params, torch.tensor([tokens], device=self.device),
                    sk, sv, self.cfg, mesh=self.mesh)
            else:
                _, cache = prefill(self.params,
                                   torch.tensor([tokens], device=self.device),
                                   self.cfg, cache, mm=self.mm)
                sk, sv = cache["k"], cache["v"]
            self._install_scratch(sk, sv, self._ids(ids))
        except Exception:
            self.alloc.release(owner)
            raise
        if self.draft is not None:
            try:
                # all or nothing across the two pools: subscribers must
                # never draft over an unwritten prefix
                self._register_draft_prefix(name, tokens, plen)
            except Exception:
                self.alloc.release(owner)
                raise
        self.prefixes[name] = (plen, list(ids))
        self._publish_pages()

    def _register_draft_prefix(self, name: str, tokens: list,
                               plen: int) -> None:
        """Mirror a registration into the draft pool: prefill once with
        the draft model, pin the pages under the draft pin owner, and
        keep the partial tail page's tokens (subscribers re-ingest them
        privately)."""
        dparams, dcfg, _ = self.draft
        owner = ("__dprefix__", name)
        ids = self._dalloc.ensure(owner, plen)
        ps = self._dalloc.page_size
        try:
            cache = init_cache(dcfg, 1, paging.page_rounded_rows(plen, ps),
                               device=self.device)
            _, cache = prefill(dparams,
                               torch.tensor([tokens], device=self.device),
                               dcfg, cache)
            _install_pages(self.dstate["k"], self.dstate["v"], cache["k"],
                           cache["v"], self._ids(ids))
        except Exception:
            self._dalloc.release(owner)
            raise
        self._dprefixes[name] = (plen, list(ids),
                                 list(tokens[(plen // ps) * ps:]))

    def drop_prefix(self, name: str) -> None:
        """Unpin a registration: its pages recycle once the last live
        subscriber releases them. Queued requests naming it are shed
        terminally (they could never admit again); in-flight subscribers
        keep the shared pages alive through their own references."""
        if name not in self.prefixes:
            raise ValueError(consts.ERR_PREFIX_UNKNOWN_FMT.format(name=name))
        del self.prefixes[name]
        keep: list[Request] = []
        for q in self.queue:
            if q.prefix == name:
                self._shed_request(q)
            else:
                keep.append(q)
        self.queue = keep
        self.alloc.release(self._prefix_owner(name))
        if self._dprefixes.pop(name, None) is not None:
            self._dalloc.release(("__dprefix__", name))
        self._publish_pages()

    # ---- cross-pool handoff (the fleet's seam) -------------------------

    @staticmethod
    def _layout_str(codec: str, page_size: int, tp: int = 1,
                    pp: int = 1) -> str:
        base = f"{codec}/{page_size}r"
        if tp * pp > 1:
            base += f"/tp{tp}xpp{pp}"
        return base

    @property
    def pool_layout(self) -> str:
        """What a byte-exact handoff needs both pools to share: the
        storage codec, the rows per page and a sharded pool's mesh
        degrees (its records come out split like the pool)."""
        return self._layout_str(self.kv_codec, self.alloc.page_size,
                                self._tp, self._pp)

    def _check_handoff_layout(self, record: dict) -> None:
        theirs = self._layout_str(record["kv_codec"], record["page_size"],
                                  record.get("mesh_tp", 1),
                                  record.get("mesh_pp", 1))
        if theirs != self.pool_layout:
            raise ValueError(consts.ERR_HANDOFF_POOL_FMT.format(
                src=theirs, dst=self.pool_layout))

    def extract_request(self, lane: int) -> dict:
        """Gather a running request's live pages and lane state into a
        handoff record another engine's :meth:`install_request` takes —
        the read half of disaggregation and of a member's salvage. Read
        only: the lane keeps serving here until :meth:`detach_request`,
        so a failed install elsewhere loses nothing. Only the pages
        covering the live length travel. A sampling lane's generator
        state rides along (``torch.Generator.get_state()``, a CPU byte
        tensor), so its stream continues where it stopped."""
        req = self.running[lane]
        length = self._lengths[lane]
        keep = paging.pages_for_rows(length, self.alloc.page_size)
        pk, pv = self._extract_pages(
            self._ids(self.alloc.table(lane)[:keep]))
        gen = self._generators.get(lane)
        return {"req": req, "length": length, "k": pk, "v": pv,
                "generator": None if gen is None else gen.get_state(),
                "kv_codec": self.kv_codec,
                "page_size": self.alloc.page_size,
                "mesh_tp": self._tp, "mesh_pp": self._pp}

    def detach_request(self, lane: int) -> Request:
        """Release a lane whose request now runs elsewhere (its pages
        were installed into another pool): pages recycle, the table row
        zeroes, and no terminal accounting lands here — the request's
        one terminal status lands on the destination."""
        req = self.running.pop(lane)
        self._lengths.pop(lane, None)
        self.stats["handoffs_out"] += 1
        self._scrub_lane(lane)
        return req

    def cancel_request(self, lane: int) -> Request:
        """Release a lane whose request will be admitted again from
        scratch elsewhere (the fleet's hedged replay, or the release of
        a lane that cannot be salvaged): pages recycle, and neither a
        terminal nor a handoff is counted — the request stays live;
        only its pending TTFT entry is dropped, so a replay restarts the
        clock."""
        req = self.running.pop(lane)
        self._lengths.pop(lane, None)
        self.telemetry.cancelled(id(req))
        self._scrub_lane(lane)
        return req

    def can_install(self, rows: int, left: int) -> bool:
        """Host-side feasibility probe for :meth:`install_request` — a
        free lane, and the page forecast of a request holding ``rows``
        with ``left`` tokens still to decode within the free pool net of
        the growth promised to running lanes — asked before the router
        pays an extract (a gather on the card, a copy across the wire).
        Advisory: the install re-checks."""
        if len(self.running) >= self.n_lanes:
            return False
        return (self._handoff_charge(rows, left)
                <= self.alloc.free_pages() - self._reserved_growth())

    def _handoff_charge(self, rows: int, left: int) -> int:
        """A handed-off request's page forecast: its rows, a chunk's
        look-ahead (a dispatch grows the table over the chunk's rows)
        and the decode growth still to come (the draft's round tail on a
        drafted engine) — the admission gate's charging rule."""
        tail = (self.draft[2] + 1) if self.draft is not None else 0
        return paging.forecast_request_pages(
            rows + self.chunk - 1, left, self.alloc.page_size,
            self.max_seq, self.decode_forecast_fraction, tail)

    def install_request(self, record: dict) -> int | None:
        """Admit a handed-off request into this pool: reserve pages
        (``PageAllocator.begin_install``), write the migrated bytes in
        place (``decode.install_request_pages``), commit the lane.
        Returns the lane, or None when no lane or pages are free, when
        the request's page forecast (its rows and the decode growth still
        to come) exceeds the free pool net of the growth promised to
        running lanes — the admission gate's rule, which the reference's
        install skips and then over-commits the pool —, or when the copy
        ran out of memory: a load condition the router retries;
        the source lane is untouched either way. The ``install`` fault
        fires between reserve and copy; any failure there aborts the
        reservation, and since the table row is written only after the
        commit, no reader ever sees a reserved page. The pages install
        private here even where the source lane shared prefix pages. A
        sampling request's generator takes the carried state (never a
        fresh seed: the engine's admission count stays as it was). On a
        drafted engine a greedy request builds its draft mirror from the
        host's tokens."""
        self._check_handoff_layout(record)
        req, length = record["req"], int(record["length"])
        if not req.output:
            raise ValueError("install_request of a request that never "
                             "admitted (no sampled token to resume from)")
        remaining = max(0, req.max_new - len(req.output))
        if length + remaining > self.max_seq:
            raise ValueError(f"handoff length {length} + {remaining} "
                             f"remaining tokens does not fit max_seq "
                             f"{self.max_seq}")
        free = [i for i in range(self.n_lanes) if i not in self.running]
        if not free:
            return None
        charge = self._handoff_charge(length, remaining)
        if charge > self.alloc.free_pages() - self._reserved_growth():
            # its decode growth is room already promised to running
            # lanes: admitting it would over-commit the pool (a later
            # eviction), so the request waits where it is
            return None
        lane = free[0]
        try:
            ids = self.alloc.begin_install(lane, length)
        except paging.PagePoolExhausted:
            return None
        try:
            self._fire_fault("install")
            self._install_record_pages(record, self._ids(ids))
        except Exception as e:
            self.alloc.abort_install(ids)
            if overload.is_resource_exhausted(e):
                return None
            raise
        self.alloc.commit_install(lane, ids, length)
        _handoff_commit(self.state, lane, self._table_row(self.alloc, lane),
                        length, req.output[-1], req.temperature, req.top_p,
                        req.logprobs[-1])
        if req.temperature > 0 and record.get("generator") is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(record["generator"])
            self._generators[lane] = gen
        if req.top_p > 0:
            self._use_top_p = True
        self.running[lane] = req
        self._lengths[lane] = length
        self._charged_pages[lane] = charge
        self.stats["handoffs_in"] += 1
        self.stats["peak_running"] = max(self.stats["peak_running"],
                                         len(self.running))
        if req.prefix is None:
            # the prompt now, the output gap through the usual catch-up
            self._mirror_admit(lane, req, 0, len(req.prompt))
        self._publish_pages()
        return lane

    def extract_prefix(self, name: str) -> dict:
        """Gather a registration's pinned pages into a handoff record —
        the read half of hot-prefix replication. The source
        registration, its pins and its subscribers are only read."""
        if name not in self.prefixes:
            raise ValueError(consts.ERR_PREFIX_UNKNOWN_FMT.format(name=name))
        plen, ids = self.prefixes[name]
        pk, pv = self._extract_pages(self._ids(ids))
        return {"plen": plen, "k": pk, "v": pv, "kv_codec": self.kv_codec,
                "page_size": self.alloc.page_size,
                "mesh_tp": self._tp, "mesh_pp": self._pp}

    def install_prefix_pages(self, name: str, tokens: list,
                             record: dict) -> None:
        """Register ``name`` here from another engine's extracted pins:
        the same pages byte for byte, no prefill (no K1 launch), under
        ``register_prefix``'s guards, all or nothing. A drafted engine
        prefills the draft half with the draft model, as
        ``register_prefix`` does."""
        self._check_handoff_layout(record)
        plen = self._validate_prefix_registration(name, tokens)
        if plen != int(record["plen"]):
            raise ValueError(f"prefix {name!r} tokens ({plen}) do not "
                             f"match the extracted registration "
                             f"({record['plen']})")
        owner = self._prefix_owner(name)
        ids = self.alloc.begin_install(owner, plen)
        try:
            self._install_record_pages(record, self._ids(ids))
        except Exception:
            self.alloc.abort_install(ids)
            raise
        self.alloc.commit_install(owner, ids, plen)
        if self.draft is not None:
            try:
                self._register_draft_prefix(name, tokens, plen)
            except Exception:
                self.alloc.release(owner)
                raise
        self.prefixes[name] = (plen, list(ids))
        self._publish_pages()

    def prefill_step(self) -> None:
        """One admission-only iteration — a disaggregated fleet's
        prefill member: admit, chunked prefill, first-token sample, and
        never a decode dispatch (no K5 launch). The router hands each
        admitted request into a decode member's pool and lane."""
        self._admit_waiting()

    # ---- page accounting ----------------------------------------------

    def _ids(self, ids: list[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    # ---- pool data movers: unsharded, or shard by shard ---------------

    def _install_scratch(self, sk, sv, ids: torch.Tensor,
                         skip_pages: int = 0) -> None:
        """A finished prefill scratch into pages ``ids`` of the pool."""
        if self._sharded:
            self._shp.sharded_install_pages(
                self.state["k"], self.state["v"], sk, sv, ids,
                skip_pages=skip_pages, mesh=self.mesh)
        else:
            _install_pages(self.state["k"], self.state["v"], sk, sv, ids,
                           skip_pages=skip_pages)

    def _load_prefix(self, sk, sv, ids: torch.Tensor):
        """Pool pages ``ids`` gathered into the head of a scratch."""
        if self._sharded:
            return self._shp.sharded_load_pool_pages(
                sk, sv, self.state["k"], self.state["v"], ids,
                mesh=self.mesh)
        return load_pool_pages(sk, sv, self.state["k"], self.state["v"],
                               ids)

    def _copy_page(self, src: int, dst: int) -> None:
        if self._sharded:
            self._shp.sharded_copy_pool_page(
                self.state["k"], self.state["v"], src, dst, mesh=self.mesh)
        else:
            copy_pool_page(self.state["k"], self.state["v"], src, dst)

    def _extract_pages(self, ids: torch.Tensor):
        if self._sharded:
            return self._shp.sharded_extract_request_pages(
                self.state["k"], self.state["v"], ids, mesh=self.mesh)
        return extract_request_pages(self.state["k"], self.state["v"], ids)

    def _install_record_pages(self, record: dict, ids: torch.Tensor) -> None:
        if self._sharded:
            self._shp.sharded_install_request_pages(
                self.state["k"], self.state["v"], record["k"], record["v"],
                ids, mesh=self.mesh)
        else:
            install_request_pages(self.state["k"], self.state["v"],
                                  record["k"], record["v"], ids)

    def _publish_pages(self) -> None:
        snap = self.alloc.snapshot()
        pinned = sum(len(ids) for _, ids in self.prefixes.values())
        self.stats["peak_shared_pages"] = max(
            self.stats["peak_shared_pages"], snap["pages_shared"])
        self.telemetry.set_pages(snap["pages_total"], snap["pages_in_use"],
                                 snap["fragmentation_pct"],
                                 shared=snap["pages_shared"], pinned=pinned)
        self.telemetry.set_prefix_stats(self.stats["prefix_hits"],
                                        self.stats["cow_copies"])

    def _forecast_pages(self, req: Request) -> int:
        """Admission forecast in pages: the padded prompt's pages plus
        the expected decode growth, against the lane's row bound. A
        prefix subscriber is charged only its private pages
        (``paging.forecast_subscriber_pages``). A drafted engine charges
        every request the round's k+1-row scratch tail: a sampling lane
        shares the pool the rounds transiently grow into."""
        off = self._prefix_len(req)
        tail = (self.draft[2] + 1) if self.draft is not None else 0
        if off:
            return paging.forecast_subscriber_pages(
                off, self._padded_end(len(req.prompt)), req.max_new,
                self.alloc.page_size, self.max_seq,
                self.decode_forecast_fraction, tail)
        return paging.forecast_request_pages(
            self._padded_end(len(req.prompt)), req.max_new,
            self.alloc.page_size, self.max_seq,
            self.decode_forecast_fraction, tail)

    def _eager_pages(self, req: Request) -> int:
        """Pages admission must take now (decode growth stays lazy)."""
        return paging.eager_subscriber_pages(
            self._prefix_len(req), self._padded_end(len(req.prompt)),
            self.alloc.page_size)

    def _reserved_growth(self) -> int:
        """Pages promised to running lanes but not yet allocated, private
        pages on both sides (shared prefix entries are neither charged
        nor owed)."""
        return sum(max(0, charged - self.alloc.private_pages(lane))
                   for lane, charged in self._charged_pages.items()
                   if lane in self.running)

    def _table_row(self, alloc: paging.PageAllocator,
                   lane: int) -> torch.Tensor:
        t = alloc.table(lane)
        return torch.tensor(t + [0] * (self.max_pages_per_lane - len(t)),
                            dtype=torch.int32, device=self.device)

    def _sync_table(self, lane: int) -> None:
        self.state["tables"][lane] = self._table_row(self.alloc, lane)

    def _sync_draft_table(self, lane: int) -> None:
        self.dstate["tables"][lane] = self._table_row(self._dalloc, lane)

    def _scrub_lane(self, lane: int) -> None:
        """Recycle every page the lane holds — its draft mirror's too —,
        zero its table rows (future dead-lane writes land in the trash
        page), deactivate."""
        self._charged_pages.pop(lane, None)
        self._generators.pop(lane, None)
        self._dlengths.pop(lane, None)
        if self.alloc.owned_pages(lane):
            self.alloc.release(lane)
        self.state["active"][lane] = False
        self.state["lengths"][lane] = 0
        self.state["tables"][lane] = 0
        if self._dalloc is not None:
            if self._dalloc.owned_pages(lane):
                self._dalloc.release(lane)
            self.dstate["lengths"][lane] = 0
            self.dstate["tables"][lane] = 0
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

    # full-width prefill chunks a sharded engine pipelines per dispatch
    # (the reference's bound on its unrolled schedule's compile set)
    _PREFILL_MICRO = 4

    def _run_prefill_chunks(self, sk, sv, prompt: list, off: int):
        """Chunked prefill of ``prompt`` into the admission scratch at row
        ``off``; returns (the final chunk's logits, sk, sv). A sharded
        engine stacks the full-width chunks, at most ``_PREFILL_MICRO``
        a dispatch, and runs them microbatched through the pipeline
        (``sharded_pool.sharded_prefill_chunks``), then the remainder
        chunk with the admission logits: the same chunk layout and
        accounting, token for token."""
        if self._sharded:
            return self._run_sharded_prefill(sk, sv, prompt, off)
        logits = None
        for start, piece, padded_len in self._prefill_chunks(len(prompt)):
            with tracing.step_span("serve.prefill_chunk",
                                   device=self.device) as sp:
                if sp is not None:
                    sp.attrs["tokens"] = piece
                arr = torch.zeros((1, padded_len), dtype=torch.int64,
                                  device=self.device)
                arr[0, :piece] = torch.tensor(prompt[start:start + piece],
                                              dtype=torch.int64)
                logits, sk, sv = _paged_prefill_chunk(
                    self.params, arr, sk, sv, off + start, piece - 1,
                    self.cfg, mm=self.mm)
            self.stats["prefill_chunks"] += 1
            self.telemetry.prefill_chunk(padded_len)
        return logits, sk, sv

    def _run_sharded_prefill(self, sk, sv, prompt: list, off: int):
        chunks = self._prefill_chunks(len(prompt))
        full, (lstart, lpiece, lpad) = chunks[:-1], chunks[-1]
        for g0 in range(0, len(full), self._PREFILL_MICRO):
            grp = full[g0:g0 + self._PREFILL_MICRO]
            w = grp[0][2]
            # one span a dispatched group: its chunks run as one program
            with tracing.step_span("serve.prefill_chunk",
                                   device=self.device) as sp:
                if sp is not None:
                    sp.attrs["tokens"] = sum(p for _, p, _ in grp)
                toks = torch.tensor([[prompt[s:s + p]] for s, p, _ in grp],
                                    dtype=torch.int64, device=self.device)
                sk, sv = self._shp.sharded_prefill_chunks(
                    self.params, toks, sk, sv, off + grp[0][0], w - 1,
                    self.cfg, mesh=self.mesh, with_logits=False)
            for _s, _p, padded_len in grp:
                self.stats["prefill_chunks"] += 1
                self.telemetry.prefill_chunk(padded_len)
        with tracing.step_span("serve.prefill_chunk",
                               device=self.device) as sp:
            if sp is not None:
                sp.attrs["tokens"] = lpiece
            arr = torch.zeros((1, 1, lpad), dtype=torch.int64,
                              device=self.device)
            arr[0, 0, :lpiece] = torch.tensor(
                prompt[lstart:lstart + lpiece], dtype=torch.int64)
            logits, sk, sv = self._shp.sharded_prefill_chunks(
                self.params, arr, sk, sv, off + lstart, lpiece - 1,
                self.cfg, mesh=self.mesh, with_logits=True)
        self.stats["prefill_chunks"] += 1
        self.telemetry.prefill_chunk(lpad)
        return logits, sk, sv

    def _admit_waiting(self) -> None:
        # a wave's span opens only over a queue that holds requests
        with (tracing.step_span("serve.admit_wave") if self.queue
              else tracing.NO_SPAN):
            self._expire_queued()
            if self._draining:
                # stop admitting: queued work is shed, in-flight lanes
                # finish
                self._shed_queue()
                return
            free = [i for i in range(self.n_lanes)
                    if i not in self.running]
            wave: list[tuple[int, Request]] = []
            while free and self.queue:
                if not self._admit_gate(len(self.running)):
                    break
                lane, req = free.pop(0), self.queue.pop(0)
                with tracing.step_span("serve.admit"):
                    self.telemetry.admit_start(id(req))
                    self._trace_mark(req, "admit")
                    plen = len(req.prompt)
                    padded = self._padded_end(plen)
                    off = self._prefix_len(req)
                    ps = self.alloc.page_size
                    try:
                        self._fire_fault("admit")
                        n_shared = 0
                        if off:
                            # the full prefix pages join this lane's table
                            # by reference; the partial tail page, where
                            # the suffix's first write lands, is not
                            # spliced: it materializes privately with the
                            # suffix install (copy-on-write at the page
                            # boundary)
                            _, p_ids = self.prefixes[req.prefix]
                            n_shared = off // ps
                            if n_shared:
                                self.alloc.share(lane, p_ids[:n_shared])
                        self.alloc.ensure(lane, off + padded)
                        gen = self._sampling_generator(lane, req)
                        # page-rounded scratch: the transient prefill band
                        # costs O(prefix + prompt), not O(max_seq)
                        scratch = init_cache(
                            self.cfg, 1,
                            paging.page_rounded_rows(off + padded, ps),
                            device=self.device)
                        sk, sv = scratch["k"], scratch["v"]
                        if self._sharded:
                            sk, sv = self._shp.place_scratch(sk, sv,
                                                             self.mesh)
                        if off:
                            # the prefix's K/V by device gather, no
                            # recompute: the suffix chunks attend over
                            # these rows as the slot engine's copied prefix
                            sk, sv = self._load_prefix(sk, sv,
                                                       self._ids(p_ids))
                        self.telemetry.prefill_start(id(req))
                        self._trace_mark(req, "prefill")
                        if req._trace is not None:
                            req._trace.bump("prefill_chunks",
                                            len(self._prefill_chunks(plen)))
                        logits, sk, sv = self._run_prefill_chunks(
                            sk, sv, req.prompt, off)
                        with tracing.step_span("serve.page_install"):
                            table = self.alloc.table(lane)
                            self._install_scratch(
                                sk, sv, self._ids(table[n_shared:]),
                                skip_pages=n_shared)
                            _paged_admit_commit(
                                self.state, lane,
                                self._table_row(self.alloc, lane),
                                off + plen, logits, req.temperature,
                                req.top_p, gen, top_k=self.top_k,
                                use_top_p=self._use_top_p)
                    except paging.PagePoolExhausted:
                        # raced below the gate's estimate: put the head
                        # back (a spliced prefix reference unwinds with the
                        # release) and let the next step's retirements
                        # free room
                        if self.alloc.owned_pages(lane):
                            self.alloc.release(lane)
                        self.queue.insert(0, req)
                        free.append(lane)
                        break
                    except Exception as e:
                        if not overload.is_resource_exhausted(e):
                            raise
                        # the lane's table row is committed last, so a
                        # failed admission's writes sit in its own pages
                        # (released by the scrub) or the trash page
                        self._quarantine_admit_oom(lane, req)
                        free.append(lane)
                        continue
                    self.running[lane] = req
                    self._lengths[lane] = off + plen
                    self.alloc.note_rows(lane, off + plen)
                    self._charged_pages[lane] = self._forecast_pages(req)
                    self._mirror_admit(lane, req, off, plen)
                    if off:
                        self.stats["prefix_hits"] += 1
                        if off % ps:
                            # the prefix tail page was materialized
                            # privately with the suffix install: the
                            # page-boundary CoW
                            self.stats["cow_copies"] += 1
                    self.telemetry.admitted(id(req))
                    wave.append((lane, req))
            self.stats["peak_running"] = max(self.stats["peak_running"],
                                             len(self.running))
            self._publish_pages()
            if wave:
                self._credit_first_tokens(wave, self.state["tokens"],
                                          self.state["logps"])

    # ---- speculative decoding: the draft block-table mirror -----------

    def _draft_ingest(self, lane: int, toks: list, base: int) -> None:
        """Teacher-forced ingest of ``toks`` into the lane's draft pages
        at ``base``, through the admission's bucket-padded chunk layout.
        The caller has ensured the pages."""
        dparams, dcfg, _ = self.draft
        w = self._rung_for_rows(base + self._padded_end(len(toks)))
        for start, piece, padded_len in self._prefill_chunks(len(toks)):
            arr = torch.zeros((1, padded_len), dtype=torch.int64,
                              device=self.device)
            arr[0, :piece] = torch.tensor(toks[start:start + piece],
                                          dtype=torch.int64)
            _draft_ingest_chunk(dparams, self.dstate, lane, arr,
                                base + start, base + start + piece, dcfg,
                                gather_pages_w=w)

    def _mirror_admit(self, lane: int, req: Request, off: int,
                      plen: int) -> None:
        """Mirror this admission into the draft tables: splice the
        prefix's full draft pages by reference, then ingest the tail-page
        tokens and the prompt into private draft pages — after which the
        lane may speculate. Best effort: on draft-pool exhaustion, a pad
        layout past the lane bound or an out-of-memory the lane simply
        never becomes spec-eligible (a missing mirror costs speed, never
        exactness). Sampling requests skip it: they take no round."""
        if self.draft is None or req.temperature != 0:
            return
        ps = self._dalloc.page_size
        n_shared = 0
        tail: list[int] = []
        if off:
            reg = self._dprefixes.get(req.prefix)
            if reg is None:
                return
            _dplen, d_ids, tail = reg
            n_shared = off // ps
        base = n_shared * ps
        toks = list(tail) + list(req.prompt)
        if base + self._padded_end(len(toks)) > self.max_seq:
            # the ingest's pad tail would run past the lane bound
            return
        try:
            if n_shared:
                self._dalloc.share(lane, d_ids[:n_shared])
            self._dalloc.ensure(lane, base + self._padded_end(len(toks)))
        except paging.PagePoolExhausted:
            if self._dalloc.owned_pages(lane):
                self._dalloc.release(lane)
            return
        try:
            self._sync_draft_table(lane)
            self._draft_ingest(lane, toks, base)
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            # unwind the mirror, keep the committed target admission
            if self._dalloc.owned_pages(lane):
                self._dalloc.release(lane)
            return
        self._dalloc.note_rows(lane, off + plen)
        self._dlengths[lane] = off + plen

    def _spec_catchup_paged(self, lane: int) -> bool:
        """Bring the lane's draft mirror up to the target length before a
        round (the batch-phase chunks advance only the target pool);
        every missing token is in ``req.output``. False when the mirror
        cannot catch up now (draft pages, pad layout): the round is
        skipped, never wrong."""
        L, dL = self._lengths[lane], self._dlengths[lane]
        if dL >= L:
            return True
        req = self.running[lane]
        base = self._prefix_len(req) + len(req.prompt)
        gap = req.output[dL - base:L - base]
        if dL + self._padded_end(len(gap)) > self.max_seq:
            return False
        try:
            self._dalloc.ensure(lane, dL + self._padded_end(len(gap)))
        except paging.PagePoolExhausted:
            return False
        self._sync_draft_table(lane)
        self._draft_ingest(lane, gap, dL)
        self._dalloc.note_rows(lane, L)
        self._dlengths[lane] = L
        return True

    def _spec_ready(self) -> bool:
        """May this step run a batched round? Every running lane greedy,
        mirrored and inside the k+1-row headroom, and no queued joiner
        admissible now (continuous batching bounds a joiner's wait at one
        step; a round is up to k+1). Each refusal is counted by reason."""
        if self.draft is None or not self.running:
            return False
        k = self.draft[2]
        for lane, req in self.running.items():
            if req.temperature != 0:
                self._spec_skip("sampling")
                return False
            if lane not in self._dlengths:
                self._spec_skip("no_mirror")
                return False
            if self._lengths[lane] + k + 1 > self.max_seq:
                self._spec_skip("headroom")
                return False
        if self._could_admit_now():
            self._spec_skip("joiner_waiting")
            return False
        return True

    def _spec_round_paged(self) -> bool:
        """One batched draft-k / verify-1 round over every running lane:
        pre-grow each lane's tables behind the CoW fence (target k+1
        rows, draft k), run the round, credit each lane's accepted prefix
        through the shared accounting, then truncate the rejected tails —
        a block-table truncation and a page release in both allocators.
        Returns False (the step falls through to the chunk path, whose
        victim eviction handles real exhaustion) when the growth cannot
        be satisfied."""
        dparams, dcfg, k = self.draft
        self._fire_fault("dispatch")
        lanes = sorted(self.running)
        t0 = time.monotonic()
        try:
            for lane in lanes:
                if not self._spec_catchup_paged(lane):
                    self._spec_skip("draft_pages")
                    return False
                if self.alloc.ensure(lane, self._lengths[lane] + k + 1):
                    self._sync_table(lane)
                # no draft or verify write may land in a still-shared page
                self._cow_guard(lane, k + 1)
                if self._dalloc.ensure(lane, self._lengths[lane] + k):
                    self._sync_draft_table(lane)
        except paging.PagePoolExhausted:
            self._spec_skip("pool_exhausted")
            return False
        w = self._rung_for_rows(max(self._lengths[s] for s in lanes) + k + 1)
        snapshot = dict(self.running)
        out = self._run_chunk(lambda: _spec_paged_round(
            self.params, dparams, self.state, self.dstate, self.cfg, dcfg,
            k, self.max_seq, gather_pages_w=w, mesh=self.mesh), snapshot)
        if out is None:
            return True
        g, logp, a, self.state, self.dstate = out
        try:
            # the accept counts decide what the host may emit before the
            # next round can be built
            g, logp, a = self._host_read(g, logp, a)
        except Exception as e:
            if not overload.is_resource_exhausted(e):
                raise
            # the round already advanced the pools past what the host
            # will see: quarantine its whole snapshot
            self._recover_harvest_oom(snapshot)
            return True
        kept, a_max = 0, 0
        for lane in lanes:
            al = a[lane]
            a_max = max(a_max, al)
            new_len = self._lengths[lane] + al + 1
            self._lengths[lane] = new_len
            self._dlengths[lane] = new_len
            kept += self._spec_account(lane, g[lane], logp[lane], al, k)
            if lane in self.running:
                # rejection: the scratch tail past the accepted prefix is
                # a table truncation and a page release
                if self.alloc.truncate(lane, new_len):
                    self._sync_table(lane)
                if self._dalloc.truncate(lane, new_len):
                    self._sync_draft_table(lane)
        self.stats["chunks"] += 1
        # one span covers the batched round: its serial depth is the
        # longest accepted chain, its credit every kept token
        self.telemetry.decode_chunk(a_max + 1, time.monotonic() - t0, kept)
        if self.admission is not None:
            self.admission.on_progress()
            self.telemetry.set_watermark(self.admission.watermark())
        self._publish_pages()
        return True

    # ---- decode -------------------------------------------------------

    def _cow_guard(self, lane: int, n: int) -> None:
        """Copy-on-write before a write: if a page the lane's next ``n``
        writes would touch is still shared, copy it into a private page
        (``decode.copy_pool_page``) and swap the table entry. Reserve,
        device copy, then commit: an out-of-memory in the copy aborts the
        reservation and leaves the table and refcounts untouched, and the
        device table learns of a swap only after its copy was queued, on
        the same stream, so no reader sees a half-copied page. In the
        shipped admission layout the suffix install already privatized
        the prefix tail, so this enforces the invariant rather than
        running hot; ``PagePoolExhausted`` propagates to the caller's
        victim eviction."""
        shared = self.alloc.shared_pages_of(lane)
        if not shared:
            return
        ps = self.alloc.page_size
        lo = self._lengths[lane] // ps
        hi = (min(self._lengths[lane] + n, self.max_seq) - 1) // ps
        table = self.alloc.table(lane)
        swapped = False
        try:
            for idx in range(lo, min(hi + 1, len(table))):
                if table[idx] in shared:
                    old, new = self.alloc.begin_private_copy(lane, idx)
                    try:
                        self._copy_page(old, new)
                    except BaseException:
                        self.alloc.abort_private_copy(new)
                        raise
                    self.alloc.commit_private_copy(lane, idx, old, new)
                    self.stats["cow_copies"] += 1
                    swapped = True
        finally:
            # an exhaustion mid-loop must not strand a committed swap:
            # the device table learns every one before the retry
            if swapped:
                self._sync_table(lane)

    def _ensure_pages(self, n: int) -> bool:
        """Grow every running lane's table to cover its next ``n`` rows
        before dispatch and run the copy-on-write guard. On pool
        exhaustion quarantine the lane whose eviction frees the most
        pages and retry; False when nothing is left running."""
        while self.running:
            try:
                for lane in sorted(self.running):
                    rows = min(self._lengths[lane] + n, self.max_seq)
                    if self.alloc.ensure(lane, rows):
                        self._sync_table(lane)
                    self._cow_guard(lane, n)
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
        """Pages a quarantine would recycle — private pages: a
        subscriber's shared prefix pages stay pinned by the registration
        —, length as the tiebreak."""
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
        """Power-of-two table read width covering ``rows`` (the decode
        read, the spec round and the draft ingest)."""
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
        with tracing.step_span("serve.decode_dispatch") as sp:
            self._fire_fault("dispatch")
            if not self._ensure_pages(n):
                if sp is not None:
                    sp.attrs["launched"] = False
                return None
            self._publish_pages()
            snapshot = dict(self.running)
            if sp is not None:
                sp.attrs["steps"] = n
            t0 = time.monotonic()
            out = self._run_chunk(lambda: paged_decode_chunk(
                self.params, self.state, self.cfg, n, mm=self.mm,
                top_k=self.top_k, use_top_p=self._use_top_p,
                rope_len=self.max_seq, impl=self.attn_impl,
                gather_pages_w=self._gather_rung(n),
                generators=self._generators, mesh=self.mesh), snapshot)
            if sp is not None:
                sp.attrs["launched"] = out is not None
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
        """Admit (every step), decode one chunk or one batched
        speculative round, harvest, retire, with the slot engine's
        out-of-memory split; pool exhaustion is handled in
        ``_ensure_pages`` (victim quarantine), and a round that cannot
        grow its tables falls through to the chunk path."""
        with tracing.step_span("serve.step", root=True):
            self._fire_fault("step")
            self._admit_waiting()
            if not self.running:
                if self.queue:
                    time.sleep(0.01)
                return
            if self._spec_ready():
                try:
                    if self._spec_round_paged():
                        return
                except Exception as e:
                    if not overload.is_resource_exhausted(e):
                        raise
                    # raised at the round's dispatch, before its programs:
                    # a chunk dispatch's heuristic victim
                    self._recover_dispatch_oom()
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
