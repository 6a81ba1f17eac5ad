"""The fleet stacks of both packages behind one interface, for the port's
fleet tests (``tests/test_torch_handoff.py``, ``test_torch_fleet.py``,
``test_torch_fleet_chaos.py``, ``test_torch_wirecodec.py``,
``test_torch_transport.py``).

A scenario is written once against a side — the reference (JAX) or the
port (torch) — and run on both over the same weights: the reference's
f32 ``init_params`` carried across by ``bridge``. Prompts come from
numpy with a fixed seed, so both sides see the same requests. What the
tests compare across the sides is what does not depend on the wall
clock: tokens, statuses, router stats and reasons, member states,
handoff counters, allocator snapshots and the merged snapshot's
counters (:func:`snap_view`)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpushare import consts as jconsts
from tpushare.k8s import retry as jretry
from tpushare.tpu import fake as jfake
from tpushare.workloads import decode as jdecode
from tpushare.workloads import fleet as jfleet
from tpushare.workloads import overload as joverload
from tpushare.workloads import paging as jpaging
from tpushare.workloads import remote as jremote
from tpushare.workloads import serving as jserving
from tpushare.workloads import telemetry as jtelemetry
from tpushare.workloads import transport as jtransport
from tpushare.workloads import wirecodec as jwirecodec
from tpushare.workloads.models import transformer as jt
from tpushare_torch import consts, metrics, retry
from tpushare_torch.tpu import fake
from tpushare_torch.workloads import bridge, decode, fleet, overload
from tpushare_torch.workloads import paging, remote, serving, telemetry
from tpushare_torch.workloads import transport, wirecodec
from tpushare_torch.workloads.models import transformer as tt

JCFG = jt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=256, dtype=jnp.float32)
CFG = tt.TransformerConfig(**{**{f.name: getattr(JCFG, f.name)
                                 for f in dataclasses.fields(JCFG)},
                              "dtype": torch.float32})
JPARAMS = jt.init_params(jax.random.key(0), JCFG)
PARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                  device="cpu")

# the reference fleet tests' engine shape
PAGED_KW = dict(n_lanes=3, max_seq=96, n_pages=40, page_size=8,
                prompt_buckets=(8, 32), chunk=4)
# manual-probe posture of the reference chaos suites: auto-probing off,
# a fast probe timeout, an instant cooldown, one clean probe to close
KNOBS = dict(probe_interval_s=1000.0, probe_timeout_s=0.2,
             breaker_cooldown_s=0.05, half_open_probes=1)

# merged-snapshot keys that read the wall clock (rates, tails, the SLO
# verdicts a compile-heavy first request may miss) or process-wide
# build counters: not compared across the packages
CLOCK_KEYS = {
    consts.TELEMETRY_TOKENS_PER_S, consts.TELEMETRY_GOODPUT_TOKENS_PER_S,
    consts.TELEMETRY_TTFT_P50_MS, consts.TELEMETRY_TTFT_P99_MS,
    consts.TELEMETRY_DECODE_P50_MS, consts.TELEMETRY_DECODE_P99_MS,
    consts.TELEMETRY_COMPILES, consts.TELEMETRY_COMPILE_SECONDS,
    consts.TELEMETRY_KERNEL_FALLBACKS, consts.TELEMETRY_SLO_GOOD,
    consts.TELEMETRY_SLO_VIOLATIONS_QUEUED,
    consts.TELEMETRY_SLO_VIOLATIONS_ADMISSION,
    consts.TELEMETRY_SLO_VIOLATIONS_PREFILL,
    consts.TELEMETRY_SLO_VIOLATIONS_DECODE}


def _ref_offline(prompt: list, steps: int) -> list:
    out = jdecode.generate(JPARAMS, jnp.asarray([prompt], jnp.int32), JCFG,
                           steps)
    return [int(t) for t in np.asarray(out)[0]]


def _port_offline(prompt: list, steps: int) -> list:
    out = decode.generate(PARAMS, torch.tensor([prompt]), CFG, steps)
    return [int(t) for t in out[0].tolist()]


def _ref_planes(eng, ids) -> list:
    idx = jnp.asarray(list(ids), jnp.int32)
    out = []
    for leaf in (eng.state["k"], eng.state["v"]):
        for plane in ([leaf["q"], leaf["s"]] if isinstance(leaf, dict)
                      else [leaf]):
            out.append(np.asarray(plane[:, idx]))
    return out


def _port_planes(eng, ids) -> list:
    idx = torch.tensor(list(ids), dtype=torch.int64)
    out = []
    for leaf in (eng.state["k"], eng.state["v"]):
        for plane in decode.kv_planes(leaf):
            out.append(plane[:, idx].cpu().numpy().copy())
    return out


REF = SimpleNamespace(
    name="ref", params=JPARAMS, cfg=JCFG, consts=jconsts,
    Paged=jserving.PagedServingEngine, Request=jserving.Request,
    fleet=jfleet, FleetRouter=jfleet.FleetRouter, overload=joverload,
    paging=jpaging, Plan=jfake.WorkloadFaultPlan, Fault=jfake.WorkloadFault,
    FakeMemberDeath=jfake.FakeMemberDeath, telemetry=jtelemetry,
    wirecodec=jwirecodec, transport=jtransport, remote=jremote,
    retry=jretry, offline=_ref_offline, planes=_ref_planes)
PORT = SimpleNamespace(
    name="port", params=PARAMS, cfg=CFG, consts=consts,
    Paged=serving.PagedServingEngine, Request=serving.Request,
    fleet=fleet, FleetRouter=fleet.FleetRouter, overload=overload,
    paging=paging, Plan=fake.WorkloadFaultPlan, Fault=fake.WorkloadFault,
    FakeMemberDeath=fake.FakeMemberDeath, telemetry=telemetry,
    wirecodec=wirecodec, transport=transport, remote=remote,
    retry=retry, offline=_port_offline, planes=_port_planes,
    metrics=metrics)
SIDES = (REF, PORT)


def paged(side, **kw):
    return side.Paged(side.params, side.cfg, **{**PAGED_KW, **kw})


def prompt(key: int, n: int) -> list:
    """A seeded prompt, the same on both sides."""
    return [int(t) for t in np.random.default_rng(
        10_000 + key).integers(0, CFG.vocab, n)]


def req(side, key: int, n: int, max_new: int, **kw):
    return side.Request(prompt=prompt(key, n), max_new=max_new, **kw)


def assert_no_leaks(*engines) -> None:
    for eng in engines:
        assert eng.alloc.pages_in_use() == 0
        assert eng.alloc.leaked() == 0


def same_bytes(a: list, b: list) -> bool:
    """Plane lists equal in dtype, shape and every byte."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and (x == y).all()
        for x, y in zip(a, b))


def snap_view(snap: dict) -> dict:
    """A merged (or member) snapshot without its wall-clock keys."""
    return {k: v for k, v in snap.items() if k not in CLOCK_KEYS}


def router_view(r) -> dict:
    """What must agree between the packages' routers."""
    return {"stats": {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in r.stats.items()},
            "states": r.member_states(),
            "members": r.healthz()["members"],
            "handoffs": [(e.stats.get("handoffs_in"),
                          e.stats.get("handoffs_out")) for e in r.engines],
            "allocs": [e.alloc.snapshot() for e in r.engines
                       if hasattr(e, "alloc")]}


def statuses(reqs) -> list:
    return [(q.status, q.done) for q in reqs]


def outputs(reqs) -> list:
    return [list(q.output) for q in reqs]


def clear_providers() -> None:
    jtelemetry.set_snapshot_provider(None)
    telemetry.set_snapshot_provider(None)
