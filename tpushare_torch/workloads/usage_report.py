"""Payload-side HBM usage self-reporting — the port of
``tpushare/workloads/usage_report.py``.

No node daemon sees another process's allocations inside the card's
memory, so the payload reports its own. ``read_hbm_usage`` snapshots
PyTorch's caching allocator (``torch.cuda.memory_stats``: the bytes
allocated now and their peak); ``start_reporter`` POSTs it to the device
plugin's obs port on an interval, where it lands in the pod's
``ALIYUN_COM_TPU_HBM_USED`` annotation and the node's used-HBM gauge —
the binpacker's live used-against-requested view of the pod.

Wiring: Allocate injects ``TPUSHARE_USAGE_PORT`` (the downward API gives
``POD_NAME`` / ``POD_NAMESPACE``, and ``HOST_IP`` reaches the
host-network daemon); everything is a no-op off the card or when
unconfigured, so a payload never fails because observability is absent.

The daemon's answer to a POST is also its directive channel: ``{"drain":
true}`` asks the payload to drain (a rebalancer migration), a later
``{"drain": false}`` withdraws it (``set_drain_handler``).

Where the port parts from the reference: the reference falls back to
summing live ``jax.Array`` buffers when a PJRT transport hides its
allocator stats; CUDA's allocator always answers, so the port has no
such fallback, and a device without allocator stats (the CPU) reads as
None.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request

from tpushare_torch import consts

log = logging.getLogger("tpushare_torch.usage")

# the directive handlers: a usage POST's answer may carry {"drain": true}
# when the rebalancer marks this pod for migration, and the payload
# entry points register the serving front's request_drain here. The
# directive is rescindable: an aborted migration answers {"drain":
# false} on the next POST and the resume handler (cancel_drain) reopens
# admission. Only a directive-initiated drain is rescinded (the
# _drain_fired latch); a SIGTERM drain is local and stays.
_drain_handler = None
_resume_handler = None
_drain_fired = False


def set_drain_handler(fn, on_resume=None) -> None:
    """Register the callable invoked when a usage POST's answer asks
    this payload to drain, and optionally the one invoked when a
    delivered directive is withdrawn; None unregisters."""
    global _drain_handler, _resume_handler, _drain_fired
    _drain_handler = fn
    _resume_handler = on_resume
    _drain_fired = False


def _maybe_drain(directives: dict | None) -> None:
    global _drain_fired
    if not directives:
        return
    want = bool(directives.get("drain"))
    if want and not _drain_fired and _drain_handler is not None:
        _drain_fired = True
        log.warning("node daemon requested drain (rebalancer migration); "
                    "draining the engine")
        try:
            _drain_handler()
        except Exception as e:  # noqa: BLE001 — a handler bug must not
            log.warning("drain handler failed: %s", e)  # stop reporting
    elif not want and _drain_fired:
        _drain_fired = False
        if _resume_handler is None:
            return
        log.warning("node daemon withdrew the drain directive (migration "
                    "aborted); resuming admission")
        try:
            _resume_handler()
        except Exception as e:  # noqa: BLE001
            log.warning("drain resume handler failed: %s", e)


def read_hbm_usage(device=None) -> dict | None:
    """``{"used_mib", "peak_mib", "peak_kind", "source"}`` from
    ``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
    ``.peak`` — the caching allocator's own figures, its peak included
    (``peak_kind: "allocator"``) — for ``device``, or by default summed
    over every CUDA device of the process: a sharded payload allocates
    on each card of its mesh, and the daemon books the pod's whole
    footprint (a card the process never allocated on adds 0; the peak
    is the sum of each card's peak). None where there are no allocator
    stats: no CUDA, a CPU device, or an allocator that has not
    allocated yet."""
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                return None
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(device)]
        if any(d.type != "cuda" for d in devices):
            return None
        stats = [torch.cuda.memory_stats(d) for d in devices]
    except Exception:  # noqa: BLE001 — observability must not throw
        return None
    stats = [st for st in stats
             if st.get("allocated_bytes.all.current") is not None]
    if not stats:
        return None
    used = sum(st["allocated_bytes.all.current"] for st in stats)
    peak = sum(st.get("allocated_bytes.all.peak",
                      st["allocated_bytes.all.current"]) for st in stats)
    mib = 1024 * 1024
    return {
        "used_mib": round(used / mib, 1),
        "peak_mib": round(peak / mib, 1),
        "peak_kind": "allocator",
        "source": "memory_stats",
    }


def resolve_report_url() -> str | None:
    """The reporter's endpoint from the env contract: the full URL, else
    ``HOST_IP`` + ``TPUSHARE_USAGE_PORT``, else None (reporting off)."""
    url = os.environ.get(consts.ENV_USAGE_URL)
    if url:
        return url
    host = os.environ.get(consts.ENV_HOST_IP)
    port = os.environ.get(consts.ENV_USAGE_PORT)
    if host and port:
        return f"http://{host}:{port}/usage"
    return None


def _telemetry_snapshot() -> dict | None:
    """The live serving snapshot — the last engine's, or a fleet
    router's merged one through its provider —, None when nothing
    publishes. Isolated so a telemetry bug never breaks a report."""
    try:
        from tpushare_torch.workloads.telemetry import current_snapshot
        return current_snapshot()
    except Exception:  # noqa: BLE001
        return None


def resolve_trace_id() -> str | None:
    """The allocation-lifecycle trace id Allocate put in this
    container's env, None outside the plugin's wiring. Riding on every
    POST, it lets the daemon attach the payload's first report as the
    trace's terminal span."""
    return os.environ.get(consts.ENV_TRACE_ID) or None


def post_usage(url: str, pod: str, namespace: str, usage: dict,
               timeout_s: float = 2.0, trace_id: str | None = None,
               telemetry: dict | None = None) -> bool:
    """POST one report — ``{"pod", "namespace", **usage}``, the trace id
    and the live telemetry snapshot (under ``USAGE_TELEMETRY_KEY``) when
    there are any — and act on the answer's drain directive. False on
    any failure (logged at debug), never raises."""
    trace_id = trace_id if trace_id is not None else resolve_trace_id()
    body = {"pod": pod, "namespace": namespace, **usage}
    if trace_id:
        body["trace_id"] = trace_id
    if telemetry is None and consts.USAGE_TELEMETRY_KEY not in body:
        telemetry = _telemetry_snapshot()
    if telemetry:
        body[consts.USAGE_TELEMETRY_KEY] = telemetry
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            ok = 200 <= resp.status < 300
            if ok and resp.status == 200:
                # a 200 body may carry the drain directive; 204 is the
                # plain acknowledgement
                try:
                    _maybe_drain(json.loads(resp.read() or b"{}"))
                except ValueError:
                    pass
            return ok
    except Exception as e:  # noqa: BLE001
        log.debug("usage report to %s failed: %s", url, e)
        return False


def post_now(url: str | None = None, pod: str | None = None,
             namespace: str | None = None, timeout_s: float = 2.0) -> bool:
    """One report now, outside the reporter's cadence — the payload's
    last words at exit or after a SIGTERM drain, so its final shed /
    deadline / OOM counters reach the daemon. Without allocator stats
    it still posts the counters, under ``source: "shutdown"``. False
    (and a silent no-op) when unconfigured."""
    url = url or resolve_report_url()
    pod = pod or os.environ.get(consts.ENV_POD_NAME)
    namespace = namespace or os.environ.get(consts.ENV_POD_NAMESPACE,
                                            "default")
    if not url or not pod:
        return False
    usage = read_hbm_usage()
    if usage is None:
        usage = {"used_mib": 0.0, "peak_mib": 0.0, "source": "shutdown"}
    return post_usage(url, pod, namespace, usage, timeout_s=timeout_s)


def start_reporter(interval_s: float = 10.0, url: str | None = None,
                   pod: str | None = None, namespace: str | None = None
                   ) -> threading.Event | None:
    """Start the background reporter; returns its stop Event, or None
    when unconfigured (no URL or no pod identity), so the same payload
    runs unchanged outside the plugin's wiring.

    The reference samples densely between POSTs to ratchet its
    live-array fallback's peak; the allocator's own peak already covers
    what happens between POSTs, so this loop only waits."""
    url = url or resolve_report_url()
    pod = pod or os.environ.get(consts.ENV_POD_NAME)
    namespace = namespace or os.environ.get(consts.ENV_POD_NAMESPACE,
                                            "default")
    if not url or not pod:
        return None
    stop = threading.Event()

    def loop() -> None:
        while not stop.is_set():
            usage = read_hbm_usage()
            if usage is not None:
                post_usage(url, pod, namespace, usage)
            stop.wait(interval_s)

    threading.Thread(target=loop, name="hbm-usage-reporter",
                     daemon=True).start()
    log.info("HBM usage reporter -> %s (pod %s/%s, every %.0fs)",
             url, namespace, pod, interval_s)
    return stop
