"""Data-plane overload defense of the port — its own copy of
``tpushare/workloads/overload.py``, which the engines wire into their
host loops:

- the terminal request statuses (every submitted request ends as
  exactly one of completed / shed / deadline_exceeded / oom_quarantined)
  and the queue reject policies;
- :func:`is_resource_exhausted` — the device running out of memory,
  which on the card is ``torch.cuda.OutOfMemoryError``;
- :class:`AdmissionController` — an AIMD watermark over the engine's
  lanes (multiplicative cut on chip pressure or an OOM, additive
  recovery on clean progress) plus an HBM-headroom gate (slot engine,
  MiB) or a page gate (paged engine);
- :class:`SyncWatchdog` — a wall-clock bound on the harvest's blocking
  device read: past it the engine reads degraded while the read goes on
  waiting on a worker thread;
- :class:`DrainTimeout` — the typed loop-bound failure carrying the
  undrained requests;
- :func:`watch_signal_queue` — SIGTERM to ``engine.request_drain()``.

The node daemon's ``GET /usage`` document is read by the port's own
``fetch_usage`` / ``chip_pressure`` (stdlib ``urllib``), the reference's
``tpushare/usageclient.py`` schema walk.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import threading
import time
import urllib.request
import weakref
from typing import Any, Callable, Mapping, Sequence

import torch

from tpushare_torch import consts
from tpushare_torch.consts import (REJECT_NEW,  # noqa: F401 (re-export)
                                   REJECT_POLICIES, SHED_OLDEST,
                                   STATUS_COMPLETED,
                                   STATUS_DEADLINE_EXCEEDED,
                                   STATUS_OOM_QUARANTINED, STATUS_SHED,
                                   TERMINAL_STATUSES)
from tpushare_torch.device import units_to_mib

__all__ = [
    "STATUS_COMPLETED", "STATUS_SHED", "STATUS_DEADLINE_EXCEEDED",
    "STATUS_OOM_QUARANTINED", "TERMINAL_STATUSES", "REJECT_NEW",
    "SHED_OLDEST", "REJECT_POLICIES", "DrainTimeout",
    "is_resource_exhausted", "kv_cost_mib", "AdmissionController",
    "SyncWatchdog", "install_signal_queue", "watch_signal_queue",
    "fetch_usage", "chip_pressure", "fetch_chip_pressure",
]


class DrainTimeout(RuntimeError):
    """``run()`` / ``drain()`` hit its iteration bound with work still
    live. Carries the undrained Request objects (partial outputs intact)
    and the queue depth."""

    def __init__(self, message: str,
                 undrained: Sequence[Any] | None = None,
                 queue_depth: int = 0) -> None:
        super().__init__(message)
        self.undrained: list[Any] = list(undrained or [])
        self.queue_depth = int(queue_depth)

    @property
    def undrained_ids(self) -> list[int]:
        return [id(r) for r in self.undrained]


def is_resource_exhausted(exc: BaseException | None) -> bool:
    """Is this exception the device running out of memory? The
    reference matches XLA's RESOURCE_EXHAUSTED; on the card that is
    ``torch.cuda.OutOfMemoryError``. Walks the cause/context chain, as
    a wrapped OOM is still an OOM."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def kv_cost_mib(n_layers: int, kv_heads: int, head_dim: int, rows: int,
                bytes_per_el: float = 2) -> float:
    """HBM cost (MiB) of ``rows`` K/V cache rows across every layer, K
    and V both — the marginal figure the admission forecast charges."""
    return (2 * n_layers * kv_heads * head_dim * max(0, rows)
            * bytes_per_el) / (1024 * 1024)


# ---------------------------------------------------------------------------
# the node daemon's usage document (chip pressure)
# ---------------------------------------------------------------------------

def usage_url(base_url: str) -> str:
    base = base_url.rstrip("/")
    return base if base.endswith("/usage") else f"{base}/usage"


def fetch_usage(obs_url: str, timeout_s: float = 2.0) -> dict | None:
    """One GET of the node's usage document; None on any failure —
    pressure is a best-effort signal, never an error."""
    try:
        with urllib.request.urlopen(usage_url(obs_url),
                                    timeout=timeout_s) as resp:
            doc = json.loads(resp.read())
    except Exception:  # noqa: BLE001 — observability must not fail callers
        return None
    return doc if isinstance(doc, dict) else None


def chip_pressure(doc: dict | None, chip: int) -> float | None:
    """One chip's capacity-basis pressure from a usage document; None
    when the chip is absent or not reporting."""
    out: dict[int, float] = {}
    if not isinstance(doc, dict):
        return None
    for entry in doc.get("chips") or []:
        if not isinstance(entry, dict):
            continue
        c = entry.get("chip")
        p = (entry.get("pressure") or {}).get("capacity")
        if isinstance(c, int) and isinstance(p, (int, float)) \
                and not isinstance(p, bool):
            out[c] = float(p)
    return out.get(chip)


def fetch_chip_pressure(obs_url: str, chip: int,
                        timeout_s: float = 2.0) -> float | None:
    """This chip's pressure from the node daemon's ``GET /usage``; None
    on any failure (no signal, never an error)."""
    return chip_pressure(fetch_usage(obs_url, timeout_s=timeout_s), chip)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

class AdmissionController:
    """AIMD admission watermark + HBM-headroom gate for an engine.

    The watermark is how many of the engine's ``n_slots`` lanes may be
    occupied at once. It shrinks multiplicatively (``md_factor``) when
    the chip-pressure signal crosses ``pressure_high`` or the engine
    survives an OOM — at most once per ``md_cooldown_s`` — and recovers
    additively (``ai_step`` per clean decode chunk) back to ``n_slots``.

    The HBM gate refuses an admit whose forecast K/V footprint would
    push the charged total past ``cap_mib``; the paged engine's gate is
    pages instead (:meth:`admit_ok_pages`). ``pressure_fn`` returns the
    chip pressure in [0, 1] or None, polled at most once per
    ``pressure_interval_s`` (on a background thread; 0 polls inline).
    All state is lock-guarded — healthz and telemetry read the
    watermark from other threads.
    """

    def __init__(self, n_slots: int, cap_mib: float | None = None,
                 base_mib: float = 0.0,
                 pressure_fn: Callable[[], float | None] | None = None,
                 pressure_high: float = consts.PRESSURE_ENGAGE,
                 md_factor: float = 0.5, ai_step: float = 0.25,
                 min_watermark: int = 1, md_cooldown_s: float = 1.0,
                 pressure_interval_s: float = 1.0,
                 clock: Callable[[], float] | None = None) -> None:
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} must be >= 1")
        if not 0 < md_factor < 1:
            raise ValueError(f"md_factor {md_factor} must be in (0, 1)")
        if ai_step <= 0:
            raise ValueError(f"ai_step {ai_step} must be > 0")
        self.n_slots = n_slots
        self.cap_mib = cap_mib
        self.base_mib = float(base_mib)
        self.pressure_fn = pressure_fn
        self.pressure_high = pressure_high
        self.md_factor = md_factor
        self.ai_step = ai_step
        self.min_watermark = max(1, min(min_watermark, n_slots))
        self.md_cooldown_s = md_cooldown_s
        self.pressure_interval_s = pressure_interval_s
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._watermark = float(n_slots)
        self._last_cut = float("-inf")
        self._last_pressure_poll = float("-inf")
        self._last_pressure: float | None = None
        self._pressure_refreshing = False
        self.cuts = 0
        self.deferred_hbm = 0
        self.deferred_pages = 0
        self.deferred_watermark = 0
        # lowest watermark ever reached
        self.floor_reached = n_slots

    @classmethod
    def from_env(cls, n_slots: int,
                 environ: Mapping[str, str] | None = None,
                 memory_unit: str = consts.MIB,
                 chunk_mib: int | None = None,
                 **kw: Any) -> "AdmissionController":
        """Build from the Allocate env contract: the pod cap prefers
        ``TPUSHARE_HBM_LIMIT_MIB`` (MiB); failing that, the unit-scaled
        ``ALIYUN_COM_TPU_HBM_POD`` in MiB. A usage endpoint and a chip
        index in the env wire the chip-pressure signal."""
        env = environ if environ is not None else os.environ
        cap: float | None = None
        raw = env.get(consts.ENV_HBM_LIMIT_MIB)
        if raw:
            try:
                cap = float(raw)
            except ValueError:
                cap = None
        if cap is None:
            raw = env.get(consts.ENV_RESOURCE_BY_POD)
            if raw:
                try:
                    cap = float(units_to_mib(int(raw), memory_unit,
                                             chunk_mib))
                except ValueError:
                    cap = None
        if "pressure_fn" not in kw:
            url = env.get(consts.ENV_USAGE_URL)
            if not url:
                host = env.get(consts.ENV_HOST_IP)
                port = env.get(consts.ENV_USAGE_PORT)
                url = f"http://{host}:{port}" if host and port else None
            chip_raw = env.get(consts.ENV_RESOURCE_INDEX)
            if url and chip_raw is not None:
                try:
                    chip = int(chip_raw)
                except ValueError:
                    chip = None
                if chip is not None:
                    base = url.rsplit("/usage", 1)[0]
                    kw["pressure_fn"] = (
                        lambda: fetch_chip_pressure(base, chip))
        return cls(n_slots, cap_mib=cap, **kw)

    # ---- signal inputs ------------------------------------------------

    def watermark(self) -> int:
        with self._lock:
            return int(self._watermark)

    def _cut(self) -> bool:
        """Multiplicative decrease, at most one per cooldown; True when
        the watermark moved."""
        now = self._clock()
        with self._lock:
            if now - self._last_cut < self.md_cooldown_s:
                return False
            before = int(self._watermark)
            self._watermark = max(float(self.min_watermark),
                                  self._watermark * self.md_factor)
            self._last_cut = now
            self.cuts += 1
            self.floor_reached = min(self.floor_reached,
                                     int(self._watermark))
            return int(self._watermark) < before

    def on_oom(self) -> bool:
        """The engine survived an out-of-memory: shrink."""
        return self._cut()

    def on_pressure(self) -> bool:
        """The chip-pressure signal crossed the high mark: shrink."""
        return self._cut()

    def on_progress(self) -> None:
        """One clean decode chunk harvested: additive recovery."""
        with self._lock:
            self._watermark = min(float(self.n_slots),
                                  self._watermark + self.ai_step)

    def _refresh_pressure(self) -> None:
        try:
            p = self.pressure_fn()
        except Exception:  # noqa: BLE001 — no signal, not an error
            p = None
        with self._lock:
            self._last_pressure = p
            self._last_pressure_poll = self._clock()
            self._pressure_refreshing = False

    def _pressure(self) -> float | None:
        """The cached chip-pressure reading; a due refresh runs on a
        background thread and this call returns the previous value (an
        admit never blocks on an HTTP round trip).
        ``pressure_interval_s=0`` polls inline."""
        if self.pressure_fn is None:
            return None
        if self.pressure_interval_s <= 0:
            self._refresh_pressure()
            with self._lock:
                return self._last_pressure
        now = self._clock()
        with self._lock:
            due = (now - self._last_pressure_poll
                   >= self.pressure_interval_s
                   and not self._pressure_refreshing)
            if due:
                self._pressure_refreshing = True
            cached = self._last_pressure
        if due:
            threading.Thread(target=self._refresh_pressure,
                             name="pressure-poll", daemon=True).start()
        return cached

    # ---- the admit decision -------------------------------------------

    def _gate(self, occupancy: int) -> str | None:
        """The watermark and pressure half of both admit decisions: the
        refusal reason, or None. A pressure reading past the mark cuts
        the watermark; pressure never refuses below ``min_watermark``
        occupancy (liveness floor)."""
        pressure = self._pressure()
        if pressure is not None and pressure >= self.pressure_high:
            self.on_pressure()
        with self._lock:
            mark = int(self._watermark)
        if occupancy >= mark:
            with self._lock:
                self.deferred_watermark += 1
            return "watermark"
        if pressure is not None and pressure >= self.pressure_high \
                and occupancy >= self.min_watermark:
            return "pressure"
        return None

    def admit_ok(self, occupancy: int, forecast_mib: float = 0.0,
                 used_mib: float | None = None) -> tuple[bool, str | None]:
        """May one more request be admitted right now? (ok, reason) with
        reason one of None / "watermark" / "pressure" / "hbm"; watermark
        and HBM refusals are deferrals."""
        reason = self._gate(occupancy)
        if reason is not None:
            return False, reason
        if self.cap_mib is not None:
            charged = self.base_mib if used_mib is None else used_mib
            if charged + forecast_mib > self.cap_mib:
                with self._lock:
                    self.deferred_hbm += 1
                return False, "hbm"
        return True, None

    def could_ever_fit(self, forecast_mib: float) -> bool:
        """Could this request fit even on an idle engine? False: shed it
        terminally instead of deferring forever."""
        if self.cap_mib is None:
            return True
        return self.base_mib + forecast_mib <= self.cap_mib

    def admit_ok_pages(self, occupancy: int, forecast_pages: int,
                       free_pages: int) -> tuple[bool, str | None]:
        """The paged engine's admit decision: the same watermark and
        pressure discipline, with the page forecast against the free
        pool net of promised growth. Reason one of None / "watermark" /
        "pressure" / "pages"."""
        reason = self._gate(occupancy)
        if reason is not None:
            return False, reason
        if forecast_pages > free_pages:
            with self._lock:
                self.deferred_pages += 1
            return False, "pages"
        return True, None

    def pressure_deferring(self, occupancy: int) -> bool:
        """Side-effect-free peek: would the cached pressure reading defer
        an admit at this occupancy? No cut, no counter."""
        with self._lock:
            pressure = self._last_pressure
        return (self.pressure_fn is not None and pressure is not None
                and pressure >= self.pressure_high
                and occupancy >= self.min_watermark)

    def could_ever_fit_pages(self, forecast_pages: int,
                             usable_pages: int) -> bool:
        """Could this page forecast fit an idle pool?"""
        return forecast_pages <= usable_pages


# ---------------------------------------------------------------------------
# the harvest watchdog
# ---------------------------------------------------------------------------

class SyncWatchdog:
    """Wall-clock bound on a blocking call. The call runs on one
    long-lived worker thread; past ``bound_s`` ``on_degrade`` fires
    (healthz flips, telemetry marks degraded) while the wait goes on —
    the result is still owed, and the caller never proceeds while the
    worker may still touch its state — and ``on_recover`` fires when
    the call completes. Not reentrant: the engine issues one sync at a
    time.

    A CUDA read on the worker must name its device and stream itself
    (the current device and stream are per thread in torch): the
    engines hand it a function that does (``_EngineCore._host_read``).
    """

    def __init__(self, bound_s: float,
                 on_degrade: Callable[[], None] | None = None,
                 on_recover: Callable[[], None] | None = None,
                 poll_s: float = 0.05) -> None:
        if bound_s <= 0:
            raise ValueError(f"bound_s {bound_s} must be > 0")
        self.bound_s = bound_s
        self.on_degrade = on_degrade
        self.on_recover = on_recover
        self.poll_s = poll_s
        self.degraded = False
        self.trips = 0
        self._work: queue.Queue[Callable[[], object]] = queue.Queue()
        self._done: queue.Queue[dict[str, Any]] = queue.Queue()
        self._worker: threading.Thread | None = None

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        # the worker holds the queues only, never the watchdog or a
        # finished call: an engine dropped by its caller is freed, and
        # its collection ends the worker
        work, done = self._work, self._done

        def loop() -> None:
            while True:
                fn = work.get()
                if fn is None:
                    return
                box: dict[str, Any] = {}
                try:
                    box["result"] = fn()
                except BaseException as e:  # noqa: BLE001 — re-raised
                    box["error"] = e        # by the caller
                done.put(box)
                del fn, box

        self._worker = threading.Thread(target=loop, name="sync-watchdog",
                                        daemon=True)
        self._worker.start()
        weakref.finalize(self, work.put, None)

    def call(self, fn: Callable[[], object]) -> object:
        self._ensure_worker()
        self._work.put(fn)
        try:
            box = self._done.get(timeout=self.bound_s)
        except queue.Empty:
            self.degraded = True
            self.trips += 1
            if self.on_degrade is not None:
                self.on_degrade()
            while True:
                try:
                    box = self._done.get(timeout=self.poll_s)
                    break
                except queue.Empty:
                    continue
            self.degraded = False
            if self.on_recover is not None:
                self.on_recover()
        if "error" in box:
            raise box["error"]
        return box.get("result")


# ---------------------------------------------------------------------------
# signals -> drain
# ---------------------------------------------------------------------------

def install_signal_queue(signals: tuple[int, ...] = (
        signal.SIGHUP, signal.SIGINT, signal.SIGTERM, signal.SIGQUIT)
        ) -> "queue.Queue[int]":
    """Deliver the given signals through a queue (the reference's
    ``deviceplugin/watchers.install_signal_queue``)."""
    q: "queue.Queue[int]" = queue.Queue()

    def handler(signum, frame):  # noqa: ARG001
        q.put(signum)

    for s in signals:
        signal.signal(s, handler)
    return q


def watch_signal_queue(engine: Any, sigq: Any,
                       signals: tuple[int, ...] | None = None,
                       on_signal: Callable[[int], None] | None = None,
                       ) -> threading.Thread:
    """The first matching signal on ``sigq`` calls
    ``engine.request_drain()`` (stop admitting; in-flight requests
    finish; queued work is accounted shed). A ``None`` on ``sigq`` ends
    the watcher without a drain, releasing ``engine``. Returns the
    watcher thread (a daemon: it never holds the payload open)."""
    accept = signals if signals is not None else (signal.SIGTERM,
                                                  signal.SIGINT)

    def loop() -> None:
        while True:
            signum = sigq.get()
            if signum is None:
                return
            if signum in accept:
                engine.request_drain()
                if on_signal is not None:
                    on_signal(signum)
                return

    t = threading.Thread(target=loop, name="drain-on-signal", daemon=True)
    t.start()
    return t
