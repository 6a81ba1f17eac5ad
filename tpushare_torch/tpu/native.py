"""The CUDA device backend: NVML over ``ctypes`` — the port's counterpart
of ``tpushare/tpu/native.py``, behind the unchanged daemon.

Enumeration dlopens ``libnvidia-ml.so.1``, the reference upstream's own
route (gpushare's ``nvml_dl.c``): ``nvmlInit_v2``, then per device
``nvmlDeviceGetHandleByIndex_v2``, ``GetUUID``, ``GetMinorNumber``,
``GetMemoryInfo``, ``GetPciInfo_v3`` and ``GetName``. NVML never creates
a CUDA context, so the daemon takes none of the memory it sells.
Neither ``torch`` nor ``jax`` is imported.

Health, two parts feeding one two-way :class:`HealthEvent` stream:

- an XID thread on ``nvmlEventSetWait_v2`` (``nvmlEventTypeXidCriticalError``)
  with a timeout, so :meth:`NvmlBackend.close` returns; the application
  XIDs 31, 43 and 45 are dropped (upstream's ``watchXIDs``), any other
  marks its GPU (or, without a device, every GPU) unhealthy, with the
  XID as the event's code — NVML has no clear, so it stays down;
- a poll of each GPU's device nodes: a node gone marks the GPU
  unhealthy, its return healthy again.

The library (a ``ctypes.CDLL`` or an object with its functions), the
device root (``TPUSHARE_DEV_ROOT``) and the proc root
(``TPUSHARE_PROC_ROOT``) can be injected for tests.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

from tpushare_torch.tpu.backend import (Backend, HealthBroadcaster,
                                        HealthEvent)
from tpushare_torch.tpu.device import GpuChip
from tpushare_torch.tpu.kernel_stats import dev_root, nvidia_client_pids

log = logging.getLogger("tpushare_torch.native")

NVML_LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_TIMEOUT = 10
EVENT_XID_CRITICAL = 0x8
# XIDs an application causes (a fault in its own kernel, a reset it
# asked for, a preemption): not the card's health
APPLICATION_XIDS = frozenset({31, 43, 45})
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
_BUF = 96          # NVML_DEVICE_UUID_V2 / NAME_V2 buffer sizes


class NvmlError(RuntimeError):
    def __init__(self, call: str, code: int) -> None:
        super().__init__(f"{call} failed: NVML error {code}")
        self.code = code


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _PciInfo(ctypes.Structure):
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint), ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint), ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class _EventData(ctypes.Structure):
    _fields_ = [("device", ctypes.c_void_p),
                ("eventType", ctypes.c_ulonglong),
                ("eventData", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


_P = ctypes.POINTER
# each entry point's argument types (every one returns an nvmlReturn_t)
_SIGNATURES = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlDeviceGetCount_v2": (_P(ctypes.c_uint),),
    "nvmlDeviceGetHandleByIndex_v2": (ctypes.c_uint, _P(ctypes.c_void_p)),
    "nvmlDeviceGetUUID": (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint),
    "nvmlDeviceGetName": (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint),
    "nvmlDeviceGetMinorNumber": (ctypes.c_void_p, _P(ctypes.c_uint)),
    "nvmlDeviceGetMemoryInfo": (ctypes.c_void_p, _P(_Memory)),
    "nvmlDeviceGetPciInfo_v3": (ctypes.c_void_p, _P(_PciInfo)),
    "nvmlEventSetCreate": (_P(ctypes.c_void_p),),
    "nvmlDeviceRegisterEvents": (ctypes.c_void_p, ctypes.c_ulonglong,
                                 ctypes.c_void_p),
    "nvmlEventSetWait_v2": (ctypes.c_void_p, _P(_EventData), ctypes.c_uint),
    "nvmlEventSetFree": (ctypes.c_void_p,),
}


def load_library(path: str = NVML_LIBRARY) -> ctypes.CDLL:
    """dlopen NVML and declare the signatures of the calls made here."""
    lib = ctypes.CDLL(path)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


class Nvml:
    """The NVML calls the backend makes, over ``lib`` (default
    :func:`load_library`; a test passes an object with the same entry
    points)."""

    def __init__(self, lib=None) -> None:
        self.lib = lib if lib is not None else load_library()

    def _call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(*args)
        if code != NVML_SUCCESS:
            raise NvmlError(name, code)

    def init(self) -> None:
        self._call("nvmlInit_v2")

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def count(self) -> int:
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                   ctypes.byref(h))
        return h

    def _string(self, name: str, h) -> str:
        buf = ctypes.create_string_buffer(_BUF)
        self._call(name, h, buf, ctypes.c_uint(_BUF))
        return buf.value.decode()

    def uuid(self, h) -> str:
        return self._string("nvmlDeviceGetUUID", h)

    def name(self, h) -> str:
        return self._string("nvmlDeviceGetName", h)

    def minor(self, h) -> int:
        m = ctypes.c_uint(0)
        self._call("nvmlDeviceGetMinorNumber", h, ctypes.byref(m))
        return m.value

    def memory_total(self, h) -> int:
        mem = _Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
        return mem.total

    def pci_bdf(self, h) -> str:
        """The sysfs form of the bus id (``0000:19:00.0``)."""
        pci = _PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", h, ctypes.byref(pci))
        bus = pci.busId.decode().lower()
        domain, rest = bus.split(":", 1)
        return f"{int(domain, 16):04x}:{rest}"

    def event_set(self) -> ctypes.c_void_p:
        s = ctypes.c_void_p()
        self._call("nvmlEventSetCreate", ctypes.byref(s))
        return s

    def register_xid(self, h, event_set) -> None:
        self._call("nvmlDeviceRegisterEvents", h,
                   ctypes.c_ulonglong(EVENT_XID_CRITICAL), event_set)

    def wait(self, event_set, timeout_ms: int):
        """The next event as (device handle value or None, XID), or None
        when ``timeout_ms`` passed without one."""
        data = _EventData()
        code = self.lib.nvmlEventSetWait_v2(event_set, ctypes.byref(data),
                                            ctypes.c_uint(timeout_ms))
        if code == NVML_ERROR_TIMEOUT:
            return None
        if code != NVML_SUCCESS:
            raise NvmlError("nvmlEventSetWait_v2", code)
        if not data.eventType & EVENT_XID_CRITICAL:
            return None
        return data.device, int(data.eventData)

    def free_event_set(self, event_set) -> None:
        self._call("nvmlEventSetFree", event_set)


def enumerate_gpus(nvml: Nvml, dev: str | None = None) -> list[tuple]:
    """(chip, handle value) of every GPU NVML sees, by NVML index."""
    dev = dev if dev is not None else dev_root()
    controls = tuple(os.path.join(dev, n) for n in CONTROL_NODES
                     if os.path.exists(os.path.join(dev, n)))
    out = []
    for i in range(nvml.count()):
        h = nvml.handle(i)
        minor = nvml.minor(h)
        try:
            bdf = nvml.pci_bdf(h)
        except NvmlError as e:
            # the bus id is descriptive only (Allocate never reads it);
            # a virtualized GPU may not report it
            log.info("GPU %d: no PCI info (%s)", i, e)
            bdf = None
        chip = GpuChip(index=i, chip_id=nvml.uuid(h),
                       hbm_mib=nvml.memory_total(h) // 2 ** 20,
                       generation=nvml.name(h),
                       dev_paths=(os.path.join(dev, f"nvidia{minor}"),
                                  *controls),
                       pci_bdf=bdf, minor=minor)
        out.append((chip, h.value))
    return out


class NvmlBackend(Backend):
    """The CUDA backend: NVML enumeration, XID events and a device-node
    presence poll (module docstring)."""

    def __init__(self, nvml: Nvml | None = None, dev: str | None = None,
                 proc: str | None = None, poll_interval_s: float = 1.0,
                 event_timeout_ms: int = 500) -> None:
        self._nvml = nvml if nvml is not None else Nvml()
        self._dev = dev if dev is not None else dev_root()
        self._proc = proc
        self._nvml.init()
        found = enumerate_gpus(self._nvml, self._dev)
        self._chips = [c for c, _ in found]
        self._by_handle = {h: c for c, h in found}
        self._broadcast = HealthBroadcaster()
        self._lock = threading.Lock()
        self._missing: set[str] = set()
        self._xid: dict[str, int] = {}
        self._stop = threading.Event()
        self._poll_interval_s = poll_interval_s
        self._event_timeout_ms = event_timeout_ms
        self._threads: list[threading.Thread] = []
        self._events = None
        if not self._chips:
            return
        try:
            self._events = self._nvml.event_set()
            for c, h in found:
                try:
                    self._nvml.register_xid(ctypes.c_void_p(h), self._events)
                except NvmlError as e:
                    log.warning("no XID events for %s: %s", c.chip_id, e)
        except NvmlError as e:
            log.warning("NVML events unavailable: %s", e)
            self._events = None
        if self._events is not None:
            self._threads.append(threading.Thread(
                target=self._watch_xids, name="nvml-xid", daemon=True))
        self._threads.append(threading.Thread(
            target=self._poll_presence, name="nvml-presence", daemon=True))
        for t in self._threads:
            t.start()

    def devices(self) -> list[GpuChip]:
        return list(self._chips)

    def topology(self):
        return None

    def subscribe_health(self):
        return self._broadcast.subscribe()

    def close(self) -> None:
        """Stop both health threads (each wakes within its timeout), free
        the event set and shut NVML down."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        alive = any(t.is_alive() for t in self._threads)
        if self._events is not None and not alive:
            try:
                self._nvml.free_event_set(self._events)
            except NvmlError as e:
                log.warning("nvmlEventSetFree: %s", e)
        self._events = None
        try:
            self._nvml.shutdown()
        except NvmlError as e:
            log.warning("nvmlShutdown: %s", e)

    def chip_client_pids(self, index: int) -> list[int]:
        """PIDs holding the GPU's ``/dev/nvidia<minor>`` open."""
        chip = next(c for c in self._chips if c.index == index)
        return nvidia_client_pids(chip.minor, self._dev, self._proc)

    # ---- health ---------------------------------------------------------

    def _set(self, chip: GpuChip, missing: bool | None = None,
             xid: int | None = None) -> None:
        """Update one GPU's state; publish when its health flips (an XID
        on a GPU already down is published too, with its code)."""
        with self._lock:
            before = chip.chip_id in self._missing or \
                chip.chip_id in self._xid
            if missing is True:
                self._missing.add(chip.chip_id)
            elif missing is False:
                self._missing.discard(chip.chip_id)
            if xid is not None:
                self._xid[chip.chip_id] = xid
            after = chip.chip_id in self._missing or \
                chip.chip_id in self._xid
        if xid is not None:
            self._broadcast.publish(HealthEvent(
                chip.chip_id, healthy=False, reason=f"XID {xid}", code=xid))
        elif after != before:
            self._broadcast.publish(HealthEvent(
                chip.chip_id, healthy=not after,
                reason="device node missing" if after else "recovered"))

    def _watch_xids(self) -> None:
        while not self._stop.is_set():
            try:
                ev = self._nvml.wait(self._events, self._event_timeout_ms)
            except NvmlError as e:
                log.warning("XID watch: %s", e)
                self._stop.wait(self._poll_interval_s)
                continue
            if ev is None:
                continue
            handle, xid = ev
            if xid in APPLICATION_XIDS:
                log.info("ignoring application XID %d", xid)
                continue
            chip = self._by_handle.get(handle)
            for c in ([chip] if chip is not None else self._chips):
                self._set(c, xid=xid)

    def _poll_presence(self) -> None:
        while True:
            for chip in self._chips:
                present = all(os.path.exists(p) for p in chip.dev_paths)
                self._set(chip, missing=not present)
            if self._stop.wait(self._poll_interval_s):
                return


def nvml_backend_or_none() -> NvmlBackend | None:
    """The CUDA backend when NVML loads and finds a GPU, else None (no
    NVML library on this node): what the launcher's factory asks
    first."""
    try:
        backend = NvmlBackend()
    except (OSError, NvmlError, AttributeError) as e:
        log.debug("NVML backend unavailable: %s", e)
        return None
    if backend.devices():
        return backend
    backend.close()
    return None
