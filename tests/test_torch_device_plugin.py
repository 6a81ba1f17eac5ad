"""The port's CUDA device backend behind the unchanged daemon (A.13).

- ``tpushare_torch.tpu.native.NvmlBackend`` over a stub of
  ``libnvidia-ml.so.1`` (ctypes arguments in, NVML codes out) and a fake
  ``/dev`` + ``/proc`` tree: the chip record's fields, XID events with
  the application XIDs 31 / 43 / 45 dropped, device-node loss and
  recovery, ``close()``, and ``chip_client_pids``;
- the payload side of ``TPU_VISIBLE_CHIPS`` as a pure function;
- ``scripts/torch_device_plugin.py``'s factory under ``auto`` /
  ``native`` / ``fake``, and its ``main`` running the daemon over the
  port's backend against the fake kubelet, at GiB by default, since a
  card's MiB list exceeds gRPC's default 4 MiB message;
- the unchanged ``TpuDevicePlugin`` over the port's backend, against
  ``tpushare.testing``'s fake kubelet and apiserver: ListAndWatch
  advertises ``hbm_mib`` devices at MiB, Allocate mounts
  ``/dev/nvidia<minor>`` and ``/dev/nvidiactl``;
- the same against the real NVML on a card (``cuda``).
"""

import importlib.util
import os
import queue
import time
from pathlib import Path
from types import SimpleNamespace

import grpc
import pytest

from tpushare import consts
from tpushare.deviceplugin import deviceplugin_pb2 as pb
from tpushare.deviceplugin.grpcsvc import DevicePluginStub
from tpushare.deviceplugin.server import PluginConfig, TpuDevicePlugin
from tpushare.testing.builders import make_node
from tpushare.tpu.backend import Backend as ReferenceBackend
from tpushare.tpu.backend import HealthBroadcaster as RefBroadcaster
from tpushare.tpu.backend import HealthEvent as RefEvent
from tpushare_torch.device import visible_cuda_env
from tpushare_torch.tpu import backend as tbackend
from tpushare_torch.tpu import native
from tpushare_torch.tpu.device import fake_device_ids
from tpushare_torch.tpu.kernel_stats import nvidia_clients_by_minor

REPO = Path(__file__).resolve().parents[1]
MIB = 2 ** 20
GPUS = [
    dict(uuid="GPU-11111111-2222-3333-4444-555555555555",
         name="NVIDIA H100 80GB HBM3", minor=3, total=24 * MIB + 5,
         bus=b"00000000:1A:00.0"),
    dict(uuid="GPU-aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee",
         name="NVIDIA H100 80GB HBM3", minor=0, total=16 * MIB,
         bus=b"00000000:9C:00.0"),
]
HANDLE0 = 0x1000


class StubNvml:
    """The NVML entry points the backend calls, over ``gpus``: each
    writes through the ``ctypes`` pointers it is handed, as the library
    does. XID events are queued with :meth:`xid`."""

    def __init__(self, gpus) -> None:
        self.gpus = gpus
        self.events: queue.Queue = queue.Queue()
        self.calls: list[str] = []

    def xid(self, gpu: int | None, code: int) -> None:
        self.events.put((None if gpu is None else HANDLE0 + gpu, code))

    def _gpu(self, h):
        return self.gpus[h.value - HANDLE0]

    def nvmlInit_v2(self):
        self.calls.append("init")
        return 0

    def nvmlShutdown(self):
        self.calls.append("shutdown")
        return 0

    def nvmlDeviceGetCount_v2(self, n):
        n._obj.value = len(self.gpus)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, h):
        h._obj.value = HANDLE0 + i.value
        return 0

    def nvmlDeviceGetUUID(self, h, buf, size):
        buf.value = self._gpu(h)["uuid"].encode()
        return 0

    def nvmlDeviceGetName(self, h, buf, size):
        buf.value = self._gpu(h)["name"].encode()
        return 0

    def nvmlDeviceGetMinorNumber(self, h, m):
        m._obj.value = self._gpu(h)["minor"]
        return 0

    def nvmlDeviceGetMemoryInfo(self, h, mem):
        mem._obj.total = self._gpu(h)["total"]
        return 0

    def nvmlDeviceGetPciInfo_v3(self, h, pci):
        pci._obj.busId = self._gpu(h)["bus"]
        return 0

    def nvmlEventSetCreate(self, s):
        s._obj.value = 0x77
        return 0

    def nvmlDeviceRegisterEvents(self, h, types, s):
        assert types.value == native.EVENT_XID_CRITICAL
        return 0

    def nvmlEventSetWait_v2(self, s, data, timeout):
        try:
            dev, code = self.events.get(timeout=timeout.value / 1000)
        except queue.Empty:
            return native.NVML_ERROR_TIMEOUT
        data._obj.device = dev
        data._obj.eventType = native.EVENT_XID_CRITICAL
        data._obj.eventData = code
        return 0

    def nvmlEventSetFree(self, s):
        self.calls.append("free")
        return 0


@pytest.fixture()
def devtree(tmp_path):
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia3", "nvidiactl", "nvidia-uvm"):
        (dev / name).write_text("")
    return dev


def make_backend(devtree, gpus=GPUS, **kw):
    stub = StubNvml(gpus)
    backend = native.NvmlBackend(nvml=native.Nvml(stub), dev=str(devtree),
                                 poll_interval_s=0.05, event_timeout_ms=20,
                                 **kw)
    return stub, backend


def drain(q, timeout=1.0, want=None):
    """Events from ``q`` until ``want`` of them arrived or ``timeout``."""
    got, end = [], time.monotonic() + timeout
    while time.monotonic() < end and (want is None or len(got) < want):
        try:
            got.append(q.get(timeout=0.02))
        except queue.Empty:
            pass
    return got


def test_enumeration_fields_match_the_chip_record(devtree):
    stub, backend = make_backend(devtree)
    try:
        chips = backend.devices()
        assert [c.index for c in chips] == [0, 1]
        first = chips[0]
        assert first.chip_id == GPUS[0]["uuid"]
        assert first.hbm_mib == 24          # total // 2^20, rounded down
        assert first.generation == "NVIDIA H100 80GB HBM3"
        assert first.dev_paths == (str(devtree / "nvidia3"),
                                   str(devtree / "nvidiactl"),
                                   str(devtree / "nvidia-uvm"))
        assert first.default_dev_paths == first.dev_paths
        assert first.pci_bdf == "0000:1a:00.0"
        assert first.coords is None and first.minor == 3
        assert chips[1].dev_paths[0] == str(devtree / "nvidia0")
        assert backend.topology() is None
        assert isinstance(backend, ReferenceBackend)
        assert len(fake_device_ids(first)) == 24
        assert fake_device_ids(first)[5] == f"{GPUS[0]['uuid']}-_-5"
    finally:
        backend.close()
    assert stub.calls == ["init", "free", "shutdown"]


def test_xid_events_drop_application_codes(devtree):
    stub, backend = make_backend(devtree)
    q = backend.subscribe_health()
    try:
        for code in (31, 43, 45):
            stub.xid(1, code)
        stub.xid(1, 79)
        events = drain(q, want=1)
        assert events == [tbackend.HealthEvent(GPUS[1]["uuid"], False,
                                               "XID 79", 79)]
        assert drain(q, timeout=0.2) == []
        stub.xid(None, 48)           # no device: every GPU
        events = drain(q, want=2)
        assert {e.chip_id for e in events} == {g["uuid"] for g in GPUS}
        assert all(not e.healthy and e.code == 48 for e in events)
    finally:
        backend.close()


def test_device_node_loss_and_recovery(devtree):
    _, backend = make_backend(devtree)
    q = backend.subscribe_health()
    try:
        assert drain(q, timeout=0.2) == []
        (devtree / "nvidia3").unlink()
        lost = drain(q, want=1)
        assert lost == [tbackend.HealthEvent(GPUS[0]["uuid"], False,
                                             "device node missing")]
        (devtree / "nvidia3").write_text("")
        back = drain(q, want=1)
        assert back == [tbackend.HealthEvent(GPUS[0]["uuid"], True,
                                             "recovered")]
    finally:
        t0 = time.monotonic()
        backend.close()
        assert time.monotonic() - t0 < 2.0


def test_health_types_are_the_references():
    """The port's copies hold the reference's fields and fan-out."""
    ev = tbackend.HealthEvent("GPU-x", False, "r", 79)
    assert ev == tbackend.HealthEvent(*RefEvent("GPU-x", False, "r",
                                                79).__dict__.values())
    for broadcaster in (tbackend.HealthBroadcaster(), RefBroadcaster()):
        a, b = broadcaster.subscribe(), broadcaster.subscribe()
        broadcaster.publish(ev)
        assert a.get_nowait() is ev and b.get_nowait() is ev


def test_chip_client_pids_walks_proc(devtree, tmp_path):
    proc = tmp_path / "proc"
    for pid, targets in {"101": ["nvidia3", "nvidiactl"],
                         "202": ["nvidia0"], "303": ["nvidia3"],
                         "self": ["nvidia3"]}.items():
        fd = proc / pid / "fd"
        fd.mkdir(parents=True)
        for i, name in enumerate(targets):
            os.symlink(devtree / name, fd / str(i))
    (proc / "404").mkdir()           # no fd dir: skipped
    _, backend = make_backend(devtree, proc=str(proc))
    try:
        assert sorted(backend.chip_client_pids(0)) == [101, 303]
        assert backend.chip_client_pids(1) == [202]
    finally:
        backend.close()
    assert nvidia_clients_by_minor([3, 7], str(devtree),
                                   str(proc))[7] == []


CHIPS_ENV = consts.ENV_TPU_VISIBLE_CHIPS


@pytest.mark.parametrize("env,want", [
    ({CHIPS_ENV: "1"},
     {"CUDA_DEVICE_ORDER": "PCI_BUS_ID", "CUDA_VISIBLE_DEVICES": "1"}),
    ({CHIPS_ENV: "0, 2"},
     {"CUDA_DEVICE_ORDER": "PCI_BUS_ID", "CUDA_VISIBLE_DEVICES": "0,2"}),
    ({CHIPS_ENV: "1", "CUDA_VISIBLE_DEVICES": "0"}, {}),
    ({CHIPS_ENV: consts.ERR_VISIBLE_DEVICES_FMT.format(amount=4,
                                                       unit="MiB")}, {}),
    ({CHIPS_ENV: ""}, {}),
    ({}, {}),
])
def test_visible_chips_map_to_cuda_visible_devices(env, want):
    assert visible_cuda_env(env) == want


def _launcher():
    spec = importlib.util.spec_from_file_location(
        "torch_device_plugin", REPO / "scripts" / "torch_device_plugin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend,found,want", [
    ("auto", True, "nvml"), ("native", True, "nvml"),
    ("auto", False, "daemon"), ("native", False, "daemon"),
    ("fake", True, "FakeBackend"),
])
def test_launcher_factory(backend, found, want):
    launcher = _launcher()
    args = SimpleNamespace(backend=backend, fake_chips=2,
                           fake_generation="v5p", fake_hbm_mib=8)
    sentinel = object()
    factory = launcher.make_backend_factory(
        args, probe=lambda: sentinel if found else None)
    got = factory()
    if want == "nvml":
        assert got is sentinel
    elif want == "FakeBackend":
        assert type(got).__name__ == "FakeBackend"
        got.close()
    else:
        # the daemon's own native path: no TPU here, so no backend
        assert got is None or type(got).__name__ == "NativeBackend"
        if got is not None:
            got.close()


# an H100 80GB's NVML total: 81,559 MiB devices at the daemon's MiB
H100 = dict(GPUS[0], total=81559 * MIB)


def run_launcher(devtree, fake_kubelet, apiserver, monkeypatch, plugin_dir,
                 flags: list, gpu: dict) -> tuple:
    """``scripts/torch_device_plugin.py``'s ``main`` with the daemon's own
    flags (``--backend native`` and ``flags``) over a stub card ``gpu``,
    until the fake kubelet has read one list and made one Allocate."""
    import threading

    from tpushare.cmd import device_plugin
    launcher = _launcher()
    _, backend = make_backend(devtree, gpus=[gpu])
    chip = backend.devices()[0]
    monkeypatch.setattr(launcher.native, "nvml_backend_or_none",
                        lambda: backend)
    # main's probe closes the backend it found; the factory returns it again
    monkeypatch.setattr(backend, "close", lambda: None)
    # main() rebinds the daemon's factory for its process; restored after
    monkeypatch.setattr(device_plugin, "make_backend_factory",
                        device_plugin.make_backend_factory)
    managers = []

    class Manager(device_plugin.TpuShareManager):
        """The daemon's manager, off the main thread (no signals)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, install_signals=False, **kw)
            managers.append(self)
    monkeypatch.setattr(device_plugin, "TpuShareManager", Manager)
    apiserver.add_node(make_node("node-1", tpu_hbm=chip.hbm_mib,
                                 tpu_count=1))
    daemon = threading.Thread(target=launcher.main, args=([
        "--backend", "native", "--node-name", "node-1",
        "--device-plugin-path", plugin_dir, "--no-informer",
        "--apiserver-url", f"http://127.0.0.1:{apiserver.port}", *flags],),
        daemon=True)
    daemon.start()
    try:
        first, cr = list_and_allocate(fake_kubelet, chip)
    finally:
        for m in managers:
            m.stop()
        daemon.join(timeout=10.0)
        monkeypatch.undo()
        backend.close()
    assert not daemon.is_alive()
    return chip, first, cr


@pytest.mark.parametrize("flags,gpu,unit_mib", [
    (["--memory-unit", "MiB"], GPUS[0], 1),
    # no unit flag: an H100's list in GiB (79 devices), which reaches a
    # client with gRPC's default 4 MiB receive limit
    ([], H100, 1024),
], ids=["mib", "gib-by-default"])
def test_launcher_runs_the_unchanged_daemon_over_the_port_backend(
        devtree, plugin_dir, fake_kubelet, apiserver, monkeypatch, flags,
        gpu, unit_mib):
    """The daemon registers with the fake kubelet and advertises the NVML
    backend's chip, at MiB when told, at GiB by default."""
    chip, first, cr = run_launcher(devtree, fake_kubelet, apiserver,
                                   monkeypatch, plugin_dir, flags, gpu)
    n = chip.hbm_mib // unit_mib
    assert len(first.devices) == n
    # a GiB device list is the MiB list's first ids
    assert {d.ID for d in first.devices} == set(fake_device_ids(chip)[:n])
    assert cr.envs[consts.ENV_TPU_VISIBLE_CHIPS] == str(chip.index)
    assert [d.host_path for d in cr.devices][:2] == [
        str(devtree / "nvidia3"), str(devtree / "nvidiactl")]


def served_plugin(backend, plugin_dir, apiserver, api, hbm_mib):
    apiserver.add_node(make_node("node-1", tpu_hbm=hbm_mib, tpu_count=1))
    cfg = PluginConfig(node="node-1", device_plugin_path=plugin_dir,
                       use_informer=False)
    plugin = TpuDevicePlugin(backend, cfg, api=api)
    plugin.serve()
    return plugin


def list_and_allocate(fake_kubelet, chip, max_receive: int | None = None
                      ) -> tuple:
    """ListAndWatch's first list and one Allocate of 2 units, over a
    channel with gRPC's default receive limit (4 MiB), as the kubelet's
    device-plugin client has it, or ``max_receive`` bytes."""
    assert fake_kubelet.registered.wait(5.0)
    sock = os.path.join(fake_kubelet.dir,
                        fake_kubelet.registrations[-1].endpoint)
    channel = grpc.insecure_channel(
        f"unix:{sock}", options=[] if max_receive is None else [
            ("grpc.max_receive_message_length", max_receive)])
    try:
        grpc.channel_ready_future(channel).result(timeout=5.0)
        stub = DevicePluginStub(channel)
        stream = stub.ListAndWatch(pb.Empty())
        first = next(stream)
        stream.cancel()
        ids = [d.ID for d in first.devices[:2]]
        resp = stub.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devicesIDs=ids)]))
    finally:
        channel.close()
    return first, resp.container_responses[0]


def test_unchanged_daemon_serves_the_port_backend(devtree, plugin_dir,
                                                  fake_kubelet, apiserver,
                                                  api):
    _, backend = make_backend(devtree, gpus=GPUS[:1])
    chip = backend.devices()[0]
    plugin = served_plugin(backend, plugin_dir, apiserver, api, chip.hbm_mib)
    try:
        first, cr = list_and_allocate(fake_kubelet, chip)
    finally:
        plugin.stop()
        backend.close()
    assert len(first.devices) == chip.hbm_mib
    assert all(d.health == "Healthy" for d in first.devices)
    assert {d.ID for d in first.devices} == set(fake_device_ids(chip))
    assert cr.envs[consts.ENV_TPU_VISIBLE_CHIPS] == str(chip.index)
    assert cr.envs[consts.ENV_TPU_VISIBLE_DEVICES] == chip.chip_id
    paths = [d.host_path for d in cr.devices]
    assert paths[:2] == [str(devtree / "nvidia3"), str(devtree / "nvidiactl")]
    assert [d.container_path for d in cr.devices] == paths


def test_mib_list_of_an_h100_exceeds_grpc_default_limit(devtree, plugin_dir,
                                                       fake_kubelet,
                                                       apiserver, api):
    """Why the launcher defaults to GiB: at MiB an H100's 81,559 devices
    make one ListAndWatch message of about 4.96 MB, which a client with
    gRPC's default receive limit refuses."""
    _, backend = make_backend(devtree, gpus=[H100])
    chip = backend.devices()[0]
    plugin = served_plugin(backend, plugin_dir, apiserver, api, chip.hbm_mib)
    try:
        with pytest.raises(grpc.RpcError) as err:
            list_and_allocate(fake_kubelet, chip)
    finally:
        plugin.stop()
        backend.close()
    assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    size = pb.ListAndWatchResponse(devices=[
        pb.Device(ID=i, health="Healthy")
        for i in fake_device_ids(chip)]).ByteSize()
    assert size > 4 * MIB


@pytest.mark.cuda
def test_unchanged_daemon_serves_the_real_card(plugin_dir, fake_kubelet,
                                               apiserver, api):
    """The same over the real NVML and /dev: one record per GPU, its
    MiB NVML's total, the whole card advertised at MiB."""
    try:
        native.load_library()
    except OSError:
        pytest.skip("no NVML library (libnvidia-ml.so.1) on this host")
    backend = native.NvmlBackend()
    nvml = native.Nvml()
    total = nvml.memory_total(nvml.handle(0))
    chip = backend.devices()[0]
    assert chip.hbm_mib == total // MIB and chip.chip_id.startswith("GPU-")
    assert all(os.path.exists(p) for p in chip.dev_paths)
    assert chip.dev_paths[:2] == (f"/dev/nvidia{chip.minor}",
                                  "/dev/nvidiactl")
    q = backend.subscribe_health()
    if len(backend.devices()) > 1:
        backend.close()
        pytest.skip("the daemon's single-chip Allocate path needs one GPU")
    plugin = served_plugin(backend, plugin_dir, apiserver, api, chip.hbm_mib)
    try:
        # the whole card at MiB needs a wider channel than the kubelet's
        # (test_mib_list_of_an_h100_exceeds_grpc_default_limit)
        first, cr = list_and_allocate(fake_kubelet, chip,
                                      max_receive=256 * MIB)
    finally:
        plugin.stop()
        backend.close()
    assert len(first.devices) == chip.hbm_mib
    assert cr.envs[consts.ENV_TPU_VISIBLE_CHIPS] == str(chip.index)
    assert [d.host_path for d in cr.devices][:2] == list(chip.dev_paths[:2])
    assert all(e.healthy for e in drain(q, timeout=0.1))
