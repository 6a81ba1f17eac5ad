#!/usr/bin/env python3
"""The device-plugin daemon on a GPU node: ``tpushare.cmd.device_plugin``
as it is, with the CUDA backend of the PyTorch port behind it.

    python scripts/torch_device_plugin.py --backend native \
        --device-plugin-path /var/lib/kubelet/device-plugins/ ...

Takes the daemon's own flags. In this process it rebinds
``device_plugin.make_backend_factory`` to a factory that, under
``--backend native`` or ``auto``, returns ``tpushare_torch.tpu.native.
NvmlBackend`` when NVML finds GPUs (enumeration through NVML only: no
CUDA context, so the daemon holds none of the memory it sells) and
otherwise defers to the daemon's own factory; ``--backend fake`` is the
daemon's own. No file of the daemon is edited. This is the one program
outside the tests that imports both packages.

Where NVML finds a GPU and neither ``--memory-unit`` nor
``--hbm-chunk-mib`` is given, the daemon runs at ``--memory-unit GiB``,
upstream gpushare's default on GPU nodes: at the daemon's default MiB a
card's device list (81,559 devices, about 4.96 MB, on an H100 80GB)
exceeds the 4 MiB message that gRPC, and so the kubelet's device-plugin
client, receives by default. Pods then request the resource in GiB.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpushare import consts  # noqa: E402
from tpushare.cmd import device_plugin  # noqa: E402
from tpushare_torch.tpu import native  # noqa: E402

_daemon_factory = device_plugin.make_backend_factory


def make_backend_factory(args, probe=None):
    """The daemon's factory with the CUDA backend first (``probe``,
    default ``native.nvml_backend_or_none``, returns it, or None where
    NVML finds no GPU)."""
    fallback = _daemon_factory(args)

    def factory():
        if args.backend in ("native", "auto"):
            backend = (probe or native.nvml_backend_or_none)()
            if backend is not None:
                return backend
        return fallback()
    return factory


def _unit_given(argv: list[str]) -> bool:
    """Whether ``argv`` sets the advertised unit (any spelling argparse
    takes)."""
    parser = device_plugin.build_parser()
    parser.set_defaults(memory_unit=None, hbm_chunk_mib=None)
    args = parser.parse_args(argv)
    return args.memory_unit is not None or args.hbm_chunk_mib is not None


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not _unit_given(argv) and \
            device_plugin.build_parser().parse_args(argv).backend != "fake":
        backend = native.nvml_backend_or_none()
        if backend is not None:
            backend.close()
            print("tpushare-device-plugin: GPUs found, advertising HBM at "
                  "--memory-unit GiB (a card's MiB device list exceeds "
                  "gRPC's 4 MiB message; pass --memory-unit MiB or "
                  "--hbm-chunk-mib to choose)", file=sys.stderr)
            argv += ["--memory-unit", consts.GIB]
    device_plugin.make_backend_factory = make_backend_factory
    return device_plugin.main(argv)


if __name__ == "__main__":
    sys.exit(main())
