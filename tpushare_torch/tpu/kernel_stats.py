"""Who holds a GPU open — the port's copy of
``tpushare/tpu/kernel_stats.py``'s ``accel_client_pids``, for
``/dev/nvidia<minor>``: the kernel knows every client of a device node,
readable by walking ``/proc/<pid>/fd`` symlinks (how ``fuser`` and
``lsof`` work), with no cooperation from the payload. Roots are
overridable for tests (``TPUSHARE_DEV_ROOT``, ``TPUSHARE_PROC_ROOT``).
"""

from __future__ import annotations

import os


def dev_root() -> str:
    return os.environ.get("TPUSHARE_DEV_ROOT", "/dev")


def proc_root() -> str:
    return os.environ.get("TPUSHARE_PROC_ROOT", "/proc")


def nvidia_clients_by_minor(minors, dev: str | None = None,
                            proc: str | None = None) -> dict[int, list[int]]:
    """{minor: PIDs with /dev/nvidia<minor> open} in one /proc walk.
    Unreadable entries (permissions, processes exiting) are skipped."""
    dev = dev if dev is not None else dev_root()
    proc = proc if proc is not None else proc_root()
    targets = {os.path.join(dev, f"nvidia{m}"): m for m in minors}
    out: dict[int, list[int]] = {m: [] for m in minors}
    try:
        entries = os.listdir(proc)
    except OSError:
        return out
    for ent in entries:
        if not ent.isdigit():
            continue
        fd_dir = os.path.join(proc, ent, "fd")
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue
        hit: set[int] = set()
        for fd in fds:
            try:
                m = targets.get(os.readlink(os.path.join(fd_dir, fd)))
            except OSError:
                continue
            if m is not None:
                hit.add(m)
        for m in hit:
            out[m].append(int(ent))
    return out


def nvidia_client_pids(minor: int, dev: str | None = None,
                       proc: str | None = None) -> list[int]:
    """Single-GPU convenience over :func:`nvidia_clients_by_minor`."""
    return nvidia_clients_by_minor([minor], dev, proc)[minor]
