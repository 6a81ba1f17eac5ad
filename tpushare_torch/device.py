"""Device resolution shared by the port's entry points, and the unit
math of the Allocate env contract (the reference's
``tpushare/tpu/device.py:138-152``)."""

from __future__ import annotations

import torch

from tpushare_torch import consts


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; a
    host without CUDA raises instead of carrying on quietly on the CPU —
    a caller that wants the plain-PyTorch CPU path asks for it with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain-PyTorch path on the CPU")
    return dev


def visible_cuda_env(environ) -> dict[str, str]:
    """The CUDA envs that pin a payload to the chips Allocate granted:
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` (CUDA's indices in NVML's PCI bus
    order, the index the port's device backend advertises) and
    ``CUDA_VISIBLE_DEVICES`` = ``TPU_VISIBLE_CHIPS`` — which libtpu
    honours and CUDA does not. Empty when Allocate set no chip list (or
    a poisoned one) or the caller already chose ``CUDA_VISIBLE_DEVICES``.
    Without it, a pod under the common ``NVIDIA_VISIBLE_DEVICES=all``
    runtime would allocate on ``cuda:0``, whichever chip the extender
    chose."""
    chips = [c.strip() for c in
             environ.get(consts.ENV_TPU_VISIBLE_CHIPS, "").split(",")]
    if environ.get("CUDA_VISIBLE_DEVICES") is not None or \
            not all(c.isdigit() for c in chips):
        return {}
    return {"CUDA_DEVICE_ORDER": "PCI_BUS_ID",
            "CUDA_VISIBLE_DEVICES": ",".join(chips)}


def apply_visible_chips(environ=None) -> dict[str, str]:
    """Set :func:`visible_cuda_env` in this process's environment; call
    it before the first CUDA call (CUDA reads them once, when it
    initializes). Returns what was set."""
    import os
    env = os.environ if environ is None else environ
    update = visible_cuda_env(env)
    env.update(update)
    return update


def chunk_mib_for(memory_unit: str = consts.MIB, chunk_mib: int | None = None
                  ) -> int:
    """MiB one resource unit of the Allocate env contract stands for."""
    if chunk_mib is not None:
        if chunk_mib <= 0:
            raise ValueError(f"chunk_mib must be positive, got {chunk_mib}")
        return chunk_mib
    if memory_unit == consts.GIB:
        return 1024
    if memory_unit == consts.MIB:
        return 1
    raise ValueError(f"unknown memory unit {memory_unit!r}")


def units_to_mib(units: int, memory_unit: str = consts.MIB,
                 chunk_mib: int | None = None) -> int:
    """A unit-scaled HBM figure of the env contract in MiB."""
    return units * chunk_mib_for(memory_unit, chunk_mib)


def memory_fraction(limit_mib: float, total_mib: float) -> float:
    """The share of the card a pod's HBM grant allows: ``limit / total``
    clamped to [0, 1], then floored at the 4th decimal so co-resident
    fractions never sum past 1 — the reference's rule
    (``tpushare/deviceplugin/allocate.py:71-92``, the fraction it writes
    into ``XLA_PYTHON_CLIENT_MEM_FRACTION``). A card of unknown size
    allows all of it."""
    frac = max(0.0, min(1.0, limit_mib / total_mib)) if total_mib else 1.0
    return int(frac * 10_000) / 10_000


def apply_hbm_cap(devices, limit_mib: float, environ=None) -> float | None:
    """Cap this process's PyTorch caching allocator on each of
    ``devices`` (one device or a list: every card a sharded payload's
    mesh allocates on, a repeated card capped once) at the pod's HBM
    grant, before the payload's first allocation: an allocation that
    would take the process past the cap on a card raises
    ``torch.cuda.OutOfMemoryError`` instead of taking memory from the
    card's other tenants — as the reference's
    ``XLA_PYTHON_CLIENT_MEM_FRACTION`` holds every device of its client.

    The fraction is the one Allocate handed the container
    (``XLA_PYTHON_CLIENT_MEM_FRACTION``) when present, else
    :func:`memory_fraction` of ``limit_mib`` over each card's total
    memory. ``TPUSHARE_DISABLE_ISOLATION=true`` (the node label that
    turns isolation off) skips the cap, as do devices that are not CUDA
    devices. The cap is per process and lasts for the process's life;
    it covers the caching allocator, not the CUDA context or memory
    taken outside PyTorch. Prints one ``allocator cap:`` line and
    returns the smallest fraction set (None when skipped)."""
    import os
    env = os.environ if environ is None else environ
    devs = ([torch.device(devices)]
            if isinstance(devices, (str, torch.device))
            else [torch.device(d) for d in devices])
    if not devs or any(d.type != "cuda" for d in devs):
        return None
    if env.get(consts.ENV_DISABLE_ISOLATION) == "true":
        print(f"allocator cap: off ({consts.ENV_DISABLE_ISOLATION}=true)",
              flush=True)
        return None
    indices = []
    for d in devs:
        d = resolve_device(d)
        index = d.index if d.index is not None else torch.cuda.current_device()
        if index not in indices:
            indices.append(index)
    given = env.get(consts.ENV_XLA_MEM_FRACTION)
    fracs, cards = [], []
    for index in indices:
        total_mib = torch.cuda.get_device_properties(index).total_memory / 2**20
        frac = (float(given) if given is not None
                else memory_fraction(limit_mib, total_mib))
        torch.cuda.set_per_process_memory_fraction(frac, index)
        fracs.append(frac)
        cards.append(f"cuda:{index} ({frac * total_mib:.0f} of "
                     f"{total_mib:.0f} MiB)")
    print(f"allocator cap: {consts.ENV_XLA_MEM_FRACTION}={min(fracs):.4f} "
          f"on {', '.join(cards)}, "
          f"{'from Allocate' if given is not None else 'from the limit'}; "
          "PyTorch's caching allocator only, not the CUDA context",
          flush=True)
    return min(fracs)
