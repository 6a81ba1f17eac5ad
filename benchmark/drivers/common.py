"""What both drivers share: the port's config from a configuration
file, device helpers, and freeing the program's state before the
reference runs."""

from __future__ import annotations

import gc
import time

import torch


def port_config(m: dict, max_seq: int, **fields):
    """The port's ``TransformerConfig`` for a configuration's sizes."""
    from tpushare_torch.workloads.models.transformer import TransformerConfig
    return TransformerConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=m["n_layers"], d_ff=m["d_ff"], max_seq=max_seq,
        rope_theta=m["rope_theta"], dtype=m["dtype"],
        n_kv_heads=None if m["kv_heads"] == m["n_heads"] else m["kv_heads"],
        **fields)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def now() -> float:
    return time.perf_counter()


def free_device(device) -> None:
    """After the program's state is dropped: collect and give the
    allocator's cache back, so the reference finds the room."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(device) -> tuple[int | None, int | None]:
    """(max allocated, max reserved) since the process started; None
    off the card."""
    if torch.device(device).type != "cuda":
        return None, None
    return (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def launches():
    """The port's per-kernel launch counters and fallback counts."""
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.ops import registry
    return dict(build.LAUNCHES), registry.fallback_counts_flat()


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}
