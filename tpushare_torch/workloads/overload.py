"""Overload vocabulary of the port — the subset of the reference's
``tpushare/workloads/overload.py`` that this slice's engine and page
allocator use: the terminal request statuses, the KV cost figure, and
the out-of-memory test. The admission controller, watchdog, deadlines
and drain come with a later slice."""

from __future__ import annotations

import torch

from tpushare_torch.consts import (STATUS_COMPLETED,  # noqa: F401 (re-export)
                                   STATUS_DEADLINE_EXCEEDED,
                                   STATUS_OOM_QUARANTINED, STATUS_SHED,
                                   TERMINAL_STATUSES)


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
