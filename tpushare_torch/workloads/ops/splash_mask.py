"""Block schedules of the splash kernels: which (query block, key block)
pairs the causal mask touches, and how.

The port's own copy of what the splash kernels need from the upstream
mask machinery (``jax/experimental/pallas/ops/tpu/splash_attention/
splash_attention_mask_info.py``: ``process_mask`` and
``process_mask_dkv``), for the one mask the reference builds in
``tpushare/workloads/ops/registry.py::_build_prefill_splash``:
``MultiHeadMask([CausalMask((S, S))] * H)``.

Each block of the (S / block) x (S / block) grid is skipped (the mask
keeps none of its pairs), *partial* (the kernel applies the causal mask
inside it) or *full* (no mask) — upstream's ``block_mask`` codes 0, 1
and 2. A schedule lists, for each row of blocks, the live blocks in
order, each with its kind; skipped blocks are absent, so a kernel never
reads them:

- the forward / dQ schedule: for each query block, its key blocks;
- the dK/dV schedule: for each key block, the query blocks that see it.

Both are int32 tensors in compressed-row form on the caller's device,
built once per (S, block, device) and shared by every head and batch
row, as upstream deduplicates identical head masks.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

MIN_BLOCK = 128    # the least block edge; a splash S must be a multiple
MAX_BLOCK = 512    # the reference's block where it tiles
SKIP, PARTIAL, FULL = 0, 1, 2   # upstream block_mask codes


def splash_block(seq: int) -> int:
    """The reference's ``_splash_block``: 512 where it tiles ``seq``, else
    the largest power-of-two divisor >= 128 (128 when none tiles)."""
    b = MAX_BLOCK
    while b > MIN_BLOCK and seq % b:
        b //= 2
    return b


def block_kinds(seq: int, block: int) -> np.ndarray:
    """(n, n) int8 kinds of the causal mask's blocks, n = seq / block,
    indexed [query block, key block]: full where every key of the block
    precedes every query, skipped where every key follows every query."""
    if seq % block:
        raise ValueError(f"seq {seq} does not tile block {block}")
    n = seq // block
    i = np.arange(n)[:, None]            # query block
    j = np.arange(n)[None, :]            # key block
    first_q, last_q = i * block, (i + 1) * block - 1
    first_k, last_k = j * block, (j + 1) * block - 1
    kinds = np.full((n, n), PARTIAL, np.int8)
    kinds[last_k <= first_q] = FULL
    kinds[first_k > last_q] = SKIP
    return kinds


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Live blocks per row of blocks, in compressed-row form: row r's
    entries are ``blocks[offsets[r]:offsets[r + 1]]`` (ascending block
    indices) with ``kinds`` PARTIAL or FULL; int32 tensors."""

    block: int
    offsets: torch.Tensor      # (n + 1,)
    blocks: torch.Tensor       # (live,)
    kinds: torch.Tensor        # (live,)


def _compress(kinds: np.ndarray, block: int,
              device: torch.device) -> BlockSchedule:
    rows, cols = np.nonzero(kinds)       # row-major: ascending per row
    offsets = np.zeros(kinds.shape[0] + 1, np.int32)
    np.cumsum(np.count_nonzero(kinds, axis=1), out=offsets[1:])

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return BlockSchedule(block=block, offsets=t(offsets), blocks=t(cols),
                         kinds=t(kinds[rows, cols]))


@functools.lru_cache(maxsize=None)
def _schedules(seq: int, block: int,
               device: torch.device) -> tuple[BlockSchedule, BlockSchedule]:
    kinds = block_kinds(seq, block)
    return (_compress(kinds, block, device),
            _compress(np.ascontiguousarray(kinds.T), block, device))


def fwd_schedule(seq: int, device: torch.device | str) -> BlockSchedule:
    """The forward / dQ schedule at the reference's block: per query
    block, its key blocks."""
    return _schedules(seq, splash_block(seq), torch.device(device))[0]


def dkv_schedule(seq: int, device: torch.device | str) -> BlockSchedule:
    """The dK/dV schedule at the reference's block: per key block, the
    query blocks that see it."""
    return _schedules(seq, splash_block(seq), torch.device(device))[1]
