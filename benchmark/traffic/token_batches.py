"""Training batches: (batch, seq + 1) token ids drawn uniformly from
the vocabulary on the device, one generator per step index, so every
step's rows differ and step ``k`` of a seed is always the same rows.
Inputs are ids[:, :-1], targets ids[:, 1:]."""

from __future__ import annotations

import torch

from benchmark.weights import generator


def make_batch(mix: dict, seed: int, index: int, vocab: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S = int(mix["batch"]), int(mix["seq"])
    ids = torch.randint(0, vocab, (B, S + 1),
                        generator=generator(seed, f"batch:{index}", device),
                        device=device, dtype=torch.int64)
    return ids[:, :-1], ids[:, 1:]


def tokens_per_step(mix: dict) -> int:
    return int(mix["batch"]) * int(mix["seq"])
