#!/usr/bin/env python3
"""Device time of the port's two decode reads, at the smoke's shapes.

    python scripts/torch_decode_timing.py [--repo DIR]

Times ``ops.ragged_decode.ragged_decode_attention`` (K4) and
``ops.paged_attention.paged_decode`` (K5) on the cases and inputs of
``chip_smoke.py`` (``RAGGED_CASES`` / ``ragged_inputs``, ``PAGED_CASES``
/ ``paged_inputs``): each on its bf16/fp32 rung and, where the checkout
has them, its int8 rung (the same draws quantized). Inputs come from
fixed seeds, so two checkouts time the same work: ``--repo`` imports the
package from another checkout (for example the parent commit unpacked
with ``git archive``), which builds its own kernels. Compare two
checkouts only within one machine session, in turns (parent, change,
change, parent).

Prints one JSON line per (kernel, case, q dtype, rung): the median
device time of 20 calls with the stream held busy
(``chip_smoke.time_ms``). Needs a CUDA device; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", type=Path, default=REPO,
                    help="checkout whose tpushare_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import (PAGED_CASES, RAGGED_CASES, paged_inputs,
                            ragged_inputs, time_ms)
    sys.path.insert(0, str(args.repo.resolve()))
    from tpushare_torch.workloads import decode
    from tpushare_torch.workloads.ops.paged_attention import paged_decode
    from tpushare_torch.workloads.ops.ragged_decode import (
        ragged_decode_attention)
    rungs = [False, True] if hasattr(decode, "kv_quantize") else [False]

    def emit(kernel, case, dtype, int8, ms):
        print(json.dumps({"kernel": kernel, "case": case, "q": dtype,
                          "rung": "int8" if int8 else dtype, "ms": ms}),
              flush=True)

    for label, B, S, H, Hkv, dtype in RAGGED_CASES:
        for int8 in rungs:
            gen = torch.Generator(device="cuda").manual_seed(31)
            q, k, v, lens = ragged_inputs(torch, gen, label, B, S, H, Hkv,
                                          dtype, int8)
            emit("ragged_decode", label, dtype, int8,
                 time_ms(lambda: ragged_decode_attention(q, k, v, lens)))
            del k, v
            torch.cuda.empty_cache()
    for label, B, H, Hkv, hd, ps, P, max_len, short_max, dtype in \
            PAGED_CASES:
        for int8 in rungs:
            gen = torch.Generator(device="cuda").manual_seed(32)
            q1, k, v, tables, kv_lens = paged_inputs(
                torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max, dtype,
                int8)
            emit("paged_decode", label, dtype, int8,
                 time_ms(lambda: paged_decode(q1, k, v, tables, kv_lens)))
            del q1, k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
