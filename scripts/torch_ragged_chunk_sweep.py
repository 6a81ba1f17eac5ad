#!/usr/bin/env python3
"""Device time of the ragged decode read (K4, K4-int8) at several chunk
lengths, at the smoke's shapes.

    python scripts/torch_ragged_chunk_sweep.py [--chunks N ...]
        [--source FILE ...] [--cases LABEL ...]

``kernels/ragged_decode.cu`` reads each slot in chunks of ``CHUNK``
rows, a compile-time constant. This script rewrites that constant in a
copy of the repository's source for each length asked for (default 64,
128, 256 and 512), compiles every copy with the build's own flags into
its own library under ``kernels/_build/timing/``, all ``nvcc`` processes
started together, and loads each with ``ctypes``. ``--source`` adds
other ``ragged_decode.cu`` sources, built as they are (a variant of the
design to time beside the repository's; the workspace is sized by the
``CHUNK`` each source declares). The copies are for choosing the
constant and are never part of the port.

For each case of ``chip_smoke.RAGGED_CASES`` (default: all, or the
labels given) and each rung (the case's dtype, then int8 ``{q, s}``
caches quantized from the same draws; ``chip_smoke.ragged_inputs`` from
a fixed seed), every library's output is held against
``ragged_decode_plain`` element by element (``chip_smoke.elem_rel_err``,
which ``FWD_TOL`` / ``INT8_TOL`` bound) and timed with
``chip_smoke.time_ms`` in turns (first to last, then last to first), so
that the lengths are compared within one run on one card.

Prints one JSON line per (case, rung, library, turn). Needs a CUDA device
and ``nvcc``; exits non-zero without them or when a copy does not
compile.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CHUNK_LINE = re.compile(r"^constexpr int CHUNK = (\d+);", re.MULTILINE)


def compile_all(build, sources: dict[str, str]) -> dict[str, Path]:
    """Build one library per (name -> source text); returns their paths."""
    out_dir = build.BUILD_DIR / "timing"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    headers = b"".join((build.KERNEL_DIR / h).read_bytes()
                       for h in build.HEADERS)
    procs, paths = {}, {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode() + headers).hexdigest()[:12]
        src = out_dir / f"ragged_decode-{digest}.cu"
        src.write_text(text)
        paths[name] = out_dir / f"ragged_decode-{digest}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-I{build.KERNEL_DIR}", "-o",
               str(paths[name]), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
    return paths


def load(build, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in build._SIGNATURES["ragged_decode"].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpushare_cuda_error.argtypes = [ctypes.c_int]
    lib.tpushare_cuda_error.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[64, 128, 256, 512],
                    help="values of CHUNK to build and time")
    ap.add_argument("--source", type=Path, nargs="*", default=[],
                    help="other ragged_decode.cu sources to time as they "
                         "are")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="labels of chip_smoke.RAGGED_CASES (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ragged_chunk_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import (FWD_TOL, INT8_TOL, RAGGED_CASES, elem_rel_err,
                            ragged_inputs, time_ms)
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.ops.ragged_decode import ragged_decode_plain

    own = (build.KERNEL_DIR / build.SOURCES["ragged_decode"]).read_text()
    sources = {f"chunk={c}": CHUNK_LINE.sub(f"constexpr int CHUNK = {c};",
                                            own)
               for c in args.chunks}
    for path in args.source:
        sources[str(path)] = path.read_text()
    chunk_of = {}
    for name, text in sources.items():
        found = CHUNK_LINE.search(text)
        if not found:
            raise SystemExit(f"{name} declares no CHUNK constant")
        chunk_of[name] = int(found.group(1))
    libs = {n: load(build, p) for n, p in compile_all(build, sources).items()}

    cases = [c for c in RAGGED_CASES
             if args.cases is None or c[0] in args.cases]
    for label, B, S, H, Hkv, dtype in cases:
        for int8 in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(31)
            q, k, v, lens = ragged_inputs(torch, gen, label, B, S, H, Hkv,
                                          dtype, int8)
            kq, vq = (k["q"], v["q"]) if int8 else (k, v)
            ks, vs = ((k["s"].data_ptr(), v["s"].data_ptr()) if int8
                      else (None, None))
            hd = q.shape[-1]
            want = ragged_decode_plain(q, k, v, lens)
            tol = (INT8_TOL if int8 else FWD_TOL)[dtype]
            out = torch.empty_like(q)

            def launcher(lib, chunk):
                n_chunks = -(-S // chunk)
                ws = (torch.empty(B * H * n_chunks * (hd + 2),
                                  dtype=torch.float32, device="cuda")
                      if n_chunks > 1 else None)

                def launch():
                    rc = lib.tpushare_ragged_decode(
                        q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
                        lens.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), n_chunks, B,
                        S, H, Hkv, hd, int(q.dtype == torch.bfloat16),
                        int(int8), hd ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                    build.check(lib, "ragged_decode", rc)
                return launch, n_chunks

            order = list(libs) + list(reversed(libs))
            for turn, name in enumerate(order):
                chunk = chunk_of[name]
                launch, n_chunks = launcher(libs[name], chunk)
                launch()
                torch.cuda.synchronize()
                rel = elem_rel_err(out, want)
                if not rel <= tol:
                    raise SystemExit(f"{label} int8={int8} {name}: "
                                     f"{rel} of the value > {tol}")
                print(json.dumps({
                    "case": label, "rung": "int8" if int8 else dtype,
                    "library": name, "chunk_rows": chunk,
                    "ctas": n_chunks * Hkv * B,
                    "turn": turn, "ms": time_ms(launch), "rel_err": rel}),
                    flush=True)
            del q, k, v, kq, vq, want, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
