#!/usr/bin/env python3
"""Device time of the split decode reads — the ragged read (K4, K4-int8)
and the paged read (K5, K5-int8) — at several chunk lengths, at the
smoke's shapes.

    python scripts/torch_decode_chunk_sweep.py [--read ragged|paged]
        [--chunks N ...] [--source FILE ...] [--cases LABEL ...]

``kernels/ragged_decode.cu`` reads each slot, and
``kernels/paged_decode.cu`` each lane, in chunks of ``CHUNK`` rows, a
compile-time constant. This script rewrites that constant in a copy of
the repository's source of the read asked for (``--read``, default
``ragged``) for each length asked for (default 64, 128, 256 and 512),
compiles every copy with the build's own flags into its own library
under ``kernels/_build/timing/``, all ``nvcc`` processes started
together, and loads each with ``ctypes``. ``--source`` adds other
sources of the same read, built as they are (a variant of the design to
time beside the repository's; the workspace is sized by the ``CHUNK``
each source declares). The copies are for choosing the constant and are
never part of the port.

For each case of the smoke's table (``chip_smoke.RAGGED_CASES`` or
``PAGED_CASES``; default: all, or the labels given) and each rung (the
case's dtype, then int8 ``{q, s}`` caches or pools quantized from the
same draws, from a fixed seed through ``chip_smoke.ragged_inputs`` /
``paged_inputs``), every library's output is held against the read's
twin (``ragged_decode_plain`` element by element at ``FWD_TOL`` /
``INT8_TOL``; ``xla_paged_read`` by ``chip_smoke.check_paged`` /
``check_int8``, the smoke's paged limits) and timed with
``chip_smoke.time_ms`` in turns (first to last, then last to first), so
that the lengths are compared within one run on one card.

Prints one JSON line per (case, rung, library, turn). Needs a CUDA device
and ``nvcc``; exits non-zero without them, when a copy does not compile
or when an output misses its limit.
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


def compile_all(build, read: str, sources: dict[str, str]) -> dict[str, Path]:
    """Build one library per (name -> source text); returns their paths."""
    out_dir = build.BUILD_DIR / "timing"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    headers = b"".join((build.KERNEL_DIR / h).read_bytes()
                       for h in build.HEADERS)
    procs, paths = {}, {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode() + headers).hexdigest()[:12]
        src = out_dir / f"{read}_decode-{digest}.cu"
        src.write_text(text)
        paths[name] = out_dir / f"{read}_decode-{digest}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-I{build.KERNEL_DIR}", "-o",
               str(paths[name]), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
    return paths


def load(build, read: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in build._SIGNATURES[f"{read}_decode"].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpushare_cuda_error.argtypes = [ctypes.c_int]
    lib.tpushare_cuda_error.restype = ctypes.c_char_p
    return lib


def ragged_cases(torch, smoke, build, labels):
    """(label, rung, ctas(chunk), launcher(lib, chunk), check) per case
    and rung of ``RAGGED_CASES``."""
    from tpushare_torch.workloads.ops.ragged_decode import ragged_decode_plain
    for label, B, S, H, Hkv, dtype in smoke.RAGGED_CASES:
        if labels is not None and label not in labels:
            continue
        for int8 in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(31)
            q, k, v, lens = smoke.ragged_inputs(torch, gen, label, B, S, H,
                                                Hkv, dtype, int8)
            kq, vq = (k["q"], v["q"]) if int8 else (k, v)
            ks, vs = ((k["s"].data_ptr(), v["s"].data_ptr()) if int8
                      else (None, None))
            hd = q.shape[-1]
            want = ragged_decode_plain(q, k, v, lens)
            tol = (smoke.INT8_TOL if int8 else smoke.FWD_TOL)[dtype]
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
                return launch

            def check(name):
                rel = smoke.elem_rel_err(out, want)
                if not rel <= tol:
                    raise SystemExit(f"{label} int8={int8} {name}: "
                                     f"{rel} of the value > {tol}")
                return {"rel_err": rel}

            yield (label, "int8" if int8 else dtype,
                   lambda chunk: -(-S // chunk) * Hkv * B, launcher, check)
            del q, k, v, kq, vq, want, out
            torch.cuda.empty_cache()


def paged_cases(torch, smoke, build, labels):
    """The same per case and rung of ``PAGED_CASES``."""
    from tpushare_torch.workloads.ops.paged_attention import xla_paged_read
    for label, B, H, Hkv, hd, ps, P, max_len, short_max, dtype in \
            smoke.PAGED_CASES:
        if labels is not None and label not in labels:
            continue
        for int8 in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(32)
            q1, kp, vp, tables, kv_lens = smoke.paged_inputs(
                torch, gen, B, H, Hkv, hd, ps, P, max_len, short_max, dtype,
                int8)
            kq, vq = (kp["q"], vp["q"]) if int8 else (kp, vp)
            ks, vs = ((kp["s"].data_ptr(), vp["s"].data_ptr()) if int8
                      else (None, None))
            want = xla_paged_read(q1[:, None], kp, vp, tables, kv_lens, H,
                                  Hkv)[:, 0]
            out = torch.empty_like(q1)

            def launcher(lib, chunk):
                n_chunks = -(-P * ps // chunk)
                ws = (torch.empty(B * H * n_chunks * (hd + 2),
                                  dtype=torch.float32, device="cuda")
                      if n_chunks > 1 else None)

                def launch():
                    rc = lib.tpushare_paged_decode(
                        q1.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
                        tables.data_ptr(), tables.stride(0), P,
                        kv_lens.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), n_chunks, B,
                        H, Hkv, hd, ps, int(q1.dtype == torch.bfloat16),
                        int(int8), hd ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                    build.check(lib, "paged_decode", rc)
                return launch

            def check(name):
                what = f"{label} int8={int8} {name}"
                if int8:
                    return smoke.check_int8(what, out, want, dtype)
                return smoke.check_paged(what, out, want, dtype)

            yield (label, "int8" if int8 else dtype,
                   lambda chunk: -(-P * ps // chunk) * Hkv * B, launcher,
                   check)
            del q1, kp, vp, kq, vq, want, out
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--read", choices=("ragged", "paged"), default="ragged",
                    help="which split decode read to sweep")
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[64, 128, 256, 512],
                    help="values of CHUNK to build and time")
    ap.add_argument("--source", type=Path, nargs="*", default=[],
                    help="other sources of the same read to time as they "
                         "are")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="labels of the smoke's cases (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_chunk_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from tpushare_torch.workloads.kernels import build

    lib_name = f"{args.read}_decode"
    own = (build.KERNEL_DIR / build.SOURCES[lib_name]).read_text()
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
    libs = {n: load(build, args.read, p)
            for n, p in compile_all(build, args.read, sources).items()}

    cases = (ragged_cases if args.read == "ragged" else paged_cases)(
        torch, smoke, build, args.cases)
    for label, rung, ctas, launcher, check in cases:
        order = list(libs) + list(reversed(libs))
        for turn, name in enumerate(order):
            chunk = chunk_of[name]
            launch = launcher(libs[name], chunk)
            launch()
            torch.cuda.synchronize()
            print(json.dumps({
                "read": args.read, "case": label, "rung": rung,
                "library": name, "chunk_rows": chunk, "ctas": ctas(chunk),
                "turn": turn, "ms": smoke.time_ms(launch),
                **check(name)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
