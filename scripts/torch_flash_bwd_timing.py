#!/usr/bin/env python3
"""Device time of the flash backward kernels (K2 dQ, K3 dK/dV), one
source against another, at the smoke's bf16 shapes.

    python scripts/torch_flash_bwd_timing.py [--source FILE ...]
        [--single-rounding] [--cases LABEL ...]

Compiles each ``flash_bwd.cu`` source (default: the repository's) with
the build's own flags into its own library under ``kernels/_build/``,
all ``nvcc`` processes started together, and loads it with ``ctypes``.
With ``--single-rounding`` it also builds a variant of the repository's
source in which P and dS are rounded once to bf16 instead of split into
two halves (the source text rewritten at run time: each ``lo``-half
product dropped); the variant is for measuring what the split costs and
is never part of the port.

For each bf16 case of ``chip_smoke.BWD_CASES`` (default: all, or the
labels given), on ``chip_smoke.bwd_inputs`` from a fixed seed and the
port's own forward (o, lse), every library's dQ and dK/dV are checked
against ``flash_attention_bwd_plain`` (max |error| over each gradient's
scale, which ``chip_smoke.BWD_TOL`` bounds) and timed with
``chip_smoke.time_ms`` in turns (first to last, then last to first), so
that two libraries are compared within one run on one card.

Prints one JSON line per (case, library, turn). Needs a CUDA device and
``nvcc``; exits non-zero without them or when a source does not compile.
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


def single_rounding(text: str) -> str:
    """The source with P and dS rounded once to bf16: every product of a
    ``lo`` half dropped, and each split packed as one bf16 operand."""
    products = re.compile(r"^\s*mma::mma_16816\([^;]*\blo, [^;]*\);\n",
                          re.MULTILINE)
    out, n_products = products.subn("", text)
    out, n_splits = re.subn(r"mma::acc_to_a_split\((\w+), \w+, ",
                            r"mma::acc_to_a(\1, ", out)
    if not (n_products and n_splits):
        raise SystemExit("single-rounding rewrite found no split to undo")
    return out


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
        src = out_dir / f"flash_bwd-{digest}.cu"
        src.write_text(text)
        paths[name] = out_dir / f"flash_bwd-{digest}.so"
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
    for fn_name, argtypes in build._SIGNATURES["flash_bwd"].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpushare_cuda_error.argtypes = [ctypes.c_int]
    lib.tpushare_cuda_error.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, nargs="*", default=[],
                    help="flash_bwd.cu sources to time beside the "
                         "repository's")
    ap.add_argument("--single-rounding", action="store_true",
                    help="also time the repository's source with P and dS "
                         "rounded once to bf16")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="labels of chip_smoke.BWD_CASES (default: every "
                         "bf16 case)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import BWD_CASES, bwd_inputs, max_err, time_ms
    from tpushare_torch.workloads.kernels import build
    from tpushare_torch.workloads.ops.attention import (
        bwd_delta, cuda_stream, flash_attention_bwd_plain,
        flash_attention_fwd)

    own = (build.KERNEL_DIR / build.SOURCES["flash_bwd"]).read_text()
    sources = {"repo": own}
    for path in args.source:
        sources[str(path)] = path.read_text()
    if args.single_rounding:
        sources["repo-single-rounding"] = single_rounding(own)
    libs = {name: load(build, path)
            for name, path in compile_all(build, sources).items()}

    cases = [c for c in BWD_CASES if c[6] == "bfloat16"
             and (args.cases is None or c[0] in args.cases)]
    for label, B, S, H, Hkv, hd, dtype, causal, window in cases:
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, do = bwd_inputs(torch, gen, B, S, H, Hkv, hd, dtype)
        o, lse = flash_attention_fwd(q, k, v, causal, window, with_lse=True)
        delta = bwd_delta(do, o)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)
        scales = [w.float().abs().max().item() for w in want]
        shape = (B, S, H, Hkv, hd, int(causal), window or 0, 1, hd ** -0.5)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

        def launches(lib):
            def dq_launch():
                rc = lib.tpushare_flash_bwd_dq(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *shape,
                    cuda_stream())
                build.check(lib, "flash_bwd_dq", rc)

            def dkv_launch():
                rc = lib.tpushare_flash_bwd_dkv(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *shape, cuda_stream())
                build.check(lib, "flash_bwd_dkv", rc)
            return dq_launch, dkv_launch

        order = list(libs) + list(reversed(libs))
        for turn, name in enumerate(order):
            dq_launch, dkv_launch = launches(libs[name])
            dq_launch()
            dkv_launch()
            torch.cuda.synchronize()
            errs = [max_err(g, w) / sc
                    for g, w, sc in zip((dq, dk, dv), want, scales)]
            print(json.dumps({
                "case": label, "library": name, "turn": turn,
                "dq_ms": time_ms(dq_launch), "dkv_ms": time_ms(dkv_launch),
                "dq_rel_err": errs[0], "dk_rel_err": errs[1],
                "dv_rel_err": errs[2]}), flush=True)
        del q, k, v, do, o, lse, delta, want, dq, dk, dv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
