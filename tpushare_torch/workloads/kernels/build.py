"""Build and load the port's CUDA kernels.

Each ``*.cu`` source in this directory exports a plain C interface
(pointers, ints, a stream) and is compiled by ``nvcc`` for ``sm_90a``
into its own shared library under ``_build/`` (listed in
``.gitignore``), then loaded with ``ctypes``. No source includes
PyTorch's headers, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build costs. The sources share their
element conversions through ``common.cuh``, the tensor-core tile loop
(``mma.sync``, ``ldmatrix``, the ``cp.async`` ring) through
``mma_tile.cuh``, and the attention forward's tile body (the bf16 rungs
of the flash and splash forwards) through ``attn_fwd_tile.cuh``
(``HEADERS``). Libraries are named by a digest of their
source, every shared header and the flags, so an edited kernel or header
is never served from a stale build.

A kernel is built on first use (``library``) — never at import: the CPU
tests import every module of the port and have no ``nvcc``.
``build()`` compiles several at once, one ``nvcc`` process per source,
all started together.

``LAUNCHES`` counts kernel launches by kernel name (``KERNELS``; the
``flash_fwd`` library holds two kernels, K1 and the cached chunk's,
the ``flash_bwd`` and ``splash_bwd`` libraries two each, and the
decode libraries count their int8 rungs apart): each wrapper adds one
exactly where it launches its kernel, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "paged_decode": "paged_decode.cu",
           "ragged_decode": "ragged_decode.cu",
           "splash_fwd": "splash_fwd.cu", "splash_bwd": "splash_bwd.cu"}
# every header a source includes: each library's digest covers them all
HEADERS = ("common.cuh", "mma_tile.cuh", "attn_fwd_tile.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# exported entry points and their argument types, per library
_SIGNATURES = {
    "flash_fwd": {
        # q, k, v, o, lse (null = none), B, S, H, Hkv, hd, causal, window,
        # is_bf16, scale, stream
        "tpushare_flash_fwd":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        # q, k, v (one layer's cache view), o, B, Q, pos, H, Hkv, hd,
        # kv_batch, kv_row (element strides), scale, stream
        "tpushare_flash_fwd_chunk":
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _F, _P]},
    "flash_bwd": {
        # q, k, v, dout, lse, delta, dq, B, S, H, Hkv, hd, causal, window,
        # is_bf16, scale, stream
        "tpushare_flash_bwd_dq":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
             _P],
        # q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, hd, causal,
        # window, is_bf16, scale, stream
        "tpushare_flash_bwd_dkv":
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _F, _P]},
    # q, kp, vp, ks, vs (int8 scale planes or null), tables, table_stride,
    # n_table, kv_lens, o, ws (fp32 partials or null), n_chunks, B, H,
    # Hkv, hd, page_size, is_bf16, is_int8, scale, stream
    "paged_decode": {"tpushare_paged_decode":
                     [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                      _I, _I, _I, _I, _I, _I, _I, _F, _P]},
    # q, k, v (one layer's (B, S, Hkv, hd) base), ks, vs (int8 scale
    # planes or null), lengths, o, ws (fp32 partials or null), n_chunks,
    # B, S, H, Hkv, row_heads, hd, is_bf16, is_int8, scale, stream
    "ragged_decode": {"tpushare_ragged_decode":
                      [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _F, _P]},
    # q (pre-scaled), k, v, o, lse (null = none), the forward schedule
    # (offsets, blocks, kinds), B, S, H, hd, block, is_bf16, stream
    "splash_fwd": {"tpushare_splash_fwd":
                   [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _P]},
    "splash_bwd": {
        # q, k, v, dout, lse, di, dq, the forward schedule, B, S, H, hd,
        # block, is_bf16, stream
        "tpushare_splash_bwd_dq":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _P],
        # q, k, v, dout, lse, di, dk, dv, the dK/dV schedule, B, S, H,
        # hd, block, is_bf16, stream
        "tpushare_splash_bwd_dkv":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _P]},
}

# return code of an entry point asked for a shape/dtype it has no
# instantiation for (anything else non-zero is a cudaError_t)
UNSUPPORTED = -1

# launch counters, one per kernel (the flash_fwd, flash_bwd and
# splash_bwd libraries hold two each; the decode libraries' int8 rungs
# count under their own names)
KERNELS = ("flash_fwd", "flash_fwd_chunk", "flash_bwd_dq", "flash_bwd_dkv",
           "paged_decode", "paged_decode_int8", "ragged_decode",
           "ragged_decode_int8", "splash_fwd", "splash_bwd_dq",
           "splash_bwd_dkv")
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
# libraries this process compiled and the wall seconds nvcc took —
# the serving telemetry's compile pair (it has no jax.monitoring)
BUILDS = {"count": 0, "seconds": 0.0}

_lock = threading.Lock()
_lock_builds = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_totals() -> tuple[int, float]:
    """(libraries compiled, seconds) so far in this process."""
    with _lock_builds:
        return BUILDS["count"], BUILDS["seconds"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelBuildError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the port's "
            "kernels are compiled from source on first use")
    return str(path)


def library_path(name: str) -> Path:
    text = b"".join((KERNEL_DIR / f).read_bytes()
                    for f in (SOURCES[name], *HEADERS))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that have no library yet,
    in parallel. Returns seconds spent per kernel (0.0 when the library
    already existed). Raises :class:`KernelBuildError` with nvcc's output
    when a source does not compile."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failures = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n"
                            f"{log}")
            continue
        os.replace(tmp, out)
    with _lock_builds:
        BUILDS["count"] += len(todo) - len(failures)
        BUILDS["seconds"] += time.perf_counter() - t0
    if failures:
        raise KernelBuildError("kernel build failed: " + "\n".join(failures))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tpushare_cuda_error.argtypes = [ctypes.c_int]
            lib.tpushare_cuda_error.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise on a non-zero entry-point return: a refused or failed launch
    never runs, and a later synchronize would not report it."""
    if rc == UNSUPPORTED:
        raise ValueError(f"kernel {name!r} has no instantiation for this "
                         "shape/dtype (the wrapper's checks should have "
                         "caught it)")
    if rc:
        raise RuntimeError(f"kernel {name!r} launch failed: CUDA error {rc} "
                           f"({lib.tpushare_cuda_error(rc).decode()})")
