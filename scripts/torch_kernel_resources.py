#!/usr/bin/env python3
"""Registers, stack and spills of every kernel the port builds, as
``nvcc -Xptxas -v`` reports them.

    python scripts/torch_kernel_resources.py [library ...]   # default: all

Compiles each named library (the keys of ``kernels/build.py``'s
``SOURCES``) with the build's own flags plus ``-Xptxas -v`` into a
scratch file under ``kernels/_build/``, one ``nvcc`` per source, all
started together, and prints one JSON line per kernel instantiation:
library, demangled name, registers a thread, bytes of stack frame, of
spill stores and of spill loads. Needs ``nvcc``, not a card; exits
non-zero when a source does not compile.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    return dict(zip(names, out))


def parse(log: str) -> list[dict]:
    """One dict per entry function, in the order ptxas reports them."""
    rows, cur = [], None
    for line in log.splitlines():
        if m := ENTRY.search(line):
            cur = {"mangled": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := PROPS.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := REGS.search(line)):
            cur["registers"] = int(m.group(1))
    return rows


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(REPO))
    from tpushare_torch.workloads.kernels import build
    names = argv or list(build.SOURCES)
    out_dir = build.BUILD_DIR / "resources"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for n in names:
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(out_dir / f"{n}.{os.getpid()}.so"),
               str(build.KERNEL_DIR / build.SOURCES[n])]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    failed = False
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{build.SOURCES[n]}: nvcc exit {proc.returncode}\n{log}",
                  file=sys.stderr)
            failed = True
            continue
        rows = parse(log)
        names_of = demangle([r["mangled"] for r in rows])
        for r in rows:
            print(json.dumps({"library": n,
                              "kernel": names_of[r.pop("mangled")], **r}),
                  flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
