"""Run one cell of ``BENCHMARK.json`` once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights from the seed, the program's state, warm-up) is timed
from process start; then the window runs for ``--seconds``; then the
program's state is freed and the plain reference decides ``correct``.
With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and the device profile.
Earlier lines of standard output say what ran (kernel launches,
fallbacks, the card's power limit, how late the generator ran); the
last line is the result as one JSON object. Standard error ends with
each number compared beside its limit.

Exits non-zero and prints no result without a CUDA card (or fewer
than the cell asks for), when a file the cell names is missing, or
when a module of ``jax``, ``jaxlib``, ``flax`` or ``tpushare`` is loaded
by the time the result would print.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# ``python3 benchmark/run.py`` puts this folder first on the path, where
# its modules (``trace``, ``model``) would shadow others of those names
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"


def set_env() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    # libraries that would load JAX or TensorFlow on their own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def run_workload(workload: str, seed: int, seconds: float, trace: bool,
                 device="cuda", t_start: float | None = None,
                 overrides: dict | None = None) -> tuple[dict, dict]:
    """One run of a cell: (the result object, the run's record).
    ``overrides`` replaces parts of the cell (``"cell"``, ``"mix"``,
    merged) or the model's sizes (``"m"``, whole): the tests run the
    same code at a tiny size on the CPU."""
    import importlib

    from benchmark import harness, model, traffic
    from benchmark.trace import DeviceTrace
    overrides = overrides or {}
    bench = harness.load_benchmark()
    cell = _merge(harness.load_cell(workload), overrides.get("cell", {}))
    config = model.load_config(cell["config"])
    mix = _merge(traffic.load_mix(cell["traffic"]), overrides.get("mix", {}))
    m = overrides.get("m") or model.dims(config)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    rec = driver.run({
        "cell": cell, "config": config, "m": m, "mix": mix,
        "traffic": traffic.generator(mix), "seed": int(seed),
        "seconds": float(seconds), "trace": bool(trace), "device": device,
        "tracer": DeviceTrace,
        "t_start": T_START if t_start is None else t_start})
    numbers = {k: v for k, v in rec["numbers"].items()
               if not k.startswith("_")}
    checks = harness.judge(numbers, cell["limits"])
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": rec["attempted"], "failed": rec["failed"],
        "metrics": harness.read_metrics(bench, workload, trace, rec,
                                        strict=rec["device"] == "cuda"),
        "device": None}
    if rec.get("trace") is not None:
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = checks
    return result, rec


def card_line(torch, chips: int) -> dict:
    """The card's name and power limit, beside every number."""
    line = {"kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        line["nvidia_smi"] = out.stdout.strip().splitlines()[:chips]
    except (OSError, subprocess.SubprocessError) as e:
        line["nvidia_smi"] = f"unavailable: {e}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    cells = {w["name"]: w for w in harness.load_benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"run: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    card = card_line(torch, chips)
    print("card " + json.dumps(card), flush=True)
    result, rec = run_workload(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    device = {"platform": "gpu", "kind": card["kind"], "count": chips,
              "memory_peak_bytes": rec["reserved_bytes"]}
    if args.trace:
        t = rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
    result["device"] = device
    for line in info_lines(rec):
        print(line, flush=True)
    found = harness.forbidden_modules()
    if found:
        print("run: the JAX package or JAX is loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in harness.format_checks(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    return 0


def info_lines(rec: dict) -> list[str]:
    out = [f"setup {json.dumps(rec['setup_marks'])}",
           f"launches {json.dumps(rec['launches'])}",
           f"fallbacks {json.dumps(rec['fallbacks'])}",
           "numbers " + json.dumps({k: v for k, v in rec["numbers"].items()})]
    if rec.get("trace") is not None:
        seen = {n: c for n, (_, c) in rec["trace"]["kernels"].items()
                if any(k in n for k in ("splash", "paged", "flash"))}
        out.append(f"traced window_s={rec['trace']['window_s']!r} launches "
                   f"counted={json.dumps(rec['trace_launches'])} "
                   f"profiled={json.dumps(seen)}")
    if rec["kind"] == "train":
        out.append("program " + json.dumps({"losses": rec["program"]["losses"]}))
        out.append("reference " + json.dumps({"losses": rec["reference"]["losses"]}))
        out.append(f"window steps={rec['steps']} window_s={rec['window_s']!r}")
    else:
        from benchmark.harness import percentile
        late = [r["late_s"] for r in rec["requests"] if r["late_s"] is not None]
        if late:
            out.append(f"generator late_s max={max(late)!r} "
                       f"p90={percentile(late, 90)!r} n={len(late)}")
        out.append(f"window offered={len(rec['requests'])} "
                   f"span_s={rec['span_s']!r} waves={len(rec['waves'])} "
                   f"chunks={len(rec['chunks'])}")
        out.append("pool " + json.dumps(rec["pool"]))
        if rec.get("trace") is not None:
            out.append(f"trace enter_s={rec['trace_enter_s']!r}")
    return out


if __name__ == "__main__":
    sys.exit(main())
