"""What a run may load: the port, never JAX or the JAX package, and a
reference that imports nothing of the program."""

import ast
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH_DIR = Path(harness.__file__).resolve().parent


def _mods(*names):
    return {n: types.ModuleType(n) for n in names}


@pytest.mark.parametrize("planted", ["jax", "jax.numpy", "jaxlib",
                                     "jaxlib.xla_client", "flax", "flax.linen",
                                     "tpushare", "tpushare.workloads.train"])
def test_planted_module_is_found(planted):
    mods = _mods("torch", "tpushare_torch", "tpushare_torch.workloads",
                 planted)
    assert harness.forbidden_modules(mods) == [planted]


def test_the_port_and_lookalikes_pass():
    mods = _mods("tpushare_torch", "tpushare_torch.workloads.train",
                 "jaxtyping", "flaxen", "tpushare2", "benchmark.run", "torch")
    assert harness.forbidden_modules(mods) == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, path


def _closure(start: set[str]) -> set[str]:
    """benchmark modules reachable from ``start`` by import."""
    seen, todo = set(), list(start)
    while todo:
        name = todo.pop()
        if name in seen or not name.startswith("benchmark"):
            continue
        seen.add(name)
        rel = Path(*name.split(".")[1:])
        for cand in (BENCH_DIR / rel.with_suffix(".py"),
                     BENCH_DIR / rel / "__init__.py"):
            if cand.exists():
                todo.extend(_imports(cand))
    return seen


def test_reference_imports_nothing_of_the_program():
    start = {f"benchmark.reference.{p.stem}"
             for p in (BENCH_DIR / "reference").glob("*.py")}
    for mod in _closure(start):
        rel = Path(*mod.split(".")[1:])
        path = BENCH_DIR / rel.with_suffix(".py")
        if not path.exists():
            path = BENCH_DIR / rel / "__init__.py"
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("tpushare_torch", *harness.FORBIDDEN_MODULES), \
                f"{path} imports {name}"


def test_the_harness_and_the_port_load_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, "
            "benchmark.drivers.train, benchmark.drivers.serve, "
            "tpushare_torch.workloads.serving, tpushare_torch.workloads.train; "
            "from benchmark.harness import forbidden_modules; "
            "print(forbidden_modules())" % str(BENCH_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
