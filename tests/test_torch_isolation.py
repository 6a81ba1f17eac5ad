"""Isolation and device rules of the PyTorch port.

- importing every module of ``tpushare_torch`` loads neither ``jax`` nor
  any ``tpushare.`` module (checked in a fresh interpreter);
- without CUDA the entry points raise unless the caller passes
  ``device="cpu"``;
- a CPU tensor never reaches the kernel loader: the wrappers hand it to
  their plain twins.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads import decode, infer  # noqa: E402
from tpushare_torch.workloads.kernels import build  # noqa: E402
from tpushare_torch.workloads.models import transformer  # noqa: E402
from tpushare_torch.workloads.ops import attention  # noqa: E402
from tpushare_torch.workloads.ops import paged_attention  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = transformer.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                    n_layers=1, d_ff=64, max_seq=64,
                                    dtype=torch.float32)


def test_import_loads_no_jax_and_no_reference_module():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "tpushare_torch").rglob("*.py"))
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'tpushare' "
            "or m.startswith('tpushare.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert "tpushare_torch.workloads.serving" in modules


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "init_page_pool", "infer"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    gen = torch.Generator()
    calls = {
        "init_params": lambda **kw: transformer.init_params(gen, CFG, **kw),
        "init_cache": lambda **kw: decode.init_cache(CFG, 1, 8, **kw),
        "init_page_pool": lambda **kw: decode.init_page_pool(CFG, 4, 8, **kw),
        "infer": lambda **kw: infer.run(infer.parse_args(
            ["--steps", "1", "--batch", "1", "--seq", "8"]
            + (["--device", kw["device"]] if kw else []))),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(build, "library", refuse)
    before = dict(build.LAUNCHES)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 16, 2, 8)).astype(np.float32)) for _ in range(3))
    out = attention.flash_attention(q, k, v)
    torch.testing.assert_close(out, attention.flash_attention_plain(q, k, v))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (5, 4, 2, 8)).astype(np.float32)) for _ in range(2))
    tables = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    q1 = q[:, 0].expand(2, 2, 8).contiguous()
    got = paged_attention.paged_decode(q1, kp, vp, tables, lens)
    want = paged_attention.xla_paged_read(q1[:, None], kp, vp, tables, lens,
                                          2, 2)[:, 0]
    torch.testing.assert_close(got, want)
    assert build.LAUNCHES == before


def test_kernel_library_names_follow_the_source():
    for name, src in build.SOURCES.items():
        assert (build.KERNEL_DIR / src).is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and name in path.name
