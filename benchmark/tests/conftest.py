"""The benchmark's own tests: CPU tests at tiny sizes, and ``cuda``
tests that skip inside the test without a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels and the device "
                    "trace run only on the card")
    return torch.device("cuda")
