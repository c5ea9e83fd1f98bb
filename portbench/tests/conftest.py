"""Fixtures of the benchmark's own tests. These run on the CPU; a test
marked ``cuda`` asks for the ``card`` fixture, which skips it where there
is no card (decided when the test runs, never when a module is imported)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the cell on the card")
    return torch.device("cuda")
