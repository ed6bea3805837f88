"""Tests of the benchmark harness. Run them from the repo root:

    python -m pytest -p no:xdist -o addopts="" proofbench/tests

The tests marked `cuda` need an NVIDIA GPU and skip without one (decided
in the `card` fixture, never at import).
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


@pytest.fixture(scope="session")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's CUDA kernels have no CPU mode")
    return torch.device("cuda:0")
