"""Tests of the benchmark harness. Run from the repository root with
``python -m pytest perfbench/tests``; tests marked ``chip`` need a CUDA
device and skip without one (run them on the GPU machine with
``python -m pytest perfbench/tests -m chip``)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
