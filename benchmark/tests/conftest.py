"""The benchmark's own tests: its harness, yardstick and reference on the
CPU. ``python -m pytest benchmark/tests -q`` from the repository's root.
Tests that need the card are marked ``cuda`` and skip without one (the
``card`` fixture decides, at run time)."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
