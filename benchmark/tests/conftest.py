"""The benchmark's own tests: ``python -m pytest benchmark/tests``.  Tests
that need the card take the ``cuda`` fixture, which skips without one;
the decision is made when the fixture runs, never at import."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the benchmark on the card")
    return torch.device("cuda")
