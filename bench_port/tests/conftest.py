"""CPU tests of the benchmark (run: python -m pytest bench_port/tests -q).
Tests that need the card carry the ``card`` marker and skip here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The cells at sizes a CPU test holds; everything else as configured.
SMALL = {
    "d3_chunked": dict(P=400, N=4000, sigma=0.08, tile=0.4,
                       reference_pairs=1 << 18),
    "dense10k": dict(P=200, N=1500, sigma=0.15, reference_pairs=1 << 18),
}
CELLS = ("d3_chunked.train3", "dense10k.train4", "d3_chunked.eval3",
         "dense10k.eval4")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small(cell: str) -> dict:
    return SMALL[cell.split(".")[0]]
