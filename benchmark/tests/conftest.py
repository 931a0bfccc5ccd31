"""Shared set-up of the benchmark's own tests (CPU; the card only where a
test asks for the `card` fixture)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH.parent, BENCH / "reference", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny(cell: str, n3: int = 12, steps: int = 6) -> dict:
    """The cell's files as loaded, cut to a CPU-sized lattice and segment
    (slabs: a migration buffer of 256)."""
    import harness

    loaded = harness.load_cell(cell)
    loaded["config"]["n3"] = n3
    loaded["mix"]["segment_steps"] = steps
    if loaded["config"]["layout"]["kind"] == "slabs":
        loaded["config"]["layout"]["migrate_capacity"] = 256
    return loaded
