"""Shared set-up of the benchmark's CPU tests.

Run from the root of the checkout:

    python -m pytest -q bench/tests

Tests that need a CUDA card are marked ``cuda`` and skip without one.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: sizes a test run holds: 2^11 vertices at degree 8 (R-MAT repeats many
#: pairs at this size, so it draws twice the edges it keeps)
SMALL = {"log2_vertices": 11, "avg_degree": 8, "oversample": 2.0}


@pytest.fixture
def small_spec():
    from bench.lib import harness

    def make(cell, **sizes):
        spec = harness.load_spec(ROOT, cell)
        spec.config.update(SMALL, **sizes)
        return spec

    return make


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
