"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on 1 CPU device;
only launch/dryrun.py creates the 512 placeholder devices."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    # tier split: scripts/verify.sh runs `pytest -m "not slow"` so the
    # heaviest equivalence-matrix cases (tests/test_speculative.py) stay
    # out of the fast tier; plain `pytest` still runs the full matrix
    config.addinivalue_line(
        "markers", "slow: heavy equivalence-matrix case (excluded from "
        "the verify.sh fast tier via -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the PyTorch/CUDA port's "
        "kernels); skips when torch.cuda.is_available() is false")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
