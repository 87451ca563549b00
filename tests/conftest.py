"""Test config. NOTE: no XLA_FLAGS device-count override here by design —
smoke tests and benches must see the real (single) device; only the
dry-run process emulates 512 devices (see repro.launch.dryrun)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's kernels); skips without one"
    )
