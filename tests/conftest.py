import os

# Smoke tests and benches run on the single real CPU device; ONLY
# launch/dryrun.py overrides device count (see system design).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests (subprocess meshes)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
