"""Test harness: an 8-virtual-device CPU JAX backend.

The 8-device CPU mesh is the JAX-native "fake backend" for validating
sharding without a multi-device host (SURVEY.md §4).  The platform
defaults to the CPU through the environment before JAX first initialises
a backend; tests marked ``gpu`` skip unless JAX_PLATFORMS names the card
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``).
"""
import os

# XLA reads these at first backend init, which hasn't happened yet.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
