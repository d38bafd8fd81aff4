"""Shared fixtures + hermeticity guards.

The environment mutations here run at conftest import — BEFORE any test
module imports jax — and are inherited by the subprocess tests
(test_dryrun_subprocess, test_spmd_subprocess copy ``os.environ``), so the
whole suite is hermetic on CPU-only runners:

* ``JAX_PLATFORMS=cpu``  — never try to initialize an accelerator;
* ``PYTHONHASHSEED=0``   — deterministic hashing for any subprocess;
* the ``rng`` fixture is the single seeded PRNG for test data.

NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device;
multi-device SPMD tests run in subprocesses (see tests/test_spmd_subprocess)
which set their own ``--xla_force_host_platform_device_count``.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("PYTHONHASHSEED", "0")

import numpy as np
import pytest

SEED = 20170701

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub
    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (subprocess SPMD / dryrun)")
    config.addinivalue_line(
        "markers", "needs_cuda: runs only where a CUDA device is present")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(SEED)
