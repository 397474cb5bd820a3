"""Test harness config.

Tests run on the CPU with 8 virtual devices, so sharding tests get a
multi-device mesh and Pallas kernels run in interpret mode. The GPU lane
(``ART_GPU_TESTS=1 python -m pytest -m gpu``, tests/test_gpu_lane.py)
keeps JAX's GPU platform.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()

import jax

if os.environ.get("ART_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
