"""Test configuration: CPU backend with 8 virtual devices, x64 enabled.

Multi-chip sharding tests run on a fake 8-device CPU mesh
(``xla_force_host_platform_device_count``), the standard JAX substitute for
real multi-chip hardware. complex128 paths need x64.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where torch sees none)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_complex(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def random_points(rng, shape, dtype, low=-np.pi, high=np.pi):
    return rng.uniform(low, high, shape).astype(dtype)
