"""Test bootstrap: run everything on a virtual 8-device CPU mesh.

The driver benches on a real TPU chip; tests exercise the identical code
paths on CPU with XLA's host-platform device multiplexing so sharding /
collective logic is covered without hardware.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax is pre-imported at interpreter startup in this image, so the env vars
# above were already captured into jax.config — override explicitly.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running e2e test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (rtpose_tpu_torch kernels); "
        "skips without one")
