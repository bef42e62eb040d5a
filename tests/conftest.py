"""Test harness: CPU by default, on a virtual 8-device mesh.

The platform is pinned through jax.config before any backend is
initialized: CPU unless JAX_PLATFORMS names another (the `gpu`-marked
tests run on the card with JAX_PLATFORMS=cuda). The 8 virtual CPU devices
let sharding tests exercise a real Mesh without several accelerators.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform here: "
                    f"{dev.platform}); chip_smoke.py runs this on the card")
    return dev
