"""Test configuration: run on the CPU, with 8 virtual CPU devices.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices (the analog of the reference's REMOVE_LP1_LPN_DIFF
single-vs-multi-thread determinism check, ref: Source/API/EbDebugMacros.h).

The platform is the CPU unless JAX_PLATFORMS names another: the card-only
tests (marker `gpu`) run with JAX_PLATFORMS=cuda,cpu, which keeps the CPU
device they compare against. Whether a GPU is present is decided inside
the `gpu_device` fixture, never at import time. The persistent compile
cache is off, so tests read and write no compiled programs.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("card-only test: JAX has no GPU device here")
