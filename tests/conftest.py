"""Test harness: multi-device CPU mesh for sharding tests.

Tests run on the CPU; sharding logic is exercised on a virtual 8-device
CPU mesh per SURVEY.md §4. Must run before JAX initializes a backend.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless the caller names platforms (JAX_PLATFORMS=cuda,cpu runs the
# `gpu`-marked tests on a card).
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# Parity tests compare against the double-precision reference mirror;
# library code is dtype-explicit, so f32 behavior is still exercised by
# passing float32 inputs.
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip. Decided when a test runs, never at
    import: xdist workers must all collect the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:  # no GPU backend in this process
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")
    return devices[0]
