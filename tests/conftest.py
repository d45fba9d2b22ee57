"""Test configuration: force the CPU backend with 8 virtual devices so the
sharding tests run without accelerators, and enable x64 before anything
imports jax.  Tests that need a GPU carry the `gpu` marker and skip here
(`gpu_only` fixture); `python chip_smoke.py` runs that code on the card."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("BEMSTOKES_X64", "1")

import jax  # noqa: E402

# set after import as well: an interpreter started with another platform
# pinned still runs the tests on the CPU
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE_GRIDS = "/root/reference/tests/grid_test"
DEBUG_GRIDS = "/root/reference/debug_grids"


@pytest.fixture(scope="session")
def reference_grid_dir():
    return REFERENCE_GRIDS


@pytest.fixture(scope="session")
def debug_grid_dir():
    return DEBUG_GRIDS


@pytest.fixture()
def gpu_only():
    """Skip unless JAX's default backend is a GPU.  Decided inside the test
    (never at import or collection), so every worker collects the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card by chip_smoke.py")
