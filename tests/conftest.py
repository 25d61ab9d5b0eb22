"""Test configuration: a virtual 8-device CPU platform by default.

The rebuild's analogue of the reference's `mpirun -n 8` on localhost
(SURVEY.md §4b): shard_map + ppermute run on faked host devices, so the
distributed tests need no accelerator or cluster.  Must run before jax
imports.

CFD_TEST_GPU=1 leaves the platform to JAX instead, for the card-only tests
(`-m gpu`); the `gpu` fixture skips them wherever JAX finds no GPU.
"""

import os

import pytest

ON_GPU_RUN = os.environ.get("CFD_TEST_GPU") == "1"

if not ON_GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # REPLACE any pre-existing device-count flag (a leftover =4 from the
    # README's CLI recipe would otherwise survive and abort the whole session
    # at the device-count assert below) — hermetic means our count wins
    toks = [t for t in os.environ.get("XLA_FLAGS", "").split()
            if not t.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(
        toks + ["--xla_force_host_platform_device_count=8"])

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)  # f64 golden/bit-match paths

if not ON_GPU_RUN:
    assert jax.device_count() == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()}")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with CFD_TEST_GPU=1 on the card)")
    return jax.devices()[0]


def pytest_collection_modifyitems(config, items):
    # card-only tests get the fixture that skips them off the card
    for item in items:
        if item.get_closest_marker("gpu") and "gpu" not in item.fixturenames:
            item.fixturenames.append("gpu")
