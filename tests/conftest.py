"""Test harness: CPU tests on an 8-device virtual CPU mesh; GPU tests marked.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices (SURVEY.md §4), at `highest` matmul precision.  The platform comes
from JAX_PLATFORMS when it is set (the GPU tests run with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`), else the CPU.

Tests that need a GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them when the default backend is not a GPU.
"""

import os

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_matmul_precision", "highest")
# no persistent compile cache under test: workers compile concurrently
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped when JAX finds none")


@pytest.fixture
def gpu():
    """The GPU device, or a skip when JAX's default backend has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu -m gpu)")
    return jax.devices()[0]


@pytest.fixture(scope="session", autouse=True)
def _virtual_cpu_mesh():
    assert len(jax.devices("cpu")) == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices('cpu')}")
