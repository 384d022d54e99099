"""Test configuration: JAX on CPU with 8 virtual devices and f64 enabled.

Tests run on the CPU (``JAX_PLATFORMS=cpu``, 8 virtual devices for the
mesh tests). The program runs on the GPU through ``chip_smoke.py``; tests
marked ``gpu`` need a card and skip elsewhere. Run them on a GPU machine
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never while modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
