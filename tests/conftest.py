"""Test env: CPU platform with 8 fake devices (SURVEY.md §4 item 4).

The env vars must be set before jax initializes, which is why they are set
here, before any test module imports jax. Tests that need a CUDA GPU take
the ``gpu`` fixture and carry the ``gpu`` marker; they skip on the CPU and
run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU")
