"""Test configuration.

Default tier: JAX on a virtual 8-device CPU mesh; fast, hermetic, covers
all math through the plain ``lax`` references, from the seeded assets of
``strique_tpu.synthetic``.

Card tier: tests marked ``gpu`` compare the CUDA kernels with those
references on an NVIDIA GPU and skip anywhere else (the ``gpu`` fixture
decides, at run time).  On a machine with a card:

    STRIQUE_TEST_DEVICE=gpu python -m pytest tests/ -m gpu

``chip_smoke.py`` runs the same tier in its own process.
"""
import os
import sys

ON_CARD = os.environ.get("STRIQUE_TEST_DEVICE") == "gpu"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strique_tpu import platform  # noqa: E402

platform.enable_compile_cache()


@pytest.fixture
def gpu():
    """The default device when it is an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return dev


@pytest.fixture(scope="session")
def assets():
    """The default seeded asset set (pore models, repeat config, params)."""
    from strique_tpu.synthetic import default_assets

    return default_assets()
