"""Test harness config: run JAX on the CPU with 8 virtual devices.

Multi-device sharding tests use `xla_force_host_platform_device_count=8`
per SURVEY.md §4 item 4.  Some pytest plugins import jax before this
conftest runs, so the platform is also forced through jax.config and
checked.

Card-only tests carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them without a card.  On a machine with one, run them with
``AFP_TEST_GPU=1 python -m pytest -m gpu tests/`` (the CPU pin is then
left off).
"""
import os

_ON_GPU = os.environ.get("AFP_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
    assert len(jax.devices()) >= 8, "expected 8 virtual CPU devices"

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (AFP_TEST_GPU=1 on a card)")
    return jax.devices()[0]
