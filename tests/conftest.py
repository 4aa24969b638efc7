"""Test harness: virtual 8-device CPU mesh, no accelerator needed.

This is the distributed-test strategy from SURVEY §4: the same shard_map
programs that run on several GPUs run on N virtual CPU devices via
``--xla_force_host_platform_device_count``, so sharding semantics (not just
math) are exercised in CI. The GPU kernels run here through the Pallas
interpreter (``SRT_PALLAS=interpret`` / ``pallas_mode="interpret"``).

Markers: ``gpu`` — needs a GPU; the ``gpu_device`` fixture skips it here
(run them on the card with ``python -m pytest tests -m gpu``). ``slow`` —
deselected by the tier-1 run.
"""
import os
import sys

import pytest

# XLA_FLAGS must be in place before the CPU client is created.
prev = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in prev:
    os.environ["XLA_FLAGS"] = (
        prev + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The tests run on the CPU unless the GPU suite is asked for explicitly.
if os.environ.get("SRT_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skipped elsewhere by the gpu_device "
                   "fixture)")
    config.addinivalue_line(
        "markers", "slow: long-running; deselected by the tier-1 run")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with SRT_TEST_GPU=1 on the card)")
    return jax.devices()[0]


@pytest.fixture
def eight_devices():
    """Eight devices for the mesh tests; skips when fewer are visible."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip(f"needs 8 devices, have {len(devs)}")
    return devs[:8]
