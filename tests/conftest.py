"""Test configuration: the suite runs on the CPU with 8 virtual devices.

Sharding tests need several devices, so the CPU backend is given 8 virtual
host devices. ``JAX_PLATFORMS`` defaults to ``cpu``; set it explicitly
(``JAX_PLATFORMS=cuda``) to run the ``gpu``-marked tests on a card.
"""

import os

os.environ["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run @pytest.mark.slow tests (the >20s virtual-mesh and "
             "large-scene suites; also enabled by VGT_FULL_SUITE=1)")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: the default lane skips ``@pytest.mark.slow`` tests —
    the handful of >20-second virtual-8-device-mesh renders and large-scene
    contracts — while still exercising every module (each slow test has
    faster siblings covering the same code paths).
    CI-style full runs: ``pytest --runslow`` or ``VGT_FULL_SUITE=1``.
    Skipped tests are reported as skips, never silently deselected.
    """
    if config.getoption("--runslow") or os.environ.get("VGT_FULL_SUITE"):
        return
    skip = pytest.mark.skip(
        reason="slow tier: enable with --runslow or VGT_FULL_SUITE=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
