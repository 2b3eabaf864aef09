"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding (parallel/) is validated without accelerator hardware
via xla_force_host_platform_device_count, mirroring how the multi-chip path
is dry-run. The GPU path is exercised by chip_smoke.py, not by this suite.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def tiny_grid():
    """The 9-pose generated grid world (tinyGrid3D's size)."""
    from tests.worlds import TINY, grid_world

    meas, n = grid_world(TINY)
    return list(meas), n


@pytest.fixture(scope="session")
def small_grid():
    """The 125-pose generated grid world (smallGrid3D's size)."""
    from tests.worlds import SMALL, grid_world

    meas, n = grid_world(SMALL)
    return list(meas), n


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (full-dataset certificates etc.)",
    )


def pytest_collection_modifyitems(config, items):
    """Skip @pytest.mark.slow tests unless --runslow or DPGO_RUN_SLOW=1.

    The slow tier holds the full-dataset dual-certificate solves
    (sphere2500 / city10000 to 1e-6 + k=64 Lanczos on the CPU mesh) that
    pushed the default suite past 50 minutes; the default run stays the
    fast regression gate. CI / judge runs can opt in with --runslow.
    """
    if config.getoption("--runslow") or os.environ.get("DPGO_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow: opt in with --runslow / DPGO_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
