"""Test configuration.

By default everything runs on a virtual 8-device CPU mesh with float64
enabled, so solver parity tests are not precision-limited and the mesh
paths run without a cluster (SURVEY.md §4: multi-host BA is tested via
``xla_force_host_platform_device_count=8``).

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU.  They run on the card
with ``python -m pytest tests -m gpu``; only that marker expression leaves
the platform to JAX's default.

The native libraries (``make -C native``) are built once, before any test
worker starts.  Where ``make`` or the C++ compiler is missing their tests
skip; where the build fails, the session stops with the compiler's output.
"""

import os
import shutil
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (the full ~30 min suite; CI does)")


def pytest_configure(config):
    import jax

    if config.getoption("markexpr") != "gpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    if not hasattr(config, "workerinput"):  # a plain run or the controller
        _build_native()


def _build_native():
    if not (shutil.which("make")
            and shutil.which(os.environ.get("CXX", "g++"))):
        return
    proc = subprocess.run(["make", "-C", NATIVE], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        pytest.exit(f"make -C native failed:\n{proc.stdout}{proc.stderr}",
                    returncode=1)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); "
                    "run `python -m pytest tests -m gpu` on the card")
    return dev


def pytest_collection_modifyitems(config, items):
    """Keep the default run under ~10 min on a small box: the heaviest
    integration tests (multihost, stream e2e, oracle recall stress, ...)
    are @pytest.mark.slow and need --runslow or AR_SLAM_SLOW=1."""
    if config.getoption("--runslow") or os.environ.get("AR_SLAM_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow test: use --runslow or AR_SLAM_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
