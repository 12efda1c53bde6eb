"""Test configuration (must run BEFORE jax import).

Runs on the CPU unless ``JAX_PLATFORMS`` says otherwise, with a virtual
8-device CPU platform so sharding tests run on one host.  Tests marked
``gpu`` need a CUDA device and skip without one; on a GPU machine run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    A full single-process suite run compiles hundreds of large CPU programs
    (8 virtual devices, wavefront loops); holding them all live has produced
    LLVM aborts/segfaults in `backend_compile_and_load` late in the run.
    Dropping the caches per module keeps the peak bounded (tests re-compile
    what they need)."""
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow",
        action="store_true",
        default=False,
        help="run slow (full-resolution render) tests",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip_slow = pytest.mark.skip(reason="needs --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
