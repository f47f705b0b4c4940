"""Test configuration.

Tests run on CPU with 8 virtual devices so the multi-chip sharding paths
(Mesh/shard_map) are exercised without accelerators; float64 is enabled to
match the reference's all-real64 numerics (``src/numeric_kinds.f90:10``).
Must run before the first jax import.
"""

import os

# Force CPU: the tests are CPU tests; benchmarks (bench.py) and the
# compiled kernels run on a GPU (chip_smoke.py).
# NOTE: jax may already be imported by a pytest plugin before this conftest
# runs, so setting the env var alone is not enough; jax.config.update works
# as long as no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

assert jax.default_backend() == "cpu", (
    "tests must run on CPU; a backend was initialized before conftest")
assert len(jax.devices()) >= 8

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (the million-row regression tier; "
        "also enabled by FDT_RUN_SLOW=1 — CI runs them nightly)")


def pytest_collection_modifyitems(config, items):
    """Default run skips the `slow` tier (million-row CPU solves that
    dominated the suite wall time, ~22 -> ~10 min). Every coverage CLASS
    keeps a fast representative (noise gate / polish / stall / refined
    pencil all run at the 100k-200k scale unmarked); the slow tier
    re-pins the same behavior at the 1M scale on demand:
    ``pytest --runslow`` or ``FDT_RUN_SLOW=1``."""
    if config.getoption("--runslow") or os.environ.get("FDT_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow or set "
                            "FDT_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_cache_memory():
    """Per-module cache cleanup: the suite compiles hundreds of engine
    variants (every (config, constrain) pair is its own XLA executable)
    and holds module-scope million-row fixtures; without eviction the
    accumulated executables exhaust host memory near the end of the full
    run (observed: XLA CPU compile aborting with a fatal error at ~95%
    of the suite). Engines are config-keyed, so cross-module reuse is
    rare and re-compilation is cheap relative to the test bodies."""
    yield
    from fortran_davidson_tpu import clear_compiled_caches
    clear_compiled_caches()
    jax.clear_caches()
