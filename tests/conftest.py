"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip sharding paths are validated on virtual CPU devices
(``xla_force_host_platform_device_count``) so the suite runs anywhere; the
driver separately dry-run-compiles the multi-chip path (see
``__graft_entry__.dryrun_multichip``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"  # tests always run on (virtual) CPU devices

import jax  # noqa: E402

# jax may already be imported by the environment with a TPU platform; the
# config route works post-import (env vars would be too late).
jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"

# Persist the (CPU) test compiles across runs: on a fresh host the suite is
# compile-bound (~17 min cold vs ~5 min warm). HYBRIDGL_COMPILE_CACHE=0 opts out.
from hybridgl_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "quick: fast tier (run with -m quick); auto-applied to non-slow tests"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is False"
    )


def pytest_collection_modifyitems(config, items):
    # every test not explicitly marked slow belongs to the quick tier, so
    # `pytest -m quick` is the fast pre-commit loop and the plain run stays
    # the full battery
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)
