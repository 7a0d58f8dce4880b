"""Test configuration: CPU backend with a virtual 8-device mesh and x64
enabled so the CPU oracle matches the reference's f64 semantics.

Must run before the first jax import (hence env vars set at module import).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["ARROWSPACE_TEST_MODE"] = "1"

import jax  # noqa: E402

from arrowspace_tpu.config import DEFAULT_CACHE_DIR  # noqa: E402

# Force the CPU backend explicitly (whatever accelerator the host has) so
# the oracle tests run in true f64 on the virtual 8-device mesh.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compile cache keeps repeated test runs fast: the directory
# JAX_COMPILATION_CACHE_DIR names (JAX reads it itself), else the fixed
# one inside the checkout (config.setup_cache's rule).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]
