"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
(shard_map/pjit collectives) are exercised without accelerator hardware —
the strategy prescribed in SURVEY.md §4. Tests marked `gpu` need the card
and decide inside the `gpu` fixture below whether to skip.
"""

import os

# tier-1 runs on the CPU; JAX_PLATFORMS=cuda,cpu runs the `gpu` tests on the
# card (CUDA first) with the CPU backend beside it for their references
_PLATFORM = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_default_matmul_precision", "highest")

if _PLATFORM == "cpu":
    assert len(jax.devices()) == 8, jax.devices()

# persistent compile cache: repeat test runs skip recompilation
from texturefusion_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import pytest  # noqa: E402

# Heavy integration modules (full-pipeline / shard_map compile loads):
# auto-marked `slow` so `pytest -m "not slow"` is the sub-2-minute
# quick-smoke signal for the build loop.
_SLOW_MODULES = {
    "test_pipeline", "test_streaming_pipeline", "test_origins",
    "test_checkpoint_cli", "test_gcslam", "test_parallel",
    "test_bench_regression", "test_ate_proxy_cli", "test_icp",
}


@pytest.fixture(scope="session")
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
