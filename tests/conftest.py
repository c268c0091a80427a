"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Unit tests validate numerics and sharding on the host CPU so they are
deterministic and runnable anywhere. The settings are applied with
jax.config before the first backend use, so they hold even when jax was
imported before pytest started. Tests that need the GPU carry the `gpu`
marker and request the `gpu_device` fixture, which skips them here; run
them on the card with `python -m pytest tests/ -m gpu -p no:cacheprovider`
under LIBZL_TPU_TEST_GPU=1 (the variable keeps this CPU forcing off).
"""

import os

import pytest

ON_GPU = bool(os.environ.get("LIBZL_TPU_TEST_GPU"))

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache (libzl_tpu.device: JAX_COMPILATION_CACHE_DIR
# when set, else the checkout's .jax_cache/): the suite's wall time is
# dominated by recompiling the same CPU graphs every run, so caching them
# across runs keeps the inner loop fast. LIBZL_TPU_NO_COMPILE_CACHE=1
# disables (e.g. to measure cold-compile time).
if not os.environ.get("LIBZL_TPU_NO_COMPILE_CACHE"):
    from libzl_tpu.device import use_compile_cache  # noqa: E402

    use_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, so every xdist worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run with LIBZL_TPU_TEST_GPU=1 on the card)")
    return devices[0]
