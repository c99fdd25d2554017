"""Test config: run everything on a virtual 8-device CPU mesh.

This is the standard JAX way to test multi-device sharding without
hardware; the same code paths run unchanged on a mesh of GPUs.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (after env setup on purpose)

from nerfacc_tpu.compile_cache import setup_compile_cache  # noqa: E402

# persistent compilation cache: repeated test runs skip recompiles
setup_compile_cache(min_compile_time_secs=0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

assert len(jax.devices()) == 8, (
    f"expected 8 virtual CPU devices, got {jax.devices()}"
)
