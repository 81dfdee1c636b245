"""Test config: an 8-device virtual CPU platform so sharding tests run
anywhere, and deterministic numerics.

The suite runs on the CPU unless JAX_PLATFORMS names another platform:
chip_smoke.py runs the `chip`-marked tests with JAX_PLATFORMS=cuda."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_default_matmul_precision", "highest")

# Arm the persistent compile cache for the suite (the default suite is
# compile-dominated). Same directory as utils/jaxcache.py's default.
_CACHE = os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jaxcache")
if jax.config.jax_compilation_cache_dir is None:
    jax.config.update("jax_compilation_cache_dir", _CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
