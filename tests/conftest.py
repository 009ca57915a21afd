"""Test config: force the CPU backend with 8 virtual devices (the JAX
fake-backend technique from SURVEY.md §4) and enable x64 so numerical
-derivative checks are meaningful. The accelerator path stays float32; modules
are dtype-generic.

The platform is switched via jax.config BEFORE any operation runs, so the
suite stays on the CPU even where an accelerator is present.
"""
import os

# must precede backend initialization (read at PJRT client creation)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (backend still uninitialized)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite triggers ~hundreds of XLA:CPU
# compiles; LLVM has crashed (SIGSEGV inside backend_compile_and_load) twice
# mid-suite — both times in a long-lived process after many compiles, never in
# isolation. Caching compiled executables on disk makes reruns skip LLVM
# almost entirely (and cuts suite wall-clock drastically). The directory is
# JAX_COMPILATION_CACHE_DIR when set, else the repository's `.jax_cache`.
from plslam.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop in-memory executables between test modules — keeps the
    long-lived pytest process lean (refills cheaply from the disk cache)."""
    yield
    jax.clear_caches()
