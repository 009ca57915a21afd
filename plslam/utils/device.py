"""Host→device array conversion with a defensive copy.

On the CPU backend, XLA may ZERO-COPY a numpy buffer into a jax.Array when
dtype/layout/alignment line up (observed for float64 and int32 arrays when
the requested dtype matches). The jax.Array is then an alias of the live
host buffer: any later in-place numpy mutation silently mutates the
"immutable" device array. This corrupted the estimator's factor snapshot —
`_reject_outliers` drops slots in place between the solve and the
marginalization, and the marginalization then read post-drop tables
(nondeterministically, since whether XLA zero-copies depends on allocation
details). A transfer to an accelerator always copies; tests (CPU, float64)
bite.

Every conversion of a host array that is mutated in place afterwards must go
through `asdev`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def asdev(x, dtype=None):
    """`jnp.asarray` with a guaranteed host-side copy first."""
    return jnp.asarray(np.array(x), dtype)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing is
    set here. Otherwise the cache goes to the fixed `.jax_cache` of the
    repository holding this package: the directory is part of the cache key,
    so a path that moved would never hit."""
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def pull_all(*xs):
    """Read several device arrays back to host with OVERLAPPED round trips:
    start every copy async, then materialize."""
    for x in xs:
        try:
            x.copy_to_host_async()
        except Exception:
            pass
    return [np.asarray(x) for x in xs]


def highest_matmul_precision(fn):
    """Decorator: trace `fn`'s ops at matmul precision 'highest' (true f32).

    At the default precision a GPU may run float32 matmuls in TF32 (~3
    decimal digits). The frontends tolerate that (pixel noise dominates), but
    the estimator numerics — whitened residual stacks, JᵀJ/Schur assembly,
    covariance propagation — would lose ~3 decimal digits, which compounds
    through the window solve. The cost of 'highest' on the GPU is not
    measured (`scripts/precision_ab.py` measures it). CPU backends ignore the
    setting, so the f64 test mesh is unaffected.

    Apply to every solver/marginalization/preintegration/initialization
    entry point; leave the image-plane frontend kernels on the fast default.

    `PLSLAM_MATMUL_PRECISION` overrides the level ('highest' default;
    'high' and 'default' for A/B measurement).
    """
    import functools
    import os

    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        # read at CALL time: the precision context is part of jax's jit cache
        # key, so an A/B harness can flip the env var inside ONE process
        # and get separately-compiled executables per level
        level = os.environ.get("PLSLAM_MATMUL_PRECISION", "highest")
        with jax.default_matmul_precision(level):
            return fn(*args, **kwargs)

    return wrapped
