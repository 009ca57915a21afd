"""Micro-benchmark: float-cosine vs binary-Hamming LBD line matching (both
plain XLA), host time per call after warm-up.

Run: python scripts/bench_line_match.py
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plslam.models import frontend_lines as fl  # noqa: E402


def timeit(fn, *args, n=50, warmup=25):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    rng = np.random.default_rng(0)
    N = 96
    segs1 = jnp.asarray(rng.uniform(0, 400, (N, 4)), jnp.float32)
    segs2 = segs1 + jnp.asarray(rng.normal(0, 2, (N, 4)), jnp.float32)
    v = jnp.ones((N,), jnp.float32)
    d = rng.normal(size=(N, fl.N_BANDS * 8)).astype(np.float32)
    desc1 = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    desc2 = jnp.asarray(desc1 + 0.1 * rng.normal(size=d.shape).astype(np.float32))
    db1 = fl.binarize_lbd(desc1)
    db2 = fl.binarize_lbd(desc2)

    t_float = timeit(lambda: fl.match_lbd(desc1, segs1, v, desc2, segs2, v))
    t_bin = timeit(lambda: fl.match_lbd_binary(db1, segs1, v, db2, segs2, v))
    dev = jax.devices()[0]
    print(json.dumps({"float_cosine_ms": round(t_float, 3),
                      "binary_xla_ms": round(t_bin, 3),
                      "platform": dev.platform, "device_kind": dev.device_kind}))


if __name__ == "__main__":
    main()
