"""Device time of the two operations that once had hand-written kernels:
the batched-matmul LK tracker (`frontend_points.lk_track_fast`) and the XLA
Hamming distance matrix (xor + popcount + sum), at the widths the pipeline
runs them. This is the number a future hand-written GPU kernel has to beat.

    python scripts/kernel_device_time.py [--out chiprun_out/kernel_device_time]

Each operation runs warm, then N times on the host clock (wall per call,
dispatch included), then N more times inside its own `jax.profiler` trace;
its device time per call is the union of the kernel intervals on the GPU's
stream lines over N, and its kernel count per call is read from the same
trace. Requires a GPU. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

N_CALLS = 50


def busy_ns(trace_dir: str) -> tuple[int, int]:
    """Union of the device's kernel intervals in the newest trace under
    `trace_dir`, and the number of kernels."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.end_ns) for e in line.events]
    spans.sort()
    total, end = 0, -1
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return int(total), len(spans)


def time_op(name, fn, args, out_dir):
    for _ in range(5):
        r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        r = fn(*args)
    jax.block_until_ready(r)
    wall = time.perf_counter() - t0
    d = os.path.join(out_dir, name)
    with jax.profiler.trace(d):
        for _ in range(N_CALLS):
            r = fn(*args)
        jax.block_until_ready(r)
    busy, n_kernels = busy_ns(d)
    return {"device_us_per_call": busy / N_CALLS / 1e3,
            "wall_us_per_call": wall / N_CALLS * 1e6,
            "kernels_per_call": n_kernels / N_CALLS}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernel_device_time")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX's first device is {dev.platform!r}")
    from plslam.models import frontend_lines as fl
    from plslam.models import frontend_points as fp
    from plslam.models import keyframe_db as kdb

    rng = np.random.default_rng(0)
    h, w = 480, 752
    # smooth texture and a sub-pixel shifted copy (real LK work per feature)
    img = rng.standard_normal((h + 8, w + 8)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(3):
            img = (np.roll(img, 1, ax) + 2 * img + np.roll(img, -1, ax)) / 4
    img = (img - img.min()) / (img.max() - img.min())
    img0, img1 = jnp.asarray(img[4:4 + h, 4:4 + w]), jnp.asarray(img[3:3 + h, 5:5 + w])
    pyr0 = fp.build_pyramid(img0, levels=fp.auto_levels((h, w)))
    pyr1 = fp.build_pyramid(img1, levels=fp.auto_levels((h, w)))
    uv, sc = fp.shi_tomasi_grid(img0, jnp.zeros((1, 2), jnp.float32),
                                jnp.zeros((1,), jnp.float32), cell=30, max_out=150)
    valid = sc > 1e-5
    words = lambda n: jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    ops = {
        "lk_track_fast_150": (fp.lk_track_fast, (pyr0, pyr1, uv, valid)),
        "hamming_lines_64x64": (jax.jit(fl._hamming_dist), (words(64), words(64))),
        "hamming_brief_256x256": (kdb.hamming_matrix, (words(256), words(256))),
        "hamming_brief_384x256": (kdb.hamming_matrix, (words(384), words(256))),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = {"device_kind": dev.device_kind, "nvidia_smi": smi,
           "n_calls": N_CALLS, "ops": {}}
    for name, (fn, a) in ops.items():
        res["ops"][name] = time_op(name, fn, a, args.out)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
