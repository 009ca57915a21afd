"""Matmul-precision A/B on the GPU.

GPU f32 matmuls may run in TF32 at the default precision; every estimator
entry point is pinned to precision 'highest' (true f32) via
`utils/device.py::highest_matmul_precision`. Its cost on the GPU is not
measured. This script measures ONE level end-to-end so the cost is
attributed, not guessed:

  * backend tick (8-iter LM + FEJ marg, bench shapes 192/64) ms,
  * deployed run_euroc burst=16 on the cached 12-s rendered dataset
    (deployment shapes 96/24, f32): ATE + published fps.

All levels run in ONE process (one process per GPU): the decorator
reads PLSLAM_MATMUL_PRECISION at call time and jax's jit cache keys on the
`default_matmul_precision` trace context, so flipping the env var between
phases yields separately-compiled executables per level.

  timeout 3600 python scripts/precision_ab.py            # all three levels
  PLSLAM_MATMUL_PRECISION=high python scripts/precision_ab.py --one  # one
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = "/tmp/plslam_fps_ds_v2"  # system_fps.py's 12-s dataset


def backend_tick_ms():
    import jax
    import jax.numpy as jnp

    from plslam.config import SolverConfig
    from plslam.io import synthetic
    from plslam.models import marginalization as marg
    from plslam.models import packing, solver
    from plslam.models.state import layout

    dev = jax.devices()[0]
    dtype = jnp.float32
    cfg = SolverConfig(max_features=192, max_line_feats=64)
    lay = layout(cfg)
    bseq = synthetic.make_sequence(duration=6.0, n_points=420, n_lines=160, seed=3)
    frames = list(range(0, 55, 5))
    state64, f64v = packing.factors_from_synthetic(bseq, frames, cfg, lay)
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, t)
    state = jax.device_put(cast(state64), dev)
    f = jax.device_put(cast(f64v), dev)

    @jax.jit
    def be_tick(st, fac):
        st_out, stats = solver.optimize_window(st, fac, lay, cfg, num_iters=8)
        prior = marg.marginalize_old(st_out, fac, lay, cfg, groups=stats.groups)
        return st_out, stats, prior

    @jax.jit
    def jitter_state(st, k):
        return st._replace(p=st.p + 1e-7 * jnp.sin(k.astype(st.p.dtype)))

    ks = [jax.device_put(jnp.asarray(i, jnp.int32), dev) for i in range(80)]
    outs = []
    for i in range(30):  # warmup
        outs.append(be_tick(jitter_state(state, ks[i]), f)[2].r0)
    jax.block_until_ready(outs)
    outs = []
    t0 = time.time()
    n = 48
    for i in range(n):
        outs.append(be_tick(jitter_state(state, ks[30 + i % 50]), f)[2].r0)
    jax.block_until_ready(outs)
    return (time.time() - t0) / n * 1e3


def deployed_burst():
    import numpy as np

    from plslam import runner
    from plslam.config import (
        CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig,
        TrackerConfig,
    )
    from plslam.eval.metrics import ate_rmse

    if not os.path.exists(os.path.join(CACHE, "meta.npz")):
        env = dict(os.environ, JAX_PLATFORMS="cpu")  # render off the GPU
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(__file__), "system_fps.py"),
                        "--render"], check=True, env=env, timeout=1800)
    meta = np.load(os.path.join(CACHE, "meta.npz"))
    H, W, F = 480, 752, 460.0
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F,
                            cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype="float32",
                            focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)),
                                  tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False),
    )
    runner.run_euroc(CACHE, cfg, use_lines=True, burst=16)  # compile pass
    t0 = time.time()
    ts, ps, _, est, _ = runner.run_euroc(CACHE, cfg, use_lines=True, burst=16)
    wall = time.time() - t0
    ate = ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw")
    return dict(ate_m=round(float(ate), 4),
                published_fps=round(len(est.metrics) / wall, 2),
                wall_s=round(wall, 2))


def run_level(level):
    os.environ["PLSLAM_MATMUL_PRECISION"] = level
    be_ms = backend_tick_ms()
    print(f"# level={level} backend_tick_ms={be_ms:.2f}", flush=True)
    dep = deployed_burst()
    print(json.dumps({"level": level, "backend_tick_ms": round(be_ms, 2), **dep}),
          flush=True)


def main():
    if "--one" in sys.argv:
        run_level(os.environ.get("PLSLAM_MATMUL_PRECISION", "highest"))
        return
    for level in ("default", "high", "highest"):
        run_level(level)


if __name__ == "__main__":
    main()
