"""Multi-minute loop-closure drift study on rendered imagery.

The reference dumps `vins_result_no_loop.csv` and `vins_result_loop.csv` and
the claim is that 4-DoF pose-graph correction reduces absolute drift on long
sequences. Short 14-s runs cannot show this (loop edges inherit the ~0.1 m
local reconstruction error); this script runs a LONG rendered
circuit (default 150 s, ~12 revisits of the same wall) through the FULL image
pipeline twice — loop closure off, then on — and compares pointwise ATE.

CPU (f64 streaming, slow):
  python scripts/loop_drift_run.py 150
GPU (deployment f32, offline burst):
  python scripts/loop_drift_run.py 150 --gpu --burst 16
Rendering runs in a child process held to the CPU either way (cached per
duration+seed).
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, F = 480, 752, 460.0
CACHE_ROOT = "/tmp/plslam_loopdrift_ds"


def render_dataset(duration: float, seed: int = 23):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from plslam.io import render, synthetic
    from plslam.ops.cameras import PinholeRadTan
    from plslam.utils.geometry import quat_to_rot

    out = os.path.join(CACHE_ROOT, f"d{int(duration)}_s{seed}")
    if os.path.exists(os.path.join(out, "meta.npz")):
        return out
    params = synthetic.TrajectoryParams(omega=0.5, z_omega=0.8, wiggle_amp=0.15)
    seq = synthetic.make_sequence(
        duration=duration, n_points=500, n_lines=40, seed=seed, params=params,
        acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002,
    )
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    render.write_euroc_dataset(seq, out, cam, H, W, max_frames=int(duration * 20),
                               blob_sigma=3.0, style="textured")
    np.savez(os.path.join(out, "meta.npz"),
             R_bc=np.array(quat_to_rot(seq.q_bc)), p_bc=np.array(seq.p_bc),
             gt_t=np.asarray(seq.frame_t), gt_p=np.asarray(seq.gt_p),
             gt_q=np.asarray(seq.gt_q))
    print(f"rendered {int(duration*20)} frames in {time.time()-t0:.0f}s → {out}",
          flush=True)
    return out


def main(duration=150.0, gpu=False, burst=0, seed=23):
    if "--render" in sys.argv:
        render_dataset(duration, seed)
        return
    path = os.path.join(CACHE_ROOT, f"d{int(duration)}_s{seed}")
    if not os.path.exists(os.path.join(path, "meta.npz")):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(duration), "--render", f"--seed={seed}"],
                       check=True, env=env, timeout=7200)
    import jax

    if not gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"--gpu: JAX's first device is {jax.devices()[0].platform!r}")
    import numpy as np

    from plslam.config import (
        CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig,
        TrackerConfig,
    )
    from plslam.eval.metrics import ate_rmse, rpe
    from plslam.runner import run_euroc

    meta = np.load(os.path.join(path, "meta.npz"))
    dtype = "float32" if gpu else "float64"
    base = dict(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F,
                            cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype=dtype,
                            focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)),
                                  tuple(meta["p_bc"])),
    )
    gt_t = np.asarray(meta["gt_t"])
    gt_p = np.asarray(meta["gt_p"])
    gt_q = np.asarray(meta["gt_q"])

    results = {}
    out = {"duration_s": duration, "dtype": dtype, "burst": burst}
    for name, loop in (("no_loop", False), ("loop", True)):
        cfg = PLSlamConfig(**base, loop=LoopConfig(
            loop_closure=loop, min_loop_gap=40, max_keyframes=2048))
        t0 = time.time()
        ts, ps, qs, est, pg = run_euroc(path, cfg, use_lines=False, burst=burst)
        wall = time.time() - t0
        ate = ate_rmse(ts, ps, gt_t, gt_p, align="yaw")
        rpe_t, rpe_r = rpe(ts, np.asarray(ps), gt_t, gt_p,
                           est_q=np.asarray(qs), gt_q=gt_q, delta=1.0)
        half = len(ts) // 2
        ate2 = ate_rmse(ts[half:], ps[half:], gt_t, gt_p, align="yaw")
        loops = pg.loop_count if pg is not None else 0
        results[name] = ate
        out[name] = dict(frames=len(ts), ate_m=round(float(ate), 3),
                         ate_2nd_half_m=round(float(ate2), 3),
                         rpe_1s_m=round(float(rpe_t), 3), loops=int(loops),
                         wall_s=round(wall, 1))
        print(f"{name}: frames={len(ts)} ATE={ate:.3f} m (2nd half {ate2:.3f}) "
              f"RPE-1s={rpe_t:.3f} m/{rpe_r:.2f}° loops={loops} wall={wall:.0f}s",
              flush=True)
    if results.get("loop") is not None:
        gain = results["no_loop"] / max(results["loop"], 1e-9)
        out["ate_gain"] = round(float(gain), 2)
        print(f"loop-closure ATE gain: {gain:.2f}× "
              f"({results['no_loop']:.3f} → {results['loop']:.3f} m)")
    print(json.dumps(out))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("duration", nargs="?", type=float, default=150.0)
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--burst", type=int, default=0)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--render", action="store_true")
    a = ap.parse_args()
    main(a.duration, gpu=a.gpu, burst=a.burst, seed=a.seed)
