"""Experiment: does appearance-level loop closure fire end-to-end on rendered
imagery? Mirrors tests/test_loop_e2e.py but with diagnostics printed.

Run (from the repository root): PYTHONPATH=. python scripts/exp_loop.py
"""
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from plslam.config import (
    CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig, TrackerConfig,
)
from plslam.eval.metrics import ate_rmse
from plslam.io import render, synthetic
from plslam.ops.cameras import PinholeRadTan
from plslam.runner import run_euroc
from plslam.utils.geometry import quat_to_rot


def main():
    H, W = 240, 376
    params = synthetic.TrajectoryParams(omega=0.5, z_omega=0.8)
    seq = synthetic.make_sequence(duration=14.0, n_points=500, n_lines=40, seed=23,
                                  params=params)
    cam = PinholeRadTan.create(160.0, 160.0, W / 2, H / 2)
    tmp = tempfile.mkdtemp(prefix="exp_loop_")
    print("rendering to", tmp, flush=True)
    render.write_euroc_dataset(seq, tmp, cam, H, W, max_frames=280, blob_sigma=3.0,
                               style="textured")

    R_bc = np.array(quat_to_rot(seq.q_bc))
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=160.0, fy=160.0,
                            cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=18, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype="float64",
                            focal_length=160.0),
        extrinsic=ExtrinsicConfig(0, tuple(R_bc.reshape(-1)), tuple(np.array(seq.p_bc))),
        loop=LoopConfig(loop_closure=True, min_loop_gap=40, max_keyframes=512),
    )
    ts, ps, qs, est, pg = run_euroc(tmp, cfg, use_lines=False, progress=True)
    print("initialized:", est.initialized, "keyframes:", pg.n, "db:", pg.db.n)
    # per-frame position error vs GT (divergence profile)
    gt_t = np.asarray(seq.frame_t)
    gt_p = np.asarray(seq.gt_p)
    errs = [np.linalg.norm(p - gt_p[np.argmin(np.abs(gt_t - t))]) for t, p in zip(ts, ps)]
    for k in range(0, len(errs), 10):
        print(f"  t={ts[k]:.1f} |err|={errs[k]:.3f}")
    print("loop_count:", pg.loop_count)
    for rec in pg.stats:
        print("  candidate", rec)
    raw_ate = ate_rmse(ts, ps, np.asarray(seq.frame_t), np.asarray(seq.gt_p), align="yaw")
    print("raw ATE:", raw_ate)
    if pg.loop_count:
        ps_corr = np.stack([pg.correct(p, np.array([1.0, 0, 0, 0]))[0] for p in ps])
        corr_ate = ate_rmse(ts, ps_corr, np.asarray(seq.frame_t), np.asarray(seq.gt_p), align="yaw")
        print("corrected ATE:", corr_ate)


if __name__ == "__main__":
    main()
