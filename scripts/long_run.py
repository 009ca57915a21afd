"""Long-horizon stability: 60 s of noisy synthetic VIO (600 frames, 12k IMU
samples) through the full estimator — drift growth, failure-detection
silence, and steady-state timing. The reference's EuRoC sequences are
1–2 min; this is the matching-duration stress while the dataset is absent.

Run (CPU, from the repository root): PYTHONPATH=. python scripts/long_run.py
"""
import time

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from plslam.config import PLSlamConfig, SolverConfig
from plslam.eval.metrics import ate_rmse, rpe
from plslam.io import synthetic
from plslam.runner import run_synthetic


def main():
    seq = synthetic.make_sequence(
        duration=60.0, n_points=260, n_lines=48, seed=29,
        acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002,
        pix_noise=0.5,
    )
    cfg = PLSlamConfig(solver=SolverConfig(max_features=96, max_line_feats=24,
                                           dtype="float64"))
    t0 = time.time()
    ts, ps, qs, est = run_synthetic(seq, cfg, oracle_init=True)
    wall = time.time() - t0
    gt_t = np.asarray(seq.frame_t)
    gt_p = np.asarray(seq.gt_p)
    ate = ate_rmse(ts, ps, gt_t, gt_p, align="yaw")
    rpe_t, rpe_r = rpe(ts, np.asarray(ps), gt_t, gt_p,
                       est_q=np.asarray(qs), gt_q=np.asarray(seq.gt_q), delta=1.0)
    failures = sum(1 for m in est.metrics if m.get("failure"))
    # drift growth: ATE of first vs second half
    half = len(ts) // 2
    ate_1 = ate_rmse(ts[:half], ps[:half], gt_t, gt_p, align="yaw")
    ate_2 = ate_rmse(ts[half:], ps[half:], gt_t, gt_p, align="yaw")
    print(f"frames={len(ts)} wall={wall:.0f}s ({len(ts)/wall:.1f} fps host+CPU)")
    print(f"ATE yaw={ate:.3f} m  (1st half {ate_1:.3f}, 2nd half {ate_2:.3f})")
    print(f"RPE-1s={rpe_t:.3f} m / {rpe_r:.2f} deg   failures={failures}")


if __name__ == "__main__":
    main()
