"""Quantify the `all_image_frame` deviation (VERDICT r3 item 9).

The reference's `visualInitialAlign` runs the gyro-bias/scale/gravity
alignment over ALL frames buffered since start (`all_image_frame`, ~20 Hz),
while this repo aligns over the 11 keyframe-window frames only (documented
deviation, plslam/models/initializer.py). This ablation isolates exactly
what the denser buffer buys: the SAME time span, the SAME noisy IMU stream,
ground-truth-SFM poses with realistic visual noise, aligned with 11 frames
(10 Hz window) vs 21 frames (20 Hz dense buffer), over N seeds. Reported:
scale error, gravity tilt, success rate.

Run (CPU): python scripts/init_buffer_ablation.py

MEASURED RESULT (2026-08-19, 20 seeds, EuRoC-class IMU noise + realistic
per-frame SFM noise, matched 1.0 s span in the excitation preamble):

    frames=11: scale_err mean 25.1% median 25.2%   gravity_tilt mean 3.05°
    frames=21: scale_err mean 58.2% median 58.3%   gravity_tilt mean 6.95°

Isolation (6 seeds): IMU noise alone and accel/gyro bias alone cost ~0.2 %
scale at EITHER density; per-frame SFM position noise (0.004 visual units ≈
1 cm at metric scale — the measured window-BA level) is the dominant error
and DENSER frames make it strictly WORSE: the alignment regresses
preintegrated deltas against per-interval VISUAL position deltas, and
halving the frame spacing halves the delta signal while the i.i.d. per-frame
localization noise stays — classic errors-in-variables attenuation. The
reference's `all_image_frame` non-keyframes are PnP-localized (noisier than
window-BA keyframes), so its dense buffer sits even deeper in this regime.
CONCLUSION: the window-only deviation is kept — at matched span it measures
2.3× BETTER scale and tilt than the dense buffer (VERDICT r3 item 9 closed).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from plslam.config import ImuConfig, PLSlamConfig, SolverConfig
from plslam.io import synthetic
from plslam.models import initializer as ini
from plslam.models.estimator import _preintegrate_padded, ImuBuffer
from plslam.ops import imu as imu_ops
from plslam.utils import quat_np as qnp

S_TRUE = 2.5  # visual-frame scale the alignment must recover
SPAN = (0.6, 1.6)  # seconds: inside the wiggle-excitation preamble
# (the regime real initialization runs in — scale needs acceleration
# variation; by t=2 the preamble has decayed and ANY aligner degrades)
SFM_ROT_NOISE = 0.002  # rad — realistic window-BA orientation error
SFM_POS_NOISE = 0.004  # unit-less visual-frame position error (~0.4 % of span)


class _StubEst:
    """Just enough of Estimator for the alignment functions."""

    def __init__(self, nw, dtype=jnp.float64):
        self.cfg = SolverConfig(window_size=nw)
        self.config = PLSlamConfig(imu=ImuConfig())
        self.p_bc = np.array([0.05, 0.02, 0.0])
        self.dtype = dtype
        self.noise = imu_ops.ImuNoise(
            *[jnp.asarray(v, dtype) for v in (0.08, 0.004, 4e-5, 2e-6)])


def _align_once(seq, params, frame_ts, rng):
    """Run gyro-bias + linear alignment + gravity refinement over the frames
    at `frame_ts`; return (scale_rel_err, gravity_tilt_deg) or None."""
    nw = len(frame_ts) - 1
    est = _StubEst(nw)

    # ground-truth body poses at frame times → ℓ-camera visual frame
    from plslam.io.synthetic import gt_pose

    ps, qs = [], []
    for t in frame_ts:
        p, q = gt_pose(params, jnp.asarray(float(t)))
        ps.append(np.asarray(p, np.float64))
        qs.append(np.asarray(q, np.float64))
    p_w = np.stack(ps)
    q_wb = np.stack(qs)
    R_bc = qnp.quat_to_rot(np.asarray(seq.q_bc))
    # camera-ℓ frame: x_cl = R_wcl⁻¹ (x_w − p_wcl)
    R_wc0 = qnp.quat_to_rot(q_wb[0]) @ R_bc
    p_wc0 = p_w[0] + qnp.quat_to_rot(q_wb[0]) @ est.p_bc
    R_cl_w = R_wc0.T
    # body poses in ℓ-cam frame, positions scale-stripped + SFM noise
    q_bl = np.stack([
        qnp.quat_mul(qnp.rot_to_quat(R_cl_w @ qnp.quat_to_rot(q)),
                     qnp.quat_exp(SFM_ROT_NOISE * rng.standard_normal(3)))
        for q in q_wb])
    p_cam_w = p_w + np.stack([qnp.quat_to_rot(q) @ est.p_bc for q in q_wb])
    p_cl = ((p_cam_w - p_wc0) @ R_wc0) / S_TRUE
    p_cl = p_cl + SFM_POS_NOISE * rng.standard_normal(p_cl.shape)
    p_cl[0] = 0.0

    # per-interval preintegrations from the NOISY IMU stream
    imu_t = np.asarray(seq.imu_t)
    acc = np.asarray(seq.imu_acc)
    gyr = np.asarray(seq.imu_gyr)
    pres_h = [None]
    for k in range(nw):
        lo = np.searchsorted(imu_t, frame_ts[k] - 1e-9)
        hi = np.searchsorted(imu_t, frame_ts[k + 1] + 1e-9)
        buf = ImuBuffer()
        buf.seed(acc[lo], gyr[lo])
        for i in range(lo + 1, hi):
            buf.append(acc[i], gyr[i], imu_t[i] - imu_t[i - 1])
        a, g_, d = buf.padded(jnp.float64)
        pre = _preintegrate_padded(a, g_, d, jnp.zeros(3, jnp.float64),
                                   jnp.zeros(3, jnp.float64), est.noise)
        pres_h.append({k2: np.asarray(v, np.float64) for k2, v in pre.items()})

    bg = ini._solve_gyro_bias(est, q_bl, pres_h)
    # repropagate at the solved bias
    for k in range(nw):
        lo = np.searchsorted(imu_t, frame_ts[k] - 1e-9)
        hi = np.searchsorted(imu_t, frame_ts[k + 1] + 1e-9)
        buf = ImuBuffer()
        buf.seed(acc[lo], gyr[lo])
        for i in range(lo + 1, hi):
            buf.append(acc[i], gyr[i], imu_t[i] - imu_t[i - 1])
        a, g_, d = buf.padded(jnp.float64)
        pre = _preintegrate_padded(a, g_, d, jnp.zeros(3, jnp.float64),
                                   jnp.asarray(bg, jnp.float64), est.noise)
        pres_h[k + 1] = {k2: np.asarray(v, np.float64) for k2, v in pre.items()}
    out = ini._linear_alignment(est, p_cl, q_bl, pres_h)
    if out is None:
        return None
    g_cl, s, _ = out
    # scale: metric = s · visual; truth: metric = S_TRUE · visual
    s_err = abs(s - S_TRUE) / S_TRUE
    # gravity tilt vs ground truth (sign convention of the solved vector is
    # internal to the alignment — measure against both and take the aligned one)
    g_true = R_cl_w @ np.array([0.0, 0.0, 9.81])
    c = np.dot(g_cl, g_true) / (np.linalg.norm(g_cl) * np.linalg.norm(g_true))
    tilt = np.degrees(np.arccos(np.clip(abs(c), -1, 1)))
    return s_err, tilt


def main():
    rows = {11: [], 21: []}
    fails = {11: 0, 21: 0}
    for seed in range(20):
        params = synthetic.TrajectoryParams(wiggle_amp=0.2)
        seq = synthetic.make_sequence(
            duration=6.0, n_points=60, n_lines=0, seed=seed, params=params,
            acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002)
        rng = np.random.default_rng(100 + seed)
        for n, dt in ((11, 0.1), (21, 0.05)):
            ts = SPAN[0] + dt * np.arange(n)
            out = _align_once(seq, params, ts, rng)
            if out is None:
                fails[n] += 1
            else:
                rows[n].append(out)
    for n in (11, 21):
        a = np.asarray(rows[n])
        print(f"frames={n:2d}: success {len(a)}/20  "
              f"scale_err mean {100*a[:,0].mean():.2f}% median {100*np.median(a[:,0]):.2f}%  "
              f"gravity_tilt mean {a[:,1].mean():.3f}° median {np.median(a[:,1]):.3f}°")


if __name__ == "__main__":
    main()
