"""Synthetic visual-inertial sequence generator (ground-truth-exact).

The reference had no test suite (SURVEY.md §4) and was validated end-to-end on
EuRoC rosbags. Our substitute — and the upgrade — is an analytic simulator:
a C∞ trajectory whose derivatives are produced by JAX autodiff, from which we
synthesize *exactly consistent* IMU samples, camera point observations and
line-segment observations. This gives closed-form ground truth for every test
(preintegration residual ≈ 0 at the true states; BA must recover the true
trajectory) without any dataset on disk.

Also doubles as the deterministic fault-injection hook the reference lacked
(SURVEY.md §5.3): noise/bias/dropout are all parameters.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from plslam.ops.cameras import PinholeRadTan, project
from plslam.utils.geometry import quat_to_rot, rot_to_quat, ypr_to_rot

G_WORLD = np.array([0.0, 0.0, 9.81007])  # the reference's G (SURVEY.md §A.2)


class TrajectoryParams(NamedTuple):
    radius: float = 4.0
    omega: float = 0.6  # rad/s around the circle
    z_amp: float = 0.6
    z_omega: float = 1.1
    pitch_amp: float = 0.12
    roll_amp: float = 0.1
    # initialization-excitation preamble: a decaying multi-axis wobble at the
    # start of the trajectory, matching how EuRoC sequences begin (the pilot
    # excites the IMU before flying) — monocular-VIO scale/gravity are only
    # strongly observable under acceleration variation, so starting cold on a
    # constant-speed circle leaves init noise-fragile (measured: 0.7 px image
    # noise → 2.5° gravity tilt and 35% scale error without a preamble)
    wiggle_amp: float = 0.0  # m (0 = off)
    wiggle_omega: float = 5.0  # rad/s
    wiggle_tau: float = 1.5  # decay time constant (s)
    # persistent excitation: a NON-decaying multi-axis wobble riding the
    # circle. On a constant-rate tangent-yawed circle the centripetal
    # acceleration is CONSTANT in the body frame — indistinguishable from an
    # accelerometer bias, so scale/bias are fundamentally unobservable there
    # (measured: residual bias error drifts the scale to ~1.11 and plateaus).
    # Real EuRoC flights are dynamically excited throughout; this matches.
    excite_amp: float = 0.0  # m (0 = off)
    excite_omega: float = 3.1  # rad/s


def _pos_fn(params: TrajectoryParams):
    r, w, za, zw = params.radius, params.omega, params.z_amp, params.z_omega
    wa, wo, wt = params.wiggle_amp, params.wiggle_omega, params.wiggle_tau

    ea, eo = params.excite_amp, params.excite_omega

    def pos(t):
        p = jnp.stack(
            [r * jnp.cos(w * t), r * jnp.sin(w * t), za * jnp.sin(zw * t) + 1.5]
        )
        if wa != 0.0:
            env = wa * jnp.exp(-t / wt)
            p = p + env * jnp.stack([
                jnp.sin(wo * t), jnp.sin(1.31 * wo * t + 0.7),
                jnp.sin(0.73 * wo * t + 1.4),
            ])
        if ea != 0.0:
            p = p + ea * jnp.stack([
                jnp.sin(eo * t + 0.3), jnp.sin(1.27 * eo * t + 2.1),
                jnp.sin(0.81 * eo * t + 0.9),
            ])
        return p

    return pos


def _rot_fn(params: TrajectoryParams):
    w, pa, ra = params.omega, params.pitch_amp, params.roll_amp

    def rot(t):
        # yaw follows the tangent; pitch/roll oscillate smoothly
        ypr = jnp.stack(
            [w * t + jnp.pi / 2.0, pa * jnp.sin(0.9 * w * t), ra * jnp.cos(1.3 * w * t)]
        )
        return ypr_to_rot(ypr)

    return rot


def gt_pose(params: TrajectoryParams, t):
    """Ground-truth pose at time t: (p_w [3], q_wb [4])."""
    p = _pos_fn(params)(t)
    R = _rot_fn(params)(t)
    return p, rot_to_quat(R)


def gt_velocity(params: TrajectoryParams, t):
    _, v = jax.jvp(_pos_fn(params), (t,), (jnp.ones_like(t),))
    return v


def imu_sample(params: TrajectoryParams, t):
    """Exact body-frame IMU measurement at time t (bias-free, noise-free).

    accel:  f_b = R_wbᵀ (p̈_w + G)   (specific force, world z-up, G=+9.81 ẑ)
    gyro:   ω_b = vee(R_wbᵀ Ṙ_wb)
    """
    pos = _pos_fn(params)
    rot = _rot_fn(params)
    one = jnp.ones_like(t)
    _, v = jax.jvp(pos, (t,), (one,))
    _, a = jax.jvp(lambda s: jax.jvp(pos, (s,), (jnp.ones_like(s),))[1], (t,), (one,))
    R = rot(t)
    _, Rdot = jax.jvp(rot, (t,), (one,))
    Om = R.T @ Rdot  # [ω]× in body frame
    omega = jnp.stack([Om[2, 1], Om[0, 2], Om[1, 0]])
    g = jnp.asarray(G_WORLD, t.dtype)
    acc = R.T @ (a + g)
    return acc, omega


class SyntheticSequence(NamedTuple):
    """A fully-sampled synthetic VI sequence (all arrays, jit-friendly)."""

    # IMU stream (rate imu_hz, covering [0, T])
    imu_t: jnp.ndarray  # [M]
    imu_acc: jnp.ndarray  # [M,3]  (with noise/bias if requested)
    imu_gyr: jnp.ndarray  # [M,3]
    # camera frames (rate cam_hz)
    frame_t: jnp.ndarray  # [F]
    gt_p: jnp.ndarray  # [F,3]
    gt_q: jnp.ndarray  # [F,4]
    gt_v: jnp.ndarray  # [F,3]
    # landmarks + observations (normalized camera coords)
    landmarks: jnp.ndarray  # [L,3]
    obs: jnp.ndarray  # [F,L,2] normalized coords
    obs_valid: jnp.ndarray  # [F,L] bool
    # line segments (3D endpoints) + observations
    line_sp: jnp.ndarray  # [S,3]
    line_ep: jnp.ndarray  # [S,3]
    line_obs: jnp.ndarray  # [F,S,4] normalized (sx,sy,ex,ey)
    line_obs_valid: jnp.ndarray  # [F,S] bool
    # extrinsics body_T_cam
    p_bc: jnp.ndarray  # [3]
    q_bc: jnp.ndarray  # [4]
    # true biases used when synthesizing the IMU stream
    ba: jnp.ndarray  # [3]
    bg: jnp.ndarray  # [3]


def make_sequence(
    duration: float = 20.0,
    imu_hz: float = 200.0,
    cam_hz: float = 20.0,
    n_points: int = 160,
    n_lines: int = 64,
    params: TrajectoryParams = TrajectoryParams(),
    acc_noise: float = 0.0,
    gyr_noise: float = 0.0,
    acc_bias: float = 0.0,
    gyr_bias: float = 0.0,
    pix_noise: float = 0.0,
    cam: PinholeRadTan | None = None,
    seed: int = 0,
    dtype=None,
) -> SyntheticSequence:
    # default dtype: f64 only when the runtime actually has it — requesting
    # f64 under an f32-only runtime (the bench/dryrun) truncates silently and
    # spams a warning per array, burying real warnings in the logs
    if dtype is None:
        dtype = jnp.float64 if jax.config.x64_enabled else jnp.float32
    rng = np.random.default_rng(seed)
    if cam is None:
        cam = PinholeRadTan.euroc_cam0(dtype)

    # body_T_cam: camera looks along body +x (forward), standard z-forward cam
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    p_bc = np.array([0.05, 0.02, 0.0])
    q_bc = np.asarray(rot_to_quat(jnp.asarray(R_bc, dtype)))

    imu_t = np.arange(0.0, duration + 0.5 / imu_hz, 1.0 / imu_hz)
    frame_t = np.arange(0.0, duration, 1.0 / cam_hz)

    ts = jnp.asarray(imu_t, dtype)
    acc, gyr = jax.vmap(lambda t: imu_sample(params, t))(ts)
    ba = acc_bias * rng.standard_normal(3)
    bg = gyr_bias * rng.standard_normal(3)
    acc = np.asarray(acc) + ba + acc_noise * rng.standard_normal((len(imu_t), 3))
    gyr = np.asarray(gyr) + bg + gyr_noise * rng.standard_normal((len(imu_t), 3))

    fts = jnp.asarray(frame_t, dtype)
    gt_p, gt_q = jax.vmap(lambda t: gt_pose(params, t))(fts)
    gt_v = jax.vmap(lambda t: gt_velocity(params, t))(fts)

    # landmarks on a cylinder shell around the trajectory (visible looking outward)
    theta = rng.uniform(0, 2 * np.pi, n_points)
    rad = params.radius + rng.uniform(2.0, 6.0, n_points)
    zs = rng.uniform(-1.5, 4.0, n_points)
    landmarks = np.stack([rad * np.cos(theta), rad * np.sin(theta), zs], axis=-1)

    # vertical-ish and horizontal-ish line segments on the same shell
    theta_l = rng.uniform(0, 2 * np.pi, n_lines)
    rad_l = params.radius + rng.uniform(2.0, 6.0, n_lines)
    z0 = rng.uniform(-1.0, 3.0, n_lines)
    vert = rng.uniform(size=n_lines) < 0.6
    dtheta = np.where(vert, 0.0, rng.uniform(0.05, 0.25, n_lines))
    dz = np.where(vert, rng.uniform(0.8, 2.5, n_lines), rng.uniform(-0.3, 0.3, n_lines))
    line_sp = np.stack([rad_l * np.cos(theta_l), rad_l * np.sin(theta_l), z0], axis=-1)
    line_ep = np.stack(
        [rad_l * np.cos(theta_l + dtheta), rad_l * np.sin(theta_l + dtheta), z0 + dz],
        axis=-1,
    )

    # project everything (vectorized over frames × landmarks)
    def cam_frame_points(p_w, q_wb, pts):
        R_wb = quat_to_rot(q_wb)
        R_wc = R_wb @ jnp.asarray(R_bc, dtype)
        p_wc = p_w + R_wb @ jnp.asarray(p_bc, dtype)
        return (pts - p_wc) @ R_wc  # == R_wcᵀ (pts − p_wc) batched

    lm = jnp.asarray(landmarks, dtype)

    def obs_one_frame(p_w, q_wb):
        pc = cam_frame_points(p_w, q_wb, lm)
        uv = project(cam, pc)
        mn = pc[:, 0:2] / jnp.maximum(pc[:, 2:3], 1e-6)
        valid = (
            (pc[:, 2] > 0.3)
            & (uv[:, 0] > 5) & (uv[:, 0] < 747)
            & (uv[:, 1] > 5) & (uv[:, 1] < 475)
        )
        return mn, valid

    obs, obs_valid = jax.vmap(obs_one_frame)(gt_p, gt_q)

    sp3 = jnp.asarray(line_sp, dtype)
    ep3 = jnp.asarray(line_ep, dtype)

    def line_obs_one_frame(p_w, q_wb):
        pcs = cam_frame_points(p_w, q_wb, sp3)
        pce = cam_frame_points(p_w, q_wb, ep3)
        mns = pcs[:, 0:2] / jnp.maximum(pcs[:, 2:3], 1e-6)
        mne = pce[:, 0:2] / jnp.maximum(pce[:, 2:3], 1e-6)
        uvs = project(cam, pcs)
        uve = project(cam, pce)

        def in_img(uv):
            return (uv[:, 0] > 5) & (uv[:, 0] < 747) & (uv[:, 1] > 5) & (uv[:, 1] < 475)

        valid = (pcs[:, 2] > 0.3) & (pce[:, 2] > 0.3) & in_img(uvs) & in_img(uve)
        return jnp.concatenate([mns, mne], axis=-1), valid

    line_obs, line_obs_valid = jax.vmap(line_obs_one_frame)(gt_p, gt_q)

    if pix_noise > 0:
        # noise in pixels → normalized via focal
        f = float(np.asarray(cam.fx))
        obs = obs + jnp.asarray(rng.standard_normal(obs.shape) * pix_noise / f, dtype)
        line_obs = line_obs + jnp.asarray(
            rng.standard_normal(line_obs.shape) * pix_noise / f, dtype
        )

    return SyntheticSequence(
        imu_t=jnp.asarray(imu_t, dtype),
        imu_acc=jnp.asarray(acc, dtype),
        imu_gyr=jnp.asarray(gyr, dtype),
        frame_t=fts,
        gt_p=gt_p,
        gt_q=gt_q,
        gt_v=gt_v,
        landmarks=lm,
        obs=obs,
        obs_valid=obs_valid,
        line_sp=sp3,
        line_ep=ep3,
        line_obs=line_obs,
        line_obs_valid=line_obs_valid,
        p_bc=jnp.asarray(p_bc, dtype),
        q_bc=jnp.asarray(q_bc, dtype),
        ba=jnp.asarray(ba, dtype),
        bg=jnp.asarray(bg, dtype),
    )


def imu_between(seq: SyntheticSequence, t0: float, t1: float):
    """Slice IMU samples covering [t0, t1] (boundary samples included), as the
    reference's `getMeasurements()` pairing did with interpolation — on a
    regular synthetic grid frame times coincide with IMU ticks, so this is a
    pure slice."""
    i0 = int(np.searchsorted(np.asarray(seq.imu_t), t0 - 1e-9))
    i1 = int(np.searchsorted(np.asarray(seq.imu_t), t1 - 1e-9))
    sl = slice(i0, i1 + 1)
    return seq.imu_acc[sl], seq.imu_gyr[sl], jnp.diff(seq.imu_t[sl])
