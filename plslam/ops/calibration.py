"""Offline intrinsic calibration from planar-target views.

JAX equivalent of the reference's `camera_model/src/intrinsic_calib.cc`
+ `calib/CameraCalibration.cc` (chessboard-based camodocal calibrator —
SURVEY.md §2.5). Given detected target-corner pixels for N views of a planar
grid (the chessboard detector's output), estimates pinhole+radtan intrinsics:

  1. Zhang-style closed-form init: per-view homographies (DLT) → the image of
     the absolute conic → (fx, fy, cx, cy); distortion starts at 0,
  2. per-view pose extraction from the homographies,
  3. joint batched GN over [intrinsics(8) | poses(6N)] with `jacfwd` through
     the full projection chain — the Ceres refinement step, batched (all
     views × corners evaluate as one fused batch).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.ops.cameras import PinholeRadTan, project
from plslam.utils.geometry import quat_box_plus, quat_rotate, rot_to_quat


def _homography_dlt(obj_xy, img_uv):
    """Planar DLT homography (normalized)."""
    n = len(obj_xy)
    A = []
    for k in range(n):
        X, Y = obj_xy[k]
        u, v = img_uv[k]
        A.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        A.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _zhang_init(Hs):
    """Closed-form intrinsics from ≥3 homographies (Zhang 2000)."""

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return fx, fy, cx, cy


def _pose_from_homography(H, K):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * Kinv @ h1
    r2 = lam * Kinv @ h2
    t = lam * Kinv @ h3
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:  # target must be in front
        R[:, 0:2] *= -1
        t = -t
    return R, t


def calibrate_pinhole_radtan(obj_xy, img_uv_views, iters=20):
    """Calibrate from N views: obj_xy [M,2] planar target points (z=0, e.g.
    chessboard corners × square size), img_uv_views [N,M,2] detections.

    Returns (PinholeRadTan (float64), rms reprojection error px)."""
    N = len(img_uv_views)
    Hs = [_homography_dlt(obj_xy, img_uv_views[k]) for k in range(N)]
    fx, fy, cx, cy = _zhang_init(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    poses = [_pose_from_homography(H, K) for H in Hs]

    obj3 = jnp.asarray(np.concatenate([obj_xy, np.zeros((len(obj_xy), 1))], axis=1))
    uv = jnp.asarray(np.asarray(img_uv_views))  # [N,M,2]
    q0 = jnp.asarray(np.stack([np.asarray(rot_to_quat(jnp.asarray(R))) for R, _ in poses]))
    t0 = jnp.asarray(np.stack([t for _, t in poses]))
    intr0 = jnp.asarray([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0])

    def residual(intr, qs, ts):
        cam = PinholeRadTan(*[intr[i] for i in range(8)])

        def per_view(q, t):
            p_c = quat_rotate(jnp.broadcast_to(q, (obj3.shape[0], 4)), obj3) + t
            return project(cam, p_c)

        pred = jax.vmap(per_view)(qs, ts)  # [N,M,2]
        return (pred - uv).reshape(-1)

    @jax.jit
    def gn_step(intr, qs, ts, lam):
        def r_of(d):
            di = d[0:8]
            dq = d[8 : 8 + 3 * N].reshape(N, 3)
            dt = d[8 + 3 * N :].reshape(N, 3)
            return residual(intr + di, quat_box_plus(qs, dq), ts + dt)

        D = 8 + 6 * N
        zero = jnp.zeros((D,))
        r0 = r_of(zero)
        J = jax.jacfwd(r_of)(zero)
        H = J.T @ J
        b = J.T @ r0
        dH = jnp.diag(H)
        sc = 1.0 / jnp.sqrt(jnp.maximum(dH, 1e-9))
        Hs_ = H * sc[:, None] * sc[None, :] + lam * jnp.eye(D)
        d = -(jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hs_), b * sc)) * sc
        intr2 = intr + d[0:8]
        qs2 = quat_box_plus(qs, d[8 : 8 + 3 * N].reshape(N, 3))
        ts2 = ts + d[8 + 3 * N :].reshape(N, 3)
        c0 = 0.5 * jnp.sum(r0 * r0)
        r1 = residual(intr2, qs2, ts2)
        c1 = 0.5 * jnp.sum(r1 * r1)
        accept = c1 < c0
        pick = lambda a, bb: jnp.where(accept, a, bb)
        return (pick(intr2, intr), jax.tree.map(pick, qs2, qs), pick(ts2, ts),
                jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10), jnp.minimum(lam * 8, 1e3)),
                jnp.where(accept, c1, c0))

    intr, qs, ts, lam = intr0, q0, t0, jnp.asarray(1e-3)
    cost = jnp.inf
    for _ in range(iters):
        intr, qs, ts, lam, cost = gn_step(intr, qs, ts, lam)
    n_res = N * len(obj_xy)
    rms = float(jnp.sqrt(2.0 * cost / n_res))
    cam = PinholeRadTan(*[intr[i] for i in range(8)])
    return cam, rms
