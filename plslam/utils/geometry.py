"""Rotation / quaternion utilities (pure jnp, batch-friendly on leading axes).

JAX equivalent of the reference's rotation helpers
(`vins_estimator/src/utility/utility.h`: `Utility::deltaQ`, `skewSymmetric`,
`R2ypr`, `ypr2R`, `g2R` — SURVEY.md §2.3, reconstruction; the reference mount
was empty, see SURVEY.md §0).

Conventions
-----------
* Quaternions are Hamilton, stored ``[w, x, y, z]``, unit norm.
* ``quat_to_rot(q) @ v`` rotates a vector from the frame the quaternion
  *represents* into the parent frame (i.e. ``R_wb = quat_to_rot(q_wb)``).
* Small-angle box-plus: ``q ⊞ dθ = q ⊗ exp([0, dθ/2])`` (right perturbation,
  matching the reference's ``PoseLocalParameterization::Plus``).
* Angles in radians everywhere (the reference used degrees for ypr; we convert
  at the config/IO boundary only).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix. Batched over leading axes."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2 ([w,x,y,z])."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q: R(q) v."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.stack(
        [
            jnp.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], axis=-1),
        ],
        axis=-2,
    )


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z], branchless (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    q0 = jnp.stack([t0, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    q1 = jnp.stack([m21 - m12, t1, m01 + m10, m02 + m20], axis=-1)
    q2 = jnp.stack([m02 - m20, m01 + m10, t2, m12 + m21], axis=-1)
    q3 = jnp.stack([m10 - m01, m02 + m20, m12 + m21, t3], axis=-1)
    ts = jnp.stack([t0, t1, t2, t3], axis=-1)
    idx = jnp.argmax(ts, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)
    q = jnp.take_along_axis(qs, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_exp(dtheta):
    """exp map R^3 -> quaternion: rotation of angle |dθ| about dθ/|dθ|.

    AD-safe at dθ=0: the norm is never sqrt'ed at zero (the sqrt argument is
    sanitised *before* the sqrt so forward-mode tangents stay finite — this
    function sits at the linearisation point of every jacfwd in the solver).
    """
    half = 0.5 * dtheta
    a2 = jnp.sum(half * half, axis=-1, keepdims=True)
    small = a2 < jnp.asarray(_EPS * _EPS, half.dtype)
    a = jnp.sqrt(jnp.where(small, jnp.ones_like(a2), a2))
    s = jnp.where(small, 1.0 - a2 / 6.0, jnp.sin(a) / a)
    w = jnp.where(small, 1.0 - a2 / 2.0, jnp.cos(a))
    return jnp.concatenate([w, s * half], axis=-1)


def quat_log(q):
    """log map: quaternion -> R^3 rotation vector (angle*axis). AD-safe at
    identity (see quat_exp)."""
    q = q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    qv = q[..., 1:4]
    n2 = jnp.sum(qv * qv, axis=-1, keepdims=True)
    small = n2 < jnp.asarray(_EPS * _EPS, q.dtype)
    n = jnp.sqrt(jnp.where(small, jnp.ones_like(n2), n2))
    angle = 2.0 * jnp.arctan2(n, w)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / n)
    return scale * qv


def quat_box_plus(q, dtheta):
    """q ⊞ dθ = q ⊗ exp(dθ) — right (body-frame) perturbation."""
    return quat_normalize(quat_mul(q, quat_exp(dtheta)))


def quat_box_minus(q2, q1):
    """q2 ⊟ q1 = 2·vec(q1⁻¹ ⊗ q2), the reference's quaternion residual
    (`imu_factor.h` rotation residual; `marginalization_factor.cpp` box-minus)."""
    dq = quat_mul(quat_conj(q1), q2)
    dq = dq * jnp.where(dq[..., 0:1] < 0, -1.0, 1.0)
    return 2.0 * dq[..., 1:4]


def so3_exp(dtheta):
    return quat_to_rot(quat_exp(dtheta))


def so3_log(R):
    return quat_log(rot_to_quat(R))


def ypr_to_rot(ypr):
    """[yaw, pitch, roll] (radians) -> R = Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rot_to_ypr(R):
    """R -> [yaw, pitch, roll] radians (`Utility::R2ypr`, but radians)."""
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = jnp.arctan2(-R[..., 2, 0], jnp.hypot(R[..., 2, 1], R[..., 2, 2]))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return jnp.stack([yaw, pitch, roll], axis=-1)


def rot_from_two_vectors(a, b):
    """Rotation taking direction a to direction b (Eigen FromTwoVectors)."""
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    c = jnp.cross(a, b)
    d = jnp.sum(a * b, axis=-1, keepdims=True)
    # Rodrigues with angle from atan2 (stable near 0 and pi)
    s = jnp.linalg.norm(c, axis=-1, keepdims=True)
    angle = jnp.arctan2(s, d)
    axis = jnp.where(
        s > _EPS,
        c / jnp.where(s > _EPS, s, 1.0),
        # near-parallel / antiparallel: pick any axis orthogonal to a
        _any_orthogonal(a),
    )
    return so3_exp(axis * angle)


def _any_orthogonal(a):
    h = jnp.where(
        jnp.abs(a[..., 0:1]) < 0.9,
        jnp.asarray([1.0, 0.0, 0.0], a.dtype) * jnp.ones_like(a),
        jnp.asarray([0.0, 1.0, 0.0], a.dtype) * jnp.ones_like(a),
    )
    o = jnp.cross(a, h)
    return o / jnp.linalg.norm(o, axis=-1, keepdims=True)


def gravity_to_rot(g):
    """`Utility::g2R`: rotation R0 s.t. R0 @ ĝ = [0,0,1] with yaw(R0)=0."""
    ez = jnp.asarray([0.0, 0.0, 1.0], g.dtype)
    R0 = rot_from_two_vectors(g, ez)
    yaw = rot_to_ypr(R0)[..., 0]
    Ry = ypr_to_rot(jnp.stack([-yaw, jnp.zeros_like(yaw), jnp.zeros_like(yaw)], axis=-1))
    return Ry @ R0


def pose_inverse(p, q):
    """Invert transform x_b = R(q) x_a + p  ->  (p', q') with x_a = R(q') x_b + p'."""
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi
