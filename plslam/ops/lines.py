"""Plücker line geometry: orthonormal parameterisation, frame transforms,
two-plane triangulation, point-line residual helpers.

JAX equivalent of the reference's
`vins_estimator/src/utility/line_geometry.cpp` (`plk_to_orth`, `orth_to_plk`,
`plk_to_pose`, `plk_from_pose`, `pipi_plk` — SURVEY.md §2.3 / §A.4;
reconstruction, reference mount empty).

Representation
--------------
* Plücker line ``L = (n, v)`` stacked as a 6-vector ``[n; v]``: ``v`` the
  direction, ``n = p × v`` the moment for any point ``p`` on the line.
  4 DoF up to scale.
* Orthonormal 4-param ``o = [psi(3); phi]``: ``U = U0 · Exp(psi) ∈ SO(3)``
  holding the normalized ``(n, v, n×v)`` frame and
  ``W = [cosφ, -sinφ; sinφ, cosφ]`` with ``(cosφ, sinφ) ∝ (‖n‖, ‖v‖)``.
  Here we store lines directly in (minimal-update) Plücker form and expose
  the ⊞ retraction `orth_retract` used by the solver, matching the
  reference's `LineOrthParameterization::Plus`.

All functions vectorised over leading axes.
"""
from __future__ import annotations

import jax.numpy as jnp

from plslam.utils.geometry import skew, so3_exp


def plucker_from_points(p1, p2):
    """Line through 3D points p1, p2: v = p2-p1, n = p1 × p2 (= p1 × v)."""
    v = p2 - p1
    n = jnp.cross(p1, p2)
    return jnp.concatenate([n, v], axis=-1)


def plucker_split(L):
    return L[..., 0:3], L[..., 3:6]


def plucker_frame(L):
    """Orthonormal frame U = [n̂, v̂, n̂×v̂] and magnitudes (‖n‖, ‖v‖)."""
    n, v = plucker_split(L)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    nv = jnp.linalg.norm(v, axis=-1, keepdims=True)
    n_hat = n / jnp.maximum(nn, 1e-12)
    v_hat = v / jnp.maximum(nv, 1e-12)
    u3 = jnp.cross(n_hat, v_hat)
    U = jnp.stack([n_hat, v_hat, u3], axis=-1)  # columns
    return U, nn[..., 0], nv[..., 0]


def plucker_to_orth(L):
    """Plücker -> (U as rotation-vector? no: return (U, phi)) — we return the
    4-vector [theta(3); phi] relative to identity is not unique, so instead the
    solver stores Plücker and uses `orth_retract`. This helper returns
    (U, w1, w2) with w = (cosφ, sinφ), ‖w‖=1 (the reference's `plk_to_orth`
    up to the chart choice)."""
    U, nn, nv = plucker_frame(L)
    d = jnp.sqrt(nn * nn + nv * nv)
    w1 = nn / jnp.maximum(d, 1e-12)
    w2 = nv / jnp.maximum(d, 1e-12)
    return U, w1, w2


def orth_to_plucker(U, w1, w2):
    """(U, cosφ, sinφ) -> unit-scale Plücker [w1·u1; w2·u2] (`orth_to_plk`)."""
    n = w1[..., None] * U[..., :, 0]
    v = w2[..., None] * U[..., :, 1]
    return jnp.concatenate([n, v], axis=-1)


def orth_retract(L, delta):
    """⊞ on the 4-DoF orthonormal chart, applied to a Plücker 6-vector.

    delta[...,0:3] rotates U on the right by Exp(δ₁..₃); delta[...,3] rotates
    the (‖n‖,‖v‖) 2-vector W by δ₄ (`LineOrthParameterization::Plus`).
    Returns a Plücker 6-vector with the same overall scale d = √(‖n‖²+‖v‖²).
    """
    U, w1, w2 = plucker_to_orth(L)
    n, v = plucker_split(L)
    d = jnp.sqrt(jnp.sum(n * n, axis=-1) + jnp.sum(v * v, axis=-1))
    dR = so3_exp(delta[..., 0:3])
    U_new = U @ dR
    c, s = jnp.cos(delta[..., 3]), jnp.sin(delta[..., 3])
    w1_new = c * w1 - s * w2
    w2_new = s * w1 + c * w2
    return d[..., None] * orth_to_plucker(U_new, w1_new, w2_new)


def plucker_transform(L, R, t):
    """Transform a Plücker line between frames: x_dst = R x_src + t.

    n' = R n + [t]× R v ;  v' = R v   (`plk_to_pose` with (R,t) = dst_T_src).
    """
    n, v = plucker_split(L)
    Rv = jnp.einsum("...ij,...j->...i", R, v)
    Rn = jnp.einsum("...ij,...j->...i", R, n)
    n_new = Rn + jnp.einsum("...ij,...j->...i", skew(t), Rv)
    return jnp.concatenate([n_new, Rv], axis=-1)


def plane_from_cam_segment(R_wc, p_wc, s_n, e_n):
    """Plane through camera center and observed segment (normalized coords).

    s_n, e_n: segment endpoints on the normalized image plane [...,2].
    Returns homogeneous plane [..., 4] in world frame (`plane_from_pose_and_segment`).
    """
    s_c = jnp.concatenate([s_n, jnp.ones_like(s_n[..., :1])], axis=-1)
    e_c = jnp.concatenate([e_n, jnp.ones_like(e_n[..., :1])], axis=-1)
    s_w = jnp.einsum("...ij,...j->...i", R_wc, s_c) + p_wc
    e_w = jnp.einsum("...ij,...j->...i", R_wc, e_c) + p_wc
    nrm = jnp.cross(s_w - p_wc, e_w - p_wc)
    d = -jnp.sum(nrm * p_wc, axis=-1, keepdims=True)
    return jnp.concatenate([nrm, d], axis=-1)


def plucker_from_planes(pi1, pi2):
    """Two planes -> Plücker line via the dual matrix L* = π₁π₂ᵀ − π₂π₁ᵀ
    (`pipi_plk`): with L* = [[ [v]× , n], [-nᵀ, 0]], read n = L*[0:3,3],
    v = vee(L*[0:3,0:3])."""
    Ls = pi1[..., :, None] * pi2[..., None, :] - pi2[..., :, None] * pi1[..., None, :]
    n = Ls[..., 0:3, 3]
    v = jnp.stack([Ls[..., 2, 1], Ls[..., 0, 2], Ls[..., 1, 0]], axis=-1)
    return jnp.concatenate([n, v], axis=-1)


def line_projection_residual(L_c, s_n, e_n):
    """Reference line residual (§A.4): project camera-frame Plücker to the
    normalized plane as the infinite line l = n_c; residual = signed distances
    of the two observed endpoints, each / √(l₁²+l₂²)
    (`lineProjectionFactor::Evaluate`)."""
    l = L_c[..., 0:3]  # n_c is the normalized-plane line
    denom = jnp.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    denom = jnp.maximum(denom, 1e-12)
    s_h = jnp.concatenate([s_n, jnp.ones_like(s_n[..., :1])], axis=-1)
    e_h = jnp.concatenate([e_n, jnp.ones_like(e_n[..., :1])], axis=-1)
    rs = jnp.sum(s_h * l, axis=-1) / denom
    re = jnp.sum(e_h * l, axis=-1) / denom
    return jnp.stack([rs, re], axis=-1)


def closest_point_on_line(L, p):
    """Closest point on line (n,v) to point p (for viz / gating)."""
    n, v = plucker_split(L)
    v2 = jnp.sum(v * v, axis=-1, keepdims=True)
    p0 = jnp.cross(v, n) / jnp.maximum(v2, 1e-12)  # point on line closest to origin
    t = jnp.sum((p - p0) * v, axis=-1, keepdims=True) / jnp.maximum(v2, 1e-12)
    return p0 + t * v


def trim_line_to_segment(L, s_w_dir, e_w_dir):
    """Given an infinite line and two viewing rays, return 3D endpoints by
    orthogonal projection of ray-line closest points (viz helper)."""
    return closest_point_on_line(L, s_w_dir), closest_point_on_line(L, e_w_dir)
