"""Batched masked triangulation for points (DLT) and lines (two-plane).

JAX equivalent of `FeatureManager::triangulate()` (per-feature SVD
over all observations) and `FeatureManager::triangulateLine()` (plane-plane
→ dual Plücker matrix) — SURVEY.md §2.3 / §A.4. The reference looped per
feature; here every feature triangulates in one batched SVD / einsum over the
fixed table, with masks deciding which results are committed.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from plslam.ops.lines import plane_from_cam_segment, plucker_from_planes
from plslam.utils.geometry import pose_inverse, quat_to_rot
from plslam.utils.device import highest_matmul_precision


@jax.jit
@highest_matmul_precision
def triangulate_points(p_wc, q_wc, obs, mask, start):
    """DLT triangulation of every feature slot.

    Args:
      p_wc, q_wc: [NW,3]/[NW,4] world_T_cam poses.
      obs: [MF,NW,2] normalized observations; mask: [MF,NW] 0/1; start: [MF].
    Returns:
      inv_depth [MF] in the anchor (start) camera, ok [MF] bool
      (z in anchor > 0.1 and ≥2 observations).
    """
    NW = p_wc.shape[0]
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    R_cw = quat_to_rot(q_cw)  # [NW,3,3]
    # projection rows: x_c = R_cw x_w + p_cw ; normalized obs (u,v):
    #   u·(r3ᵀx + t3) − (r1ᵀx + t1) = 0 ;  v·(r3ᵀx + t3) − (r2ᵀx + t2) = 0
    P = jnp.concatenate([R_cw, p_cw[:, :, None]], axis=-1)  # [NW,3,4]

    u = obs[..., 0][..., None]  # [MF,NW,1]
    v = obs[..., 1][..., None]
    row_u = u * P[None, :, 2, :] - P[None, :, 0, :]  # [MF,NW,4]
    row_v = v * P[None, :, 2, :] - P[None, :, 1, :]
    A = jnp.concatenate([row_u, row_v], axis=1) * jnp.concatenate([mask, mask], axis=1)[..., None]
    # [MF, 2NW, 4]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    X = Vt[:, -1, :]  # [MF,4] homogeneous world point
    w = X[:, 3]
    w_safe = jnp.where(jnp.abs(w) > 1e-10, w, 1e-10)
    xw = X[:, 0:3] / w_safe[:, None]

    # depth in anchor camera
    Ra = R_cw[start]  # [MF,3,3]
    ta = p_cw[start]
    z = jnp.einsum("mi,mi->m", Ra[:, 2, :], xw) + ta[:, 2]
    nobs = jnp.sum(mask, axis=1)
    ok = (z > 0.1) & (nobs >= 2)
    inv_depth = jnp.where(ok, 1.0 / jnp.maximum(z, 0.1), 1.0 / 5.0)  # INIT_DEPTH=5 fallback
    return inv_depth, ok


@jax.jit
@highest_matmul_precision
def triangulate_lines(p_wc, q_wc, obs, mask, start):
    """Two-plane triangulation of every line slot (SURVEY.md §A.4).

    Partner frame = observing frame whose camera center is farthest from the
    anchor's (max baseline). Gate: plane angle > ~2°, endpoints in front.

    Returns: line_w [ML,6] world Plücker, ok [ML] bool.
    """
    R_wc = quat_to_rot(q_wc)  # [NW,3,3]

    # anchor per line
    Ra = R_wc[start]  # [ML,3,3]
    pa = p_wc[start]
    sa = jnp.take_along_axis(obs, start[:, None, None].repeat(4, -1), axis=1)[:, 0, :]  # [ML,4]

    # partner: farthest camera center among observed frames (excluding anchor)
    base = jnp.linalg.norm(p_wc[None, :, :] - pa[:, None, :], axis=-1)  # [ML,NW]
    ml = obs.shape[0]
    NW = p_wc.shape[0]
    is_anchor = jnp.arange(NW)[None, :] == start[:, None]
    score = jnp.where((mask > 0) & ~is_anchor, base, -1.0)
    partner = jnp.argmax(score, axis=1)  # [ML]
    has_partner = jnp.max(score, axis=1) > 0.02  # ≥2 cm baseline

    Rp = R_wc[partner]
    pp = p_wc[partner]
    sp = jnp.take_along_axis(obs, partner[:, None, None].repeat(4, -1), axis=1)[:, 0, :]

    pi1 = plane_from_cam_segment(Ra, pa, sa[:, 0:2], sa[:, 2:4])
    pi2 = plane_from_cam_segment(Rp, pp, sp[:, 0:2], sp[:, 2:4])
    L = plucker_from_planes(pi1, pi2)

    # gating: angle between planes
    n1 = pi1[:, 0:3] / jnp.maximum(jnp.linalg.norm(pi1[:, 0:3], axis=-1, keepdims=True), 1e-12)
    n2 = pi2[:, 0:3] / jnp.maximum(jnp.linalg.norm(pi2[:, 0:3], axis=-1, keepdims=True), 1e-12)
    cosang = jnp.abs(jnp.sum(n1 * n2, axis=-1))
    angle_ok = cosang < jnp.cos(jnp.deg2rad(2.0))

    # line direction must be well-defined
    v_norm = jnp.linalg.norm(L[:, 3:6], axis=-1)
    ok = has_partner & angle_ok & (v_norm > 1e-6)
    # normalize scale: ‖v‖ = 1 keeps the orth chart well-conditioned
    Ln = L / jnp.maximum(v_norm[:, None], 1e-9)
    return Ln, ok
