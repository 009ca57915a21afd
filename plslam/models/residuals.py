"""Stacked whitened residuals for the sliding-window visual-inertial BA.

JAX equivalent of the reference's Ceres cost functions
(`factor/imu_factor.h`, `factor/projection_factor.cpp`,
`factor/projection_td_factor.cpp`, `factor/line_projection_factor.cpp`,
`factor/marginalization_factor.cpp::MarginalizationFactor` — SURVEY.md §2.3,
§A.2–A.5). Where Ceres evaluated one cost function per residual block on the
CPU, here *all* factors evaluate as one fused masked batch: every
(feature × frame) slot computes unconditionally and a 0/1 mask zeroes inactive
slots — fixed shapes, no recompilation.

Jacobians come from one `jax.jacfwd` of this stack through the manifold
retraction (replacing all hand-written analytic jacobians; unit tests pin the
values against finite differences).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from plslam.models.state import TangentLayout, WindowState, box_minus_cam, cam_poses
from plslam.ops import imu as imu_ops
from plslam.ops.lines import line_projection_residual, plucker_transform
from plslam.utils.geometry import pose_inverse, quat_mul, quat_rotate, quat_to_rot


class WindowFactors(NamedTuple):
    """All measurements bound to the current window (fixed shapes)."""

    # --- IMU preintegrations between consecutive frames (W = window_size) ---
    imu_alpha: jnp.ndarray  # [W,3]
    imu_beta: jnp.ndarray  # [W,3]
    imu_gamma: jnp.ndarray  # [W,4]
    imu_jac: jnp.ndarray  # [W,15,15]
    imu_sqrt_info: jnp.ndarray  # [W,15,15]
    imu_dt: jnp.ndarray  # [W]
    imu_ba: jnp.ndarray  # [W,3] linearization biases
    imu_bg: jnp.ndarray  # [W,3]
    imu_valid: jnp.ndarray  # [W] float 0/1
    g: jnp.ndarray  # [3] gravity (+z·9.81)
    # --- point features ---
    pt_obs: jnp.ndarray  # [MAX_F,NW,2] normalized coords
    pt_vel: jnp.ndarray  # [MAX_F,NW,2] normalized-coord velocity (for td)
    # td used by the IMU pairing when each frame was processed (the
    # reference ProjectionTdFactor's per-measurement td_i): the live loop
    # pairs IMU at t_img + td_live, so the factor must correct only the
    # REMAINING (td − td_i) — an absolute td·vel shift double-counts once
    # td moves and equilibrates at td_true/2 (measured: a 12 ms injected
    # latency crawled to ~4 ms with the absolute form)
    pt_td_ref: jnp.ndarray  # [NW]
    pt_rowf: jnp.ndarray  # [MAX_F,NW] image-row fraction (rolling shutter)
    rs_tr: jnp.ndarray  # [] rolling-shutter line-delay total (s); 0 = global shutter
    pt_mask: jnp.ndarray  # [MAX_F,NW] float 0/1 observed
    pt_start: jnp.ndarray  # [MAX_F] int32 first observing frame
    pt_valid: jnp.ndarray  # [MAX_F] float 0/1 active+triangulated
    # --- line features ---
    ln_obs: jnp.ndarray  # [MAX_L,NW,4] normalized (sx,sy,ex,ey)
    ln_mask: jnp.ndarray  # [MAX_L,NW] float 0/1
    ln_valid: jnp.ndarray  # [MAX_L] float 0/1
    ln_start: jnp.ndarray  # [MAX_L] int32 first observing frame (anchor for
    # the `_incamera`/`_instartframe` line-factor variants)
    # --- relocalization (`setReloFrame` match points against an old keyframe) ---
    relo_obs: jnp.ndarray  # [MAX_F,2] normalized obs of window features in the old kf
    relo_mask: jnp.ndarray  # [MAX_F] float 0/1 matched
    relo_valid: jnp.ndarray  # [] float 0/1
    # --- marginalization prior (camera-side dims DC) ---
    prior_J: jnp.ndarray  # [DC,DC]
    prior_r0: jnp.ndarray  # [DC]
    prior_valid: jnp.ndarray  # [] float 0/1
    prior_p: jnp.ndarray  # [NW,3] FEJ snapshot (camera-side state only)
    prior_q: jnp.ndarray  # [NW,4]
    prior_v: jnp.ndarray  # [NW,3]
    prior_ba: jnp.ndarray  # [NW,3]
    prior_bg: jnp.ndarray  # [NW,3]
    prior_p_bc: jnp.ndarray  # [3]
    prior_q_bc: jnp.ndarray  # [4]
    prior_td: jnp.ndarray  # []


def empty_factors(cfg, lay: TangentLayout, dtype=jnp.float32) -> WindowFactors:
    W, NW, MF, ML, DC = lay.nw - 1, lay.nw, lay.max_f, lay.max_l, lay.dim_cam
    q0 = jnp.zeros((NW, 4), dtype).at[:, 0].set(1.0)
    return WindowFactors(
        imu_alpha=jnp.zeros((W, 3), dtype),
        imu_beta=jnp.zeros((W, 3), dtype),
        imu_gamma=jnp.zeros((W, 4), dtype).at[:, 0].set(1.0),
        imu_jac=jnp.broadcast_to(jnp.eye(15, dtype=dtype), (W, 15, 15)),
        imu_sqrt_info=jnp.broadcast_to(jnp.eye(15, dtype=dtype), (W, 15, 15)),
        imu_dt=jnp.zeros((W,), dtype),
        imu_ba=jnp.zeros((W, 3), dtype),
        imu_bg=jnp.zeros((W, 3), dtype),
        imu_valid=jnp.zeros((W,), dtype),
        g=jnp.asarray([0.0, 0.0, 9.81007], dtype),
        pt_obs=jnp.zeros((MF, NW, 2), dtype),
        pt_vel=jnp.zeros((MF, NW, 2), dtype),
        pt_td_ref=jnp.zeros((NW,), dtype),
        pt_rowf=jnp.zeros((MF, NW), dtype),
        rs_tr=jnp.zeros((), dtype),
        pt_mask=jnp.zeros((MF, NW), dtype),
        pt_start=jnp.zeros((MF,), jnp.int32),
        pt_valid=jnp.zeros((MF,), dtype),
        ln_obs=jnp.zeros((ML, NW, 4), dtype),
        ln_mask=jnp.zeros((ML, NW), dtype),
        ln_valid=jnp.zeros((ML,), dtype),
        ln_start=jnp.zeros((ML,), jnp.int32),
        relo_obs=jnp.zeros((MF, 2), dtype),
        relo_mask=jnp.zeros((MF,), dtype),
        relo_valid=jnp.zeros((), dtype),
        prior_J=jnp.zeros((DC, DC), dtype),
        prior_r0=jnp.zeros((DC,), dtype),
        prior_valid=jnp.zeros((), dtype),
        prior_p=jnp.zeros((NW, 3), dtype),
        prior_q=q0,
        prior_v=jnp.zeros((NW, 3), dtype),
        prior_ba=jnp.zeros((NW, 3), dtype),
        prior_bg=jnp.zeros((NW, 3), dtype),
        prior_p_bc=jnp.zeros(3, dtype),
        prior_q_bc=jnp.asarray([1.0, 0, 0, 0], dtype),
        prior_td=jnp.zeros((), dtype),
    )


def _prior_state(f: WindowFactors, state: WindowState) -> WindowState:
    return state._replace(
        p=f.prior_p, q=f.prior_q, v=f.prior_v, ba=f.prior_ba, bg=f.prior_bg,
        p_bc=f.prior_p_bc, q_bc=f.prior_q_bc, td=f.prior_td,
    )


def imu_residuals(state: WindowState, f: WindowFactors) -> jnp.ndarray:
    """[W,15] whitened IMU residuals (`IMUFactor::Evaluate`)."""

    def one(k):
        pre = imu_ops.Preintegration(
            alpha=f.imu_alpha[k], beta=f.imu_beta[k], gamma=f.imu_gamma[k],
            jac=f.imu_jac[k], cov=jnp.zeros((15, 15), f.imu_jac.dtype),
            dt_sum=f.imu_dt[k], ba=f.imu_ba[k], bg=f.imu_bg[k],
        )
        r = imu_ops.imu_residual(
            state.p[k], state.q[k], state.v[k], state.ba[k], state.bg[k],
            state.p[k + 1], state.q[k + 1], state.v[k + 1], state.ba[k + 1], state.bg[k + 1],
            pre, f.g,
        )
        return (f.imu_sqrt_info[k] @ r) * f.imu_valid[k]

    return jax.vmap(one)(jnp.arange(f.imu_valid.shape[0]))


def _world_points(state: WindowState, f: WindowFactors) -> jnp.ndarray:
    """[MF,3] world positions of all point features (anchor frame + inverse
    depth — the shared front half of every projection factor)."""
    start = f.pt_start  # [MF]
    u_i = jnp.take_along_axis(f.pt_obs, start[:, None, None].astype(jnp.int32).repeat(2, -1), axis=1)[:, 0, :]  # [MF,2]
    v_i = jnp.take_along_axis(f.pt_vel, start[:, None, None].astype(jnp.int32).repeat(2, -1), axis=1)[:, 0, :]
    rowf_i = jnp.take_along_axis(f.pt_rowf, start[:, None].astype(jnp.int32), axis=1)[:, 0]
    # td + rolling-shutter row-delay shift of the anchor observation
    # (`ProjectionTdFactor`'s (td − td_i) + TR·row/ROW terms, SURVEY.md §A.3)
    td_ref_i = f.pt_td_ref[start]  # pairing-time td of the anchor frame
    u_i = u_i - (state.td - td_ref_i + f.rs_tr * rowf_i)[:, None] * v_i
    depth = 1.0 / jnp.where(jnp.abs(state.inv_depth) > 1e-6, state.inv_depth, 1e-6)  # [MF]
    p_ci = jnp.concatenate([u_i, jnp.ones_like(u_i[:, :1])], axis=-1) * depth[:, None]  # [MF,3]
    q_i = state.q[start]  # [MF,4]
    p_i = state.p[start]
    p_b = quat_rotate(jnp.broadcast_to(state.q_bc, q_i.shape), p_ci) + state.p_bc
    return quat_rotate(q_i, p_b) + p_i  # [MF,3]


def point_residuals(state: WindowState, f: WindowFactors, focal: float) -> jnp.ndarray:
    """[MAX_F,NW,2] whitened point reprojection residuals
    (`ProjectionFactor::Evaluate` / `ProjectionTdFactor`, SURVEY.md §A.3),
    all (feature, frame) slots in one batch.
    """
    NW = state.p.shape[0]
    dtype = state.p.dtype
    start = f.pt_start
    p_w = _world_points(state, f)  # [MF,3]

    # world→ every window camera
    p_cb, q_cb = pose_inverse(jnp.broadcast_to(state.p_bc, (NW, 3)), jnp.broadcast_to(state.q_bc, (NW, 4)))
    # x_cj = R_bc^T (R_wb_j^T (x_w − p_j) − p_bc)
    def to_cam_j(j):
        x_bj = quat_rotate(jnp.broadcast_to(state.q[j] * jnp.asarray([1, -1, -1, -1], dtype), (p_w.shape[0], 4)), p_w - state.p[j])
        return quat_rotate(jnp.broadcast_to(q_cb[j], (p_w.shape[0], 4)), x_bj) + p_cb[j]

    p_cj = jax.vmap(to_cam_j, out_axes=1)(jnp.arange(NW))  # [MF,NW,3]
    z = p_cj[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-5, jnp.sign(z) * 1e-5 + (z == 0) * 1e-5, z)
    pred = p_cj[..., 0:2] / z_safe  # [MF,NW,2]
    # (td − td_j) + RS shift: td_j = the td the IMU pairing used for frame j
    u_j = f.pt_obs - (state.td - f.pt_td_ref[None, :] + f.rs_tr * f.pt_rowf)[..., None] * f.pt_vel
    r = pred - u_j  # [MF,NW,2]

    # masking: observed, not the anchor frame itself, feature active
    NWr = jnp.arange(NW)[None, :]
    not_anchor = (NWr != start[:, None]).astype(dtype)
    m = f.pt_mask * not_anchor * f.pt_valid[:, None]
    # behind-camera guard: zero the residual instead of exploding
    m = m * (p_cj[..., 2] > 1e-3).astype(dtype)
    return r * m[..., None] * (focal / 1.5)


def lines_to_world(state: WindowState, ln_start: jnp.ndarray, line_param: str) -> jnp.ndarray:
    """[ML,6] world Plücker lines under any of the reference's three line
    parameterizations (`lineProjectionFactor` / `…_incamera` /
    `…_instartframe`): `state.line` is interpreted as world-frame, anchor
    -camera-frame, or anchor-body-frame Plücker respectively and transformed
    into the world with the CURRENT anchor pose — so with anchored variants
    the line moves rigidly with its first-observing frame and the factor
    jacobians couple the anchor pose exactly like the reference's variants."""
    if line_param == "world":
        return state.line
    q_a = state.q[ln_start]  # [ML,4] anchor body pose
    p_a = state.p[ln_start]
    if line_param == "incamera":
        q_a = quat_mul(q_a, jnp.broadcast_to(state.q_bc, q_a.shape))
        p_a = p_a + quat_rotate(state.q[ln_start], jnp.broadcast_to(state.p_bc, p_a.shape))
    elif line_param != "instartframe":
        raise ValueError(f"unknown line_param {line_param!r}")
    return plucker_transform(state.line, quat_to_rot(q_a), p_a)


def lines_from_world(state: WindowState, line_w: jnp.ndarray, ln_start: jnp.ndarray,
                     line_param: str) -> jnp.ndarray:
    """Inverse of `lines_to_world`: express world Plücker lines in the chart
    the chosen parameterization stores (used when (re)packing solver state)."""
    if line_param == "world":
        return line_w
    q_a = state.q[ln_start]
    p_a = state.p[ln_start]
    if line_param == "incamera":
        q_a = quat_mul(q_a, jnp.broadcast_to(state.q_bc, q_a.shape))
        p_a = p_a + quat_rotate(state.q[ln_start], jnp.broadcast_to(state.p_bc, p_a.shape))
    elif line_param != "instartframe":
        raise ValueError(f"unknown line_param {line_param!r}")
    p_aw, q_aw = pose_inverse(p_a, q_a)
    return plucker_transform(line_w, quat_to_rot(q_aw), p_aw)


def line_residuals(state: WindowState, f: WindowFactors, focal: float,
                   line_param: str = "world") -> jnp.ndarray:
    """[MAX_L,NW,2] whitened line residuals (`lineProjectionFactor::Evaluate`,
    SURVEY.md §A.4): Plücker (in the chart named by `line_param`) → world →
    camera frame per window pose, endpoint distances to the projected
    infinite line."""
    NW = state.p.shape[0]
    dtype = state.p.dtype
    p_wc, q_wc = cam_poses(state)  # [NW,3],[NW,4]
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    R_cw = quat_to_rot(q_cw)  # [NW,3,3]
    L_w = lines_to_world(state, f.ln_start, line_param)

    def per_frame(j):
        L_c = plucker_transform(L_w, R_cw[j], p_cw[j])  # [ML,6]
        return line_projection_residual(L_c, f.ln_obs[:, j, 0:2], f.ln_obs[:, j, 2:4])

    r = jax.vmap(per_frame, out_axes=1)(jnp.arange(NW))  # [ML,NW,2]
    m = f.ln_mask * f.ln_valid[:, None]
    return r * m[..., None] * (focal / 1.5)


def relo_residuals(state: WindowState, f: WindowFactors, focal: float) -> jnp.ndarray:
    """[MAX_F,2] whitened relocalization residuals: window feature world
    points projected into the relo (old-keyframe) camera vs their matched
    observations there (the relo `ProjectionFactor`s of
    `Estimator::optimization` — SURVEY.md §3.3/§3.4)."""
    dtype = state.p.dtype
    p_w = _world_points(state, f)  # [MF,3]
    # relo body pose → relo camera
    q_wc = quat_mul(state.relo_q, state.q_bc)
    p_wc = state.relo_p + quat_rotate(state.relo_q, state.p_bc)
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    x_c = quat_rotate(jnp.broadcast_to(q_cw, (p_w.shape[0], 4)), p_w) + p_cw
    z = x_c[:, 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-5, jnp.sign(z) * 1e-5 + (z == 0) * 1e-5, z)
    pred = x_c[:, 0:2] / z_safe
    r = pred - f.relo_obs
    m = f.relo_mask * f.pt_valid * f.relo_valid * (x_c[:, 2] > 1e-3).astype(dtype)
    return r * m[:, None] * (focal / 1.5)


def prior_residual(state: WindowState, f: WindowFactors, lay: TangentLayout) -> jnp.ndarray:
    """[DC] marginalization prior residual r₀ + J₀·(x ⊟ x₀)
    (`MarginalizationFactor::Evaluate`)."""
    dx = box_minus_cam(state, _prior_state(f, state), lay)
    return (f.prior_r0 + f.prior_J @ dx) * f.prior_valid


def residual_stack(
    state: WindowState,
    f: WindowFactors,
    lay: TangentLayout,
    focal: float,
    pt_w: jnp.ndarray | None = None,
    ln_w: jnp.ndarray | None = None,
    relo_w: jnp.ndarray | None = None,
    line_param: str = "world",
) -> jnp.ndarray:
    """Full whitened residual vector. `pt_w`/`ln_w`/`relo_w` are per
    -observation robust (IRLS √Cauchy) weights treated as constants during
    linearization — the JAX equivalent of Ceres' loss-function rescaling."""
    r_imu = imu_residuals(state, f).reshape(-1)
    r_pt = point_residuals(state, f, focal)
    if pt_w is not None:
        r_pt = r_pt * pt_w[..., None]
    r_ln = line_residuals(state, f, focal, line_param)
    if ln_w is not None:
        r_ln = r_ln * ln_w[..., None]
    r_relo = relo_residuals(state, f, focal)
    if relo_w is not None:
        r_relo = r_relo * relo_w[:, None]
    r_pr = prior_residual(state, f, lay)
    return jnp.concatenate([r_pr, r_imu, r_pt.reshape(-1), r_ln.reshape(-1), r_relo.reshape(-1)])


def cauchy_weights(r2, c: float):
    """√(ρ'(s)) for Cauchy loss ρ(s)=c²·log(1+s/c²), s = squared residual norm.

    Matches Ceres `CauchyLoss(c)` first-order IRLS rescaling."""
    return 1.0 / jnp.sqrt(1.0 + r2 / (c * c))


def residual_groups(state: WindowState, f: WindowFactors, lay: TangentLayout,
                    focal: float, line_param: str = "world"):
    """All residual groups at `state`, vision parts UNWEIGHTED:
    (r_prior [DC], r_imu [(NW−1)·15], r_pt [MF,NW,2], r_ln [ML,NW,2],
    r_relo [MF,2]). One evaluation serves three uses in the LM loop: IRLS
    weights, the weighted cost, and the next iteration's carry."""
    return (
        prior_residual(state, f, lay),
        imu_residuals(state, f).reshape(-1),
        point_residuals(state, f, focal),
        line_residuals(state, f, focal, line_param),
        relo_residuals(state, f, focal),
    )


def weights_of_groups(groups, cauchy_c: float):
    """IRLS √Cauchy weights from unweighted residual groups."""
    _, _, r_pt, r_ln, r_relo = groups
    pt_w = cauchy_weights(jnp.sum(r_pt * r_pt, axis=-1), cauchy_c)
    ln_w = cauchy_weights(jnp.sum(r_ln * r_ln, axis=-1), cauchy_c)
    relo_w = cauchy_weights(jnp.sum(r_relo * r_relo, axis=-1), cauchy_c)
    return pt_w, ln_w, relo_w


def robust_cost_of_groups(groups, cauchy_c: float):
    """The TRUE robust objective at `groups` (weight-free, comparable across
    iterations — unlike the IRLS-weighted squared cost, whose weights change
    every iteration): ½‖r_prior‖² + ½‖r_imu‖² + ½Σ ρ(‖r‖²) with Cauchy
    ρ(s) = c²·log(1+s/c²) on the vision terms — exactly Ceres' total cost."""
    r_pr, r_imu, r_pt, r_ln, r_relo = groups
    c2 = cauchy_c * cauchy_c
    rho = lambda r2: c2 * jnp.log1p(r2 / c2)
    return 0.5 * (
        jnp.sum(r_pr * r_pr) + jnp.sum(r_imu * r_imu)
        + jnp.sum(rho(jnp.sum(r_pt * r_pt, axis=-1)))
        + jnp.sum(rho(jnp.sum(r_ln * r_ln, axis=-1)))
        + jnp.sum(rho(jnp.sum(r_relo * r_relo, axis=-1)))
    )


def stack_of_groups(groups, pt_w, ln_w, relo_w):
    """Weighted residual stack from unweighted groups (same layout as
    `residual_stack`)."""
    r_pr, r_imu, r_pt, r_ln, r_relo = groups
    return jnp.concatenate([
        r_pr, r_imu,
        (r_pt * pt_w[..., None]).reshape(-1),
        (r_ln * ln_w[..., None]).reshape(-1),
        (r_relo * relo_w[:, None]).reshape(-1),
    ])


def robust_weights(state: WindowState, f: WindowFactors, focal: float, cauchy_c: float,
                   line_param: str = "world"):
    """Per-observation IRLS weights from the current (unweighted) residuals."""
    r_pt = point_residuals(state, f, focal)
    r_ln = line_residuals(state, f, focal, line_param)
    r_relo = relo_residuals(state, f, focal)
    pt_w = cauchy_weights(jnp.sum(r_pt * r_pt, axis=-1), cauchy_c)
    ln_w = cauchy_weights(jnp.sum(r_ln * r_ln, axis=-1), cauchy_c)
    relo_w = cauchy_weights(jnp.sum(r_relo * r_relo, axis=-1), cauchy_c)
    return pt_w, ln_w, relo_w
