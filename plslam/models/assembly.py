"""Structured normal-equation assembly: per-factor local jacobians + block
scatter-add.

The generic path (`solver.linearize`) takes one `jacfwd` over the FULL
tangent (D ≈ 600 directional derivatives of the whole residual stack) — exact
but ~20× wasteful, since each residual touches ≤ 20 tangent dims. This module
assembles H = ΣJᵀJ, b = ΣJᵀr the way the reference's Ceres + 4-pthread
marginalization assembly did (SURVEY.md §2.3), batched:

  * per-factor-type vmapped `jacfwd` over the LOCAL parameter slice
    (IMU: 30 dims; point: 20; line: 16; relo: 20),
  * global column indices per slot precomputed as arrays, one
    `H.at[rows, cols].add` scatter per factor type (the pthread loop → one
    XLA scatter),
  * the dense prior contributes its closed-form J₀ᵀJ₀ / J₀ᵀr.

Produces bitwise-equivalent normal equations to the dense path (same
jacobians, different summation order) — pinned by tests — at a fraction of
the FLOPs; `solver.optimize_window(..., structured=True)` uses it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from plslam.models import residuals as res
from plslam.models.state import TangentLayout, WindowState, box_minus_cam, retract
from plslam.ops import imu as imu_ops
from plslam.ops.lines import line_projection_residual, orth_retract, plucker_transform
from plslam.utils.geometry import (
    pose_inverse,
    quat_box_plus,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_rot,
)


def _pose_dims(lay, k):
    return lay.off_pose + 6 * k + jnp.arange(6)


def assemble(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
             focal: float, pt_w, ln_w, relo_w, line_param: str = "world"):
    """Returns (H [D,D], b [D], cost) of the full weighted problem."""
    D = lay.dim
    dtype = state.p.dtype
    H = jnp.zeros((D, D), dtype)
    b = jnp.zeros((D,), dtype)
    cost = jnp.zeros((), dtype)

    # ---------------- prior (linear; closed form) ----------------
    dx = box_minus_cam(state, res._prior_state(f, state), lay)
    r_pr = (f.prior_r0 + f.prior_J @ dx) * f.prior_valid
    Jp = f.prior_J * f.prior_valid
    H = H.at[: lay.dim_cam, : lay.dim_cam].add(Jp.T @ Jp)
    b = b.at[: lay.dim_cam].add(Jp.T @ r_pr)
    cost += 0.5 * jnp.sum(r_pr * r_pr)

    # ---------------- IMU factors (local dim 30) ----------------
    W = lay.nw - 1

    def imu_local(k, d):
        # d: [30] = [pose_k(6), sb_k(9), pose_{k+1}(6), sb_{k+1}(9)]
        def upd(p, q, v, ba, bg, dp, dth, dsb):
            return (p + dp, quat_box_plus(q, dth), v + dsb[0:3], ba + dsb[3:6], bg + dsb[6:9])

        p_i, q_i, v_i, ba_i, bg_i = upd(
            state.p[k], state.q[k], state.v[k], state.ba[k], state.bg[k],
            d[0:3], d[3:6], d[6:15],
        )
        p_j, q_j, v_j, ba_j, bg_j = upd(
            state.p[k + 1], state.q[k + 1], state.v[k + 1], state.ba[k + 1], state.bg[k + 1],
            d[15:18], d[18:21], d[21:30],
        )
        pre = imu_ops.Preintegration(
            alpha=f.imu_alpha[k], beta=f.imu_beta[k], gamma=f.imu_gamma[k],
            jac=f.imu_jac[k], cov=jnp.zeros((15, 15), dtype),
            dt_sum=f.imu_dt[k], ba=f.imu_ba[k], bg=f.imu_bg[k],
        )
        r = imu_ops.imu_residual(p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, pre, f.g)
        return (f.imu_sqrt_info[k] @ r) * f.imu_valid[k]

    zero30 = jnp.zeros((30,), dtype)
    ks = jnp.arange(W)
    r_imu = jax.vmap(lambda k: imu_local(k, zero30))(ks)  # [W,15]
    J_imu = jax.vmap(lambda k: jax.jacfwd(lambda d: imu_local(k, d))(zero30))(ks)  # [W,15,30]
    idx_imu = jax.vmap(
        lambda k: jnp.concatenate([
            _pose_dims(lay, k), lay.off_sb + 9 * k + jnp.arange(9),
            _pose_dims(lay, k + 1), lay.off_sb + 9 * (k + 1) + jnp.arange(9),
        ])
    )(ks)  # [W,30]
    H = H.at[idx_imu[:, :, None], idx_imu[:, None, :]].add(
        jnp.einsum("wra,wrb->wab", J_imu, J_imu)
    )
    b = b.at[idx_imu].add(jnp.einsum("wra,wr->wa", J_imu, r_imu))
    cost += 0.5 * jnp.sum(r_imu * r_imu)

    # ---------------- point factors (local dim 20 per slot) ----------------
    NW, MF = lay.nw, lay.max_f
    start = f.pt_start
    NWr = jnp.arange(NW)[None, :]
    not_anchor = (NWr != start[:, None]).astype(dtype)
    base_mask = f.pt_mask * not_anchor * f.pt_valid[:, None]

    def pt_local(fi, j, d):
        # d: [20] = [pose_i(6), pose_j(6), ext(6), td(1), depth(1)]
        i = start[fi]
        p_i = state.p[i] + d[0:3]
        q_i = quat_box_plus(state.q[i], d[3:6])
        p_j = state.p[j] + d[6:9]
        q_j = quat_box_plus(state.q[j], d[9:12])
        p_bc = state.p_bc + d[12:15]
        q_bc = quat_box_plus(state.q_bc, d[15:18])
        td = state.td + d[18]
        lam = state.inv_depth[fi] + d[19]

        u_i = f.pt_obs[fi, i] - (td + f.rs_tr * f.pt_rowf[fi, i]) * f.pt_vel[fi, i]
        depth = 1.0 / jnp.where(jnp.abs(lam) > 1e-6, lam, 1e-6)
        p_ci = jnp.concatenate([u_i, jnp.ones(1, dtype)]) * depth
        p_w = quat_rotate(q_i, quat_rotate(q_bc, p_ci) + p_bc) + p_i
        p_cb, q_cb = pose_inverse(p_bc, q_bc)
        x_b = quat_rotate(quat_conj(q_j), p_w - p_j)
        x_c = quat_rotate(q_cb, x_b) + p_cb
        z = x_c[2]
        z_safe = jnp.where(jnp.abs(z) < 1e-5, jnp.sign(z) * 1e-5 + (z == 0) * 1e-5, z)
        pred = x_c[0:2] / z_safe
        u_j = f.pt_obs[fi, j] - (td + f.rs_tr * f.pt_rowf[fi, j]) * f.pt_vel[fi, j]
        m = base_mask[fi, j] * (z > 1e-3).astype(dtype)
        return (pred - u_j) * m * (focal / 1.5) * pt_w[fi, j]

    zero20 = jnp.zeros((20,), dtype)
    fis = jnp.arange(MF)
    js = jnp.arange(NW)

    def per_slot(fi, j):
        r = pt_local(fi, j, zero20)
        J = jax.jacfwd(lambda d: pt_local(fi, j, d))(zero20)
        return r, J

    r_pt, J_pt = jax.vmap(lambda fi: jax.vmap(lambda j: per_slot(fi, j))(js))(fis)
    # [MF,NW,2], [MF,NW,2,20]
    idx_pt = jax.vmap(
        lambda fi: jax.vmap(
            lambda j: jnp.concatenate([
                _pose_dims(lay, start[fi]), _pose_dims(lay, j),
                lay.off_ext + jnp.arange(6), jnp.asarray([lay.off_td]),
                jnp.asarray([lay.off_depth + fi]),
            ])
        )(js)
    )(fis)  # [MF,NW,20]
    H = H.at[idx_pt[:, :, :, None], idx_pt[:, :, None, :]].add(
        jnp.einsum("fjra,fjrb->fjab", J_pt, J_pt)
    )
    b = b.at[idx_pt].add(jnp.einsum("fjra,fjr->fja", J_pt, r_pt))
    cost += 0.5 * jnp.sum(r_pt * r_pt)

    # ---------------- line factors (local dim 16 / 22 per slot) ----------------
    # world parameterization: d = [pose_j(6), ext(6), line-orth(4)] (16).
    # anchored variants (`_incamera`/`_instartframe`): the line rides its
    # first-observing frame, so the anchor pose joins the local block:
    # d = [pose_i(6), pose_j(6), ext(6), line-orth(4)] (22).
    ML = lay.max_l
    anchored = line_param != "world"

    def ln_local(li, j, d):
        if anchored:
            i = f.ln_start[li]
            p_i = state.p[i] + d[0:3]
            q_i = quat_box_plus(state.q[i], d[3:6])
            d = d[6:]
        p_j = state.p[j] + d[0:3]
        q_j = quat_box_plus(state.q[j], d[3:6])
        p_bc = state.p_bc + d[6:9]
        q_bc = quat_box_plus(state.q_bc, d[9:12])
        L = orth_retract(state.line[li], d[12:16])
        if anchored:
            if line_param == "incamera":
                q_a = quat_mul(q_i, q_bc)
                p_a = p_i + quat_rotate(q_i, p_bc)
            else:  # instartframe
                q_a, p_a = q_i, p_i
            L = plucker_transform(L, quat_to_rot(q_a), p_a)
        q_wc = quat_mul(q_j, q_bc)
        p_wc = p_j + quat_rotate(q_j, p_bc)
        p_cw, q_cw = pose_inverse(p_wc, q_wc)
        L_c = plucker_transform(L, quat_to_rot(q_cw), p_cw)
        r = line_projection_residual(L_c, f.ln_obs[li, j, 0:2], f.ln_obs[li, j, 2:4])
        m = f.ln_mask[li, j] * f.ln_valid[li]
        return r * m * (focal / 1.5) * ln_w[li, j]

    ln_dim = 22 if anchored else 16
    zero_ln = jnp.zeros((ln_dim,), dtype)
    lis = jnp.arange(ML)

    def per_lslot(li, j):
        r = ln_local(li, j, zero_ln)
        J = jax.jacfwd(lambda d: ln_local(li, j, d))(zero_ln)
        return r, J

    r_ln, J_ln = jax.vmap(lambda li: jax.vmap(lambda j: per_lslot(li, j))(js))(lis)

    def ln_idx(li, j):
        tail = jnp.concatenate([
            _pose_dims(lay, j), lay.off_ext + jnp.arange(6),
            lay.off_line + 4 * li + jnp.arange(4),
        ])
        if anchored:
            return jnp.concatenate([_pose_dims(lay, f.ln_start[li]), tail])
        return tail

    idx_ln = jax.vmap(lambda li: jax.vmap(lambda j: ln_idx(li, j))(js))(lis)  # [ML,NW,16|22]
    H = H.at[idx_ln[:, :, :, None], idx_ln[:, :, None, :]].add(
        jnp.einsum("fjra,fjrb->fjab", J_ln, J_ln)
    )
    b = b.at[idx_ln].add(jnp.einsum("fjra,fjr->fja", J_ln, r_ln))
    cost += 0.5 * jnp.sum(r_ln * r_ln)

    # ---------------- relocalization factors (local dim 20) ----------------
    def relo_local(fi, d):
        # d: [20] = [pose_i(6), relo(6), ext(6), td(1), depth(1)]
        i = start[fi]
        p_i = state.p[i] + d[0:3]
        q_i = quat_box_plus(state.q[i], d[3:6])
        rp = state.relo_p + d[6:9]
        rq = quat_box_plus(state.relo_q, d[9:12])
        p_bc = state.p_bc + d[12:15]
        q_bc = quat_box_plus(state.q_bc, d[15:18])
        td = state.td + d[18]
        lam = state.inv_depth[fi] + d[19]
        u_i = f.pt_obs[fi, i] - (td + f.rs_tr * f.pt_rowf[fi, i]) * f.pt_vel[fi, i]
        depth = 1.0 / jnp.where(jnp.abs(lam) > 1e-6, lam, 1e-6)
        p_ci = jnp.concatenate([u_i, jnp.ones(1, dtype)]) * depth
        p_w = quat_rotate(q_i, quat_rotate(q_bc, p_ci) + p_bc) + p_i
        q_wc = quat_mul(rq, q_bc)
        p_wc = rp + quat_rotate(rq, p_bc)
        p_cw, q_cw = pose_inverse(p_wc, q_wc)
        x_c = quat_rotate(q_cw, p_w) + p_cw
        z = x_c[2]
        z_safe = jnp.where(jnp.abs(z) < 1e-5, jnp.sign(z) * 1e-5 + (z == 0) * 1e-5, z)
        pred = x_c[0:2] / z_safe
        m = f.relo_mask[fi] * f.pt_valid[fi] * f.relo_valid * (z > 1e-3).astype(dtype)
        return (pred - f.relo_obs[fi]) * m * (focal / 1.5) * relo_w[fi]

    zero20r = jnp.zeros((20,), dtype)
    r_re, J_re = jax.vmap(
        lambda fi: (relo_local(fi, zero20r), jax.jacfwd(lambda d: relo_local(fi, d))(zero20r))
    )(fis)  # [MF,2], [MF,2,20]
    idx_re = jax.vmap(
        lambda fi: jnp.concatenate([
            _pose_dims(lay, start[fi]), lay.off_relo + jnp.arange(6),
            lay.off_ext + jnp.arange(6), jnp.asarray([lay.off_td]),
            jnp.asarray([lay.off_depth + fi]),
        ])
    )(fis)
    H = H.at[idx_re[:, :, None], idx_re[:, None, :]].add(
        jnp.einsum("fra,frb->fab", J_re, J_re)
    )
    b = b.at[idx_re].add(jnp.einsum("fra,fr->fa", J_re, r_re))
    cost += 0.5 * jnp.sum(r_re * r_re)

    return H, b, cost
