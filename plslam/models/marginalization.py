"""Schur-complement marginalization with First-Estimate-Jacobian prior.

JAX equivalent of the reference's
`vins_estimator/src/factor/marginalization_factor.cpp/.h`
(`MarginalizationInfo::preMarginalize/marginalize`, `MarginalizationFactor`)
— SURVEY.md §2.3 / §A.5. The reference assembled H = ΣJᵀJ on 4 pthreads,
Schur-complemented the drop block with an eigen-decomposition pseudo-inverse,
and re-factored into a linear prior (J₀, r₀, x₀). Here:

  * assembly is one `jacfwd` + matmul over the marginal factor subset
    (factors touching frame 0: the previous prior, IMU 0→1, and all point/line
    factors of features first observed in frame 0),
  * the landmark block is eliminated blockwise (scalar depths, 4×4 lines) with
    per-block pseudo-inverses,
  * the frame-0 pose+speedbias block (15 dims) is eliminated with an `eigh`
    pseudo-inverse (eigenvalue floor `eig_eps`, as the reference),
  * the kept system is re-factored H' = (√Λ Vᵀ)ᵀ(√Λ Vᵀ) → J₀ = √Λ Vᵀ,
    r₀ = Λ^{-1/2} Vᵀ b', and finally re-indexed by the window shift so the
    prior lines up with the slid state arrays.

x₀ (the FEJ linearisation point) is the pre-slide state, shifted the same way.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models.state import TangentLayout, WindowState
from plslam.utils.device import highest_matmul_precision


class Prior(NamedTuple):
    J: jnp.ndarray  # [DC,DC]
    r0: jnp.ndarray  # [DC]
    valid: jnp.ndarray  # [] 0/1
    # snapshot (camera-side FEJ point)
    p: jnp.ndarray
    q: jnp.ndarray
    v: jnp.ndarray
    ba: jnp.ndarray
    bg: jnp.ndarray
    p_bc: jnp.ndarray
    q_bc: jnp.ndarray
    td: jnp.ndarray


def _drop0_indices(lay: TangentLayout):
    drop = np.concatenate([np.arange(0, 6), np.arange(lay.off_sb, lay.off_sb + 9)])
    keep = np.setdiff1d(np.arange(lay.dim_cam), drop)
    return jnp.asarray(drop), jnp.asarray(keep)


def _shift_perm(lay: TangentLayout):
    """new-dim -> old-dim gather map implementing the window shift
    (frames 1..NW-1 → 0..NW-2; new last frame maps to the zeroed frame-0 slots)."""
    nw = lay.nw
    perm = np.arange(lay.dim_cam)
    pose = perm[lay.off_pose : lay.off_sb].reshape(nw, 6)
    perm[lay.off_pose : lay.off_sb] = np.concatenate([pose[1:], pose[:1]]).reshape(-1)
    sb = np.arange(lay.off_sb, lay.off_ext).reshape(nw, 9)
    perm[lay.off_sb : lay.off_ext] = np.concatenate([sb[1:], sb[:1]]).reshape(-1)
    return jnp.asarray(perm)


def _pinv_psd(M, eps):
    w, V = jnp.linalg.eigh(0.5 * (M + M.T))
    w_inv = jnp.where(w > eps, 1.0 / jnp.maximum(w, eps), 0.0)
    return (V * w_inv[None, :]) @ V.T


def _sqrt_refactor(H, b, eps):
    w, V = jnp.linalg.eigh(0.5 * (H + H.T))
    ok = w > eps
    s = jnp.where(ok, jnp.sqrt(jnp.maximum(w, eps)), 0.0)
    s_inv = jnp.where(ok, 1.0 / jnp.maximum(s, jnp.sqrt(eps)), 0.0)
    J0 = s[:, None] * V.T
    r0 = s_inv * (V.T @ b)
    return J0, r0


def _marg_factor_subset(f: res.WindowFactors) -> res.WindowFactors:
    """Only the factors entering MARGIN_OLD (SURVEY.md §3.3): previous prior
    + IMU(0→1) + all factors of features/lines seen in frame 0."""
    return f._replace(
        imu_valid=f.imu_valid
        * jnp.where(jnp.arange(f.imu_valid.shape[0]) == 0, 1.0, 0.0).astype(f.imu_valid.dtype),
        pt_valid=f.pt_valid * (f.pt_start == 0).astype(f.pt_valid.dtype),
        ln_valid=f.ln_valid * f.ln_mask[:, 0],
        relo_valid=jnp.zeros((), f.pt_valid.dtype),  # relo factors never marginalize
    )


@partial(jax.jit, static_argnames=("lay", "cfg"))
@highest_matmul_precision
def marginalize_old(
    state: WindowState, f: res.WindowFactors, lay: TangentLayout, cfg: SolverConfig,
    groups: Optional[tuple] = None,
) -> Prior:
    """MARGIN_OLD: absorb frame 0 (pose+speedbias) and its landmarks into a
    new linear prior, already re-indexed for the subsequent window shift.

    `groups`: optional unweighted residual groups at `state`
    (`SolveStats.groups` from the solve that produced it) — reuses that
    evaluation for the IRLS weights instead of re-running the residual stack
    (the vision residuals are gauge-invariant, so the solver's pre-reanchor
    carry is exact here; for anchored line charts the estimator round-trips
    lines through world coordinates between solve and marginalization, so the
    reused groups match only to f32 round-trip noise there — harmless, they
    feed IRLS weights only)."""
    from plslam.models.solver import linearize_blocks

    focal = cfg.focal_length
    lp = cfg.line_param
    eps = cfg.eig_eps if state.p.dtype == jnp.float64 else max(cfg.eig_eps, 1e-5)
    if lp != "world":
        # callers hold world-frame lines; marginalize in the configured chart
        state = state._replace(line=res.lines_from_world(state, state.line, f.ln_start, lp))
    if groups is not None:
        assert len(groups) > 0, "groups passed but empty — caller wiring bug"
        pt_w, ln_w, _ = res.weights_of_groups(groups, cfg.cauchy_c)
    else:
        pt_w, ln_w, _ = res.robust_weights(state, f, focal, cfg.cauchy_c, lp)
    DC, MF, ML = lay.dim_cam, lay.max_f, lay.max_l

    # structured linearization of the marginal factor subset (same fast path
    # as the solver: camera-dims jacfwd + landmark jvps — the blocks ARE the
    # Schur layout `_eliminate_landmarks` needs, no dense [D,D] H)
    ones = jnp.ones((lay.dim,), state.p.dtype)
    r0, J_cam, (B_d, d_raw, b_d_raw, B_l, Cb_raw, b_l_raw) = linearize_blocks(
        state, _marg_factor_subset(f), lay, focal, pt_w, ln_w, ones, None, lp)
    Hcc = J_cam.T @ J_cam
    b_cr = J_cam.T @ r0

    # 0) Jacobi scaling: IMU-bias whitening puts ~14 decades on diag(H); every
    #    eigendecomposition below operates in scaled (unit-diagonal) space so
    #    the eigenvalue floor is relative and float32 survives.
    diag = jnp.concatenate([jnp.diag(Hcc), d_raw,
                            jax.vmap(jnp.diag)(Cb_raw).reshape(-1)])
    sc = jnp.where(diag > 1e-12, 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-12)), 1.0)
    sc_c = sc[:DC]
    sc_d = sc[DC : DC + MF]
    sc_l = sc[DC + MF :].reshape(ML, 4)

    # 1) eliminate all landmark dims in scaled space (uninvolved blocks are
    #    zero → the pseudo-inverses drop them), directly from the blocks
    Hcc_s = Hcc * sc_c[:, None] * sc_c[None, :]
    Bd = B_d * sc_c[:, None] * sc_d[None, :]
    Bl = B_l * sc_c[:, None, None] * sc_l[None, :, :]
    d_s = d_raw * sc_d * sc_d
    Cb = Cb_raw * sc_l[:, :, None] * sc_l[:, None, :]
    d_inv = jnp.where(d_s > eps, 1.0 / jnp.maximum(d_s, eps), 0.0)
    Cb_inv = jax.vmap(lambda M: _pinv_psd(M, eps))(Cb)
    BCd = Bd * d_inv[None, :]
    BCl = jnp.einsum("dma,mab->dmb", Bl, Cb_inv)
    H_c = Hcc_s - BCd @ Bd.T - jnp.einsum("dmb,emb->de", BCl, Bl)
    b_c = (b_cr * sc_c - BCd @ (b_d_raw * sc_d)
           - jnp.einsum("dmb,mb->d", BCl, b_l_raw * sc_l))

    # 2) eliminate frame-0 pose+speedbias (15 dims) with eigh pseudo-inverse
    drop, keep = _drop0_indices(lay)
    H_dd = H_c[drop][:, drop]
    H_dk = H_c[drop][:, keep]
    H_kk = H_c[keep][:, keep]
    b_d = b_c[drop]
    b_k = b_c[keep]
    H_dd_inv = _pinv_psd(H_dd, eps)
    H_new_k = H_kk - H_dk.T @ H_dd_inv @ H_dk
    b_new_k = b_k - H_dk.T @ H_dd_inv @ b_d

    # 3) √-refactor the KEPT block only (DC−15 dims — the dropped frame-0
    #    rows/cols are exactly zero, so eigh over the full DC wastes ~25 % of
    #    an O(n³) factorization), then scatter into DC dims and apply the
    #    shift perm to the COLUMNS (rows of J0 are an arbitrary basis:
    #    (J0[:,perm])ᵀ(J0[:,perm]) = H[perm][:,perm])
    DC = lay.dim_cam
    J0k, r0k = _sqrt_refactor(H_new_k, b_new_k, eps)
    J0 = jnp.zeros((DC, DC), H_c.dtype).at[jnp.ix_(keep, keep)].set(J0k)
    r0p = jnp.zeros((DC,), H_c.dtype).at[keep].set(r0k)
    perm = _shift_perm(lay)
    sc_perm = sc[:DC][perm]

    # 4) un-scale J0's columns back to tangent units
    J0 = J0[:, perm] * (1.0 / sc_perm)[None, :]

    # 5) snapshot = current state shifted like the window will be
    roll = lambda a: jnp.concatenate([a[1:], a[:1]], axis=0)
    return Prior(
        J=J0, r0=r0p, valid=jnp.ones((), H_c.dtype),
        p=roll(state.p), q=roll(state.q), v=roll(state.v),
        ba=roll(state.ba), bg=roll(state.bg),
        p_bc=state.p_bc, q_bc=state.q_bc, td=state.td,
    )


@partial(jax.jit, static_argnames=("lay", "cfg"))
@highest_matmul_precision
def marginalize_second_new(
    state: WindowState, f: res.WindowFactors, lay: TangentLayout, cfg: SolverConfig
) -> Prior:
    """MARGIN_SECOND_NEW: drop the second-newest pose from the existing prior
    (its visual terms are simply discarded; its preintegration is merged by
    the caller — the reference's `slideWindowNew` path). Speed/bias columns
    alias to the merged frame exactly as the reference's address relabelling."""
    eps = cfg.eig_eps if f.prior_J.dtype == jnp.float64 else max(cfg.eig_eps, 1e-5)
    nw = lay.nw
    H = f.prior_J.T @ f.prior_J
    b = f.prior_J.T @ f.prior_r0
    dH = jnp.diag(H)
    sc = jnp.where(dH > 1e-12, 1.0 / jnp.sqrt(jnp.maximum(dH, 1e-12)), 1.0)
    H = H * sc[:, None] * sc[None, :]
    b = b * sc

    drop = jnp.arange((nw - 2) * 6, (nw - 1) * 6)  # pose slot NW-2
    keep = jnp.asarray(
        np.setdiff1d(np.arange(lay.dim_cam), np.arange((lay.nw - 2) * 6, (lay.nw - 1) * 6))
    )
    H_dd_inv = _pinv_psd(H[drop][:, drop], eps)
    H_dk = H[drop][:, keep]
    H_kk = H[keep][:, keep] - H_dk.T @ H_dd_inv @ H_dk
    b_kk = b[keep] - H_dk.T @ H_dd_inv @ b[drop]

    DC = lay.dim_cam
    J0k, r0k = _sqrt_refactor(H_kk, b_kk, eps)  # kept block only (see MARGIN_OLD)
    J0 = jnp.zeros((DC, DC), H.dtype).at[jnp.ix_(keep, keep)].set(J0k)
    r0p = jnp.zeros((DC,), H.dtype).at[keep].set(r0k)
    J0 = J0 * (1.0 / sc)[None, :]
    return Prior(
        J=J0, r0=r0p, valid=f.prior_valid,
        p=f.prior_p, q=f.prior_q, v=f.prior_v, ba=f.prior_ba, bg=f.prior_bg,
        p_bc=f.prior_p_bc, q_bc=f.prior_q_bc, td=f.prior_td,
    )


def install_prior(f: res.WindowFactors, prior: Prior) -> res.WindowFactors:
    return f._replace(
        prior_J=prior.J, prior_r0=prior.r0, prior_valid=prior.valid,
        prior_p=prior.p, prior_q=prior.q, prior_v=prior.v,
        prior_ba=prior.ba, prior_bg=prior.bg,
        prior_p_bc=prior.p_bc, prior_q_bc=prior.q_bc, prior_td=prior.td,
    )
