"""Batched damped Gauss-Newton / LM solver with landmark Schur elimination.

JAX replacement for the reference's Ceres solve
(`Estimator::optimization()` → `ceres::Solve` with DENSE_SCHUR + trust region,
≤8 iterations — SURVEY.md §3.3 / §A.6). Instead of a general sparse solver,
the window problem is one fixed-shape dense system:

  * one `jax.jacfwd` through the manifold retraction linearises *all* factors
    at once (J is [N_res, D], a single fused batch),
  * H = JᵀJ, b = Jᵀr assembled as matmuls (the reference's 4-pthread Hessian
    assembly in `marginalization_factor.cpp` collapses to one einsum),
  * landmarks (inverse depths: scalar blocks; lines: 4×4 blocks) are
    Schur-eliminated in closed form, leaving a DC×DC reduced camera system
    solved by Cholesky,
  * LM damping + accept/reject runs as a `lax.fori_loop` (fixed iteration
    count like the reference's `NUM_ITERATIONS=8`),
  * gauge: like the reference's `double2vector()`, the solution is re-anchored
    post-solve so frame-0 position and yaw keep their pre-solve values.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models.state import TangentLayout, WindowState, retract
from plslam.ops.lines import plucker_transform
from plslam.utils.geometry import quat_mul, quat_rotate, quat_to_rot, rot_to_quat, rot_to_ypr, ypr_to_rot
from plslam.utils.device import highest_matmul_precision


class SolveStats(NamedTuple):
    cost0: jnp.ndarray
    cost: jnp.ndarray
    lam: jnp.ndarray
    accepted: jnp.ndarray  # number of accepted steps
    # the true (weight-free) Cauchy objective before/after — comparable
    # across iterations, unlike the IRLS-weighted cost0/cost whose weights
    # are re-derived each iteration (Ceres' Summary initial/final_cost)
    cost_robust0: jnp.ndarray = jnp.nan
    cost_robust: jnp.ndarray = jnp.nan
    # unweighted residual groups at the FINAL state (the LM carry — free):
    # callers hand them to `marginalize_old(..., groups=…)` so the IRLS
    # weights there reuse this evaluation instead of re-running the stack
    groups: tuple = ()


def free_mask(f: res.WindowFactors, lay: TangentLayout, cfg: SolverConfig,
              estimate_extrinsic: bool, estimate_td: bool,
              freeze_frames: tuple = (), extra_pinned: tuple = ()) -> jnp.ndarray:
    """0/1 mask over tangent dims: which deltas the solver may move.
    `freeze_frames` pins whole poses, `extra_pinned` arbitrary tangent dims
    (the reference's SetParameterBlockConstant)."""
    dtype = f.g.dtype
    m = jnp.ones((lay.dim,), dtype)
    if not estimate_extrinsic:
        m = m.at[lay.off_ext : lay.off_td].set(0.0)
    if not estimate_td:
        m = m.at[lay.off_td].set(0.0)
    for k in freeze_frames:
        m = m.at[lay.off_pose + 6 * k : lay.off_pose + 6 * (k + 1)].set(0.0)
    m = m.at[lay.off_relo : lay.off_depth].set(f.relo_valid)
    m = m.at[lay.off_depth : lay.off_line].set(f.pt_valid)
    ln = jnp.repeat(f.ln_valid, 4)
    m = m.at[lay.off_line :].set(ln)
    for d in extra_pinned:
        m = m.at[d].set(0.0)
    return m


def linearize(state, f, lay, focal, pt_w, ln_w, mask, relo_w=None, line_param="world"):
    zero = jnp.zeros((lay.dim,), state.p.dtype)

    def r_fn(delta):
        return res.residual_stack(retract(state, delta * mask, lay), f, lay, focal,
                                  pt_w, ln_w, relo_w, line_param)

    r0 = r_fn(zero)
    J = jax.jacfwd(r_fn)(zero)
    return r0, J


def linearize_blocks(state, f, lay: TangentLayout, focal, pt_w, ln_w, mask,
                     relo_w=None, line_param="world"):
    """Structured linearization — the production fast path.

    The full-tangent `jacfwd` (D ≈ DC + MF + 4·ML ≈ 700 directional
    derivatives of the whole stack) wastes > 3/4 of its tangents on landmark
    dims whose jacobian is SLOT-DIAGONAL: residual slot (feature f, frame j)
    depends only on λ_f (and line slot only on its own 4 orth dims). So the
    tangent space is compressed to DC+5 directions — the DC camera dims plus
    5 *structured* landmark directions (the all-depths direction, in which
    each point slot reads off exactly ∂r/∂λ_f, and one direction per line
    orth component) — and ONE jacfwd over the whole stack yields J_cam AND
    both landmark jacobians as columns. (A previous version ran 1 jacfwd + 5
    separate jvps; the window solve is op-latency-bound, and folding
    all directions into one differentiation graph cut the per-iteration op
    count.) Normal-equation blocks (H_cc, B_d, d, B_l, C_b, b) are then
    assembled by einsum directly in the Schur block layout — no scatters, no
    dense [D,D] H.

    Returns (r0, J_cam [N,DC], blocks) with blocks =
    (B_d [DC,MF], d [MF], b_d [MF], B_l [DC,ML,4], Cb [ML,4,4], b_l [ML,4]).
    Produces the same normal equations as the dense path (tests pin it)."""
    DC, MF, ML, NW = lay.dim_cam, lay.max_f, lay.max_l, lay.nw
    W = NW - 1
    dtype = state.p.dtype
    mask_c = mask[:DC]
    mask_d = mask[DC : DC + MF]
    mask_l = mask[DC + MF :].reshape(ML, 4)

    def r_ext(de):
        # de[:DC] camera dims; de[DC] common depth direction; de[DC+1+k]
        # common line-orth-component-k direction
        delta = jnp.concatenate([
            de[:DC] * mask_c,
            de[DC] * mask_d,
            (de[DC + 1 :][None, :] * mask_l).reshape(-1),
        ])
        return res.residual_stack(retract(state, delta, lay), f, lay, focal,
                                  pt_w, ln_w, relo_w, line_param)

    zero_e = jnp.zeros((DC + 5,), dtype)
    r0 = r_ext(zero_e)
    J_ext = jax.jacfwd(r_ext)(zero_e)  # [N,DC+5]
    J_cam = J_ext[:, :DC]

    # residual-stack row layout: [prior DC | imu W·15 | pt MF·NW·2 | ln ML·NW·2 | relo MF·2]
    o_pt = DC + W * 15
    o_ln = o_pt + MF * NW * 2
    o_re = o_ln + ML * NW * 2
    # landmark columns: slot-diagonal structure makes the compressed
    # directions exact — point rows only ever see their own λ_f, line rows
    # their own 4 orth dims; IMU/prior rows are zero in these columns.
    Jd_pt = J_ext[o_pt:o_ln, DC].reshape(MF, NW, 2)
    Jd_re = J_ext[o_re:, DC].reshape(MF, 2)
    J_ln = J_ext[o_ln:o_re, DC + 1 :].reshape(ML, NW, 2, 4)
    Jc_pt = J_cam[o_pt:o_ln].reshape(MF, NW, 2, DC)
    Jc_ln = J_cam[o_ln:o_re].reshape(ML, NW, 2, DC)
    Jc_re = J_cam[o_re:].reshape(MF, 2, DC)
    r_pt = r0[o_pt:o_ln].reshape(MF, NW, 2)
    r_ln = r0[o_ln:o_re].reshape(ML, NW, 2)
    r_re = r0[o_re:].reshape(MF, 2)

    B_d = (jnp.einsum("fjrd,fjr->df", Jc_pt, Jd_pt)
           + jnp.einsum("frd,fr->df", Jc_re, Jd_re))  # [DC,MF]
    d = jnp.sum(Jd_pt * Jd_pt, axis=(1, 2)) + jnp.sum(Jd_re * Jd_re, axis=1)  # [MF]
    b_d = jnp.sum(Jd_pt * r_pt, axis=(1, 2)) + jnp.sum(Jd_re * r_re, axis=1)
    B_l = jnp.einsum("ljrd,ljrk->dlk", Jc_ln, J_ln)  # [DC,ML,4]
    Cb = jnp.einsum("ljrk,ljrm->lkm", J_ln, J_ln)  # [ML,4,4]
    b_l = jnp.einsum("ljrk,ljr->lk", J_ln, r_ln)  # [ML,4]
    return r0, J_cam, (B_d, d, b_d, B_l, Cb, b_l)


def schur_solve_blocks(r0, J_cam, blocks, lay: TangentLayout, lam, mask, eps=1e-8):
    """`schur_solve` on the pre-assembled Schur blocks (no dense [D,D] H).
    Identical math: Jacobi column scaling, +λI damping in scaled variables,
    closed-form landmark elimination, Cholesky on the DC×DC reduced system."""
    DC, MF, ML = lay.dim_cam, lay.max_f, lay.max_l
    B_d, d_raw, b_d_raw, B_l, Cb_raw, b_l_raw = blocks
    H_cc = J_cam.T @ J_cam
    b_c_raw = J_cam.T @ r0

    diag = jnp.concatenate([jnp.diag(H_cc), d_raw,
                            jax.vmap(jnp.diag)(Cb_raw).reshape(-1)])
    pin = 1.0 - mask
    scale = (1.0 / jnp.sqrt(jnp.maximum(diag, eps))) * mask
    sc_c = scale[:DC]
    sc_d = scale[DC : DC + MF]
    sc_l = scale[DC + MF :].reshape(ML, 4)
    damp = lam + eps

    A = H_cc * sc_c[:, None] * sc_c[None, :] + jnp.diag(pin[:DC] + damp * mask[:DC])
    Bd = B_d * sc_c[:, None] * sc_d[None, :]
    Bl = B_l * sc_c[:, None, None] * sc_l[None, :, :]
    b_c = b_c_raw * sc_c
    b_d = b_d_raw * sc_d
    b_l = b_l_raw * sc_l

    d = d_raw * sc_d * sc_d + pin[DC : DC + MF] + damp * mask[DC : DC + MF]
    Cb = Cb_raw * sc_l[:, :, None] * sc_l[:, None, :]
    pin_l = pin[DC + MF :].reshape(ML, 4)
    Cb = Cb + jax.vmap(jnp.diag)(pin_l + damp * mask[DC + MF :].reshape(ML, 4))
    Cb_inv = jnp.linalg.inv(Cb)

    BCd = Bd / d[None, :]
    BCl = jnp.einsum("dma,mab->dmb", Bl, Cb_inv)
    S = A - BCd @ Bd.T - jnp.einsum("dmb,emb->de", BCl, Bl)
    rhs = -b_c + BCd @ b_d + jnp.einsum("dmb,mb->d", BCl, b_l)

    cf = jax.scipy.linalg.cho_factor(S)
    dc = jax.scipy.linalg.cho_solve(cf, rhs)
    dd = (-b_d - Bd.T @ dc) / d
    dl = jnp.einsum("mab,mb->ma", Cb_inv, -b_l - jnp.einsum("dma,d->ma", Bl, dc))
    delta = jnp.concatenate([dc * sc_c, dd * sc_d, (dl * sc_l).reshape(-1)])
    return delta * mask


def _line_diag_blocks(C_l, max_l):
    idx = jnp.arange(max_l)
    return C_l.reshape(max_l, 4, max_l, 4)[idx, :, idx, :]  # [ML,4,4]


def schur_solve(H, b, lay: TangentLayout, lam, mask, eps=1e-8):
    """Solve (H + λ·diag(H))δ = −b with landmark Schur elimination.

    Depth blocks are scalars; line blocks 4×4 — the DENSE_SCHUR structure of
    the reference, in closed form. Frozen dims (mask=0) are pinned to δ=0 via
    unit diagonal + zero rhs.

    The system is Jacobi-preconditioned (column scaling D = diag(H)^-½) before
    factorisation: IMU-bias whitening puts ~12 orders of magnitude on the
    diagonal, which float32 — the accelerator dtype — cannot survive raw. In
    scaled variables diag(H̃)=1, so LM damping is simply +λI."""
    DC, MF, ML = lay.dim_cam, lay.max_f, lay.max_l
    dH = jnp.diag(H)
    pin = 1.0 - mask
    scale = 1.0 / jnp.sqrt(jnp.maximum(dH, eps))
    scale = scale * mask  # frozen dims scaled to zero → unit diag via pin
    Hs = H * scale[:, None] * scale[None, :] + jnp.diag(pin)
    bs = b * scale
    damp = lam + eps

    A = Hs[:DC, :DC] + jnp.diag(damp * mask[:DC])
    Bd = Hs[:DC, DC : DC + MF]
    Bl = Hs[:DC, DC + MF :].reshape(DC, ML, 4)
    b_c = bs[:DC]
    b_d = bs[DC : DC + MF]
    b_l = bs[DC + MF :].reshape(ML, 4)

    d = jnp.diagonal(Hs)[DC : DC + MF] + damp * mask[DC : DC + MF]
    C_l = Hs[DC + MF :, DC + MF :]
    Cb = _line_diag_blocks(C_l, ML)
    damp_l = (damp * mask[DC + MF :]).reshape(ML, 4)
    Cb = Cb + jax.vmap(jnp.diag)(damp_l)
    Cb_inv = jnp.linalg.inv(Cb)  # [ML,4,4]

    BCd = Bd / d[None, :]
    BCl = jnp.einsum("dma,mab->dmb", Bl, Cb_inv)
    S = A - BCd @ Bd.T - jnp.einsum("dmb,emb->de", BCl, Bl)
    rhs = -b_c + BCd @ b_d + jnp.einsum("dmb,mb->d", BCl, b_l)

    cf = jax.scipy.linalg.cho_factor(S)
    dc = jax.scipy.linalg.cho_solve(cf, rhs)

    dd = (-b_d - Bd.T @ dc) / d
    dl = jnp.einsum("mab,mb->ma", Cb_inv, -b_l - jnp.einsum("dma,d->ma", Bl, dc))
    delta = jnp.concatenate([dc, dd, dl.reshape(-1)]) * scale
    return delta * mask


def cost_of(r):
    return 0.5 * jnp.sum(r * r)


@partial(jax.jit, static_argnames=("lay", "cfg", "estimate_extrinsic", "estimate_td", "num_iters", "freeze_frames", "structured", "extra_pinned", "dense"))
@highest_matmul_precision
def optimize_window(
    state: WindowState,
    f: res.WindowFactors,
    lay: TangentLayout,
    cfg: SolverConfig,
    estimate_extrinsic: bool = False,
    estimate_td: bool = False,
    num_iters: int = 8,
    freeze_frames: tuple = (),
    structured: bool = False,
    extra_pinned: tuple = (),
    pin_mask=None,
    dense: bool = False,
):
    """Run the windowed LM solve; returns (state', stats). Jitted once per
    static config (`Estimator::optimization()` equivalent).

    Default linearization is `linearize_blocks` (camera-dims jacfwd + 5
    landmark jvps + direct Schur-block einsum assembly — no dense [D,D] H).
    dense=True is the original full-tangent jacfwd (validation cross-check);
    structured=True is the per-factor scatter assembly (assembly.py — ~20×
    fewer FLOPs but scatter-add-bound; its GPU time is not measured)."""
    from plslam.models import assembly

    focal = cfg.focal_length
    lp = cfg.line_param
    mask = free_mask(f, lay, cfg, estimate_extrinsic, estimate_td, freeze_frames, extra_pinned)
    if pin_mask is not None:
        mask = mask * pin_mask  # dynamic pins (no recompilation per pin set)

    groups0 = res.residual_groups(state, f, lay, focal, lp)
    pt_w0, ln_w0, relo_w0 = res.weights_of_groups(groups0, cfg.cauchy_c)
    cost0 = cost_of(res.stack_of_groups(groups0, pt_w0, ln_w0, relo_w0))

    def step(_, carry):
        # the carried `groups` are the UNWEIGHTED residuals at `state` — the
        # cost_try evaluation of the previous iteration. Deriving this
        # iteration's IRLS weights from them (instead of re-evaluating
        # robust_weights) removes one full residual-stack evaluation per LM
        # iteration; the values are identical by construction.
        state, groups, lam, cost, naccept = carry
        pt_w, ln_w, relo_w = res.weights_of_groups(groups, cfg.cauchy_c)
        if structured:
            H, b, cost_here = assembly.assemble(state, f, lay, focal, pt_w, ln_w, relo_w, lp)
            H = H * mask[:, None] * mask[None, :]
            b = b * mask
            delta = schur_solve(H, b, lay, lam, mask)
        elif dense:
            r, J = linearize(state, f, lay, focal, pt_w, ln_w, mask, relo_w, lp)
            H = J.T @ J
            b = J.T @ r
            cost_here = cost_of(r)
            delta = schur_solve(H, b, lay, lam, mask)
        else:
            r, J_cam, blocks = linearize_blocks(state, f, lay, focal, pt_w, ln_w,
                                                mask, relo_w, lp)
            cost_here = cost_of(r)
            delta = schur_solve_blocks(r, J_cam, blocks, lay, lam, mask)
        state_try = retract(state, delta, lay)
        groups_try = res.residual_groups(state_try, f, lay, focal, lp)
        cost_try = cost_of(res.stack_of_groups(groups_try, pt_w, ln_w, relo_w))
        accept = cost_try < cost_here
        state = jax.tree.map(lambda a, c: jnp.where(accept, a, c), state_try, state)
        groups = jax.tree.map(lambda a, c: jnp.where(accept, a, c), groups_try, groups)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * 0.4, cfg.lm_lambda_min),
            jnp.minimum(lam * 5.0, cfg.lm_lambda_max),
        )
        cost = jnp.where(accept, cost_try, cost_here)
        return (state, groups, lam, cost, naccept + accept.astype(jnp.int32))

    lam0 = jnp.asarray(cfg.lm_lambda_init, state.p.dtype)
    state_out, groups_out, lam, cost, naccept = jax.lax.fori_loop(
        0, num_iters, step, (state, groups0, lam0, cost0, jnp.zeros((), jnp.int32))
    )
    state_out = reanchor(state_out, state, line_param=lp)
    return state_out, SolveStats(
        cost0=cost0, cost=cost, lam=lam, accepted=naccept,
        cost_robust0=res.robust_cost_of_groups(groups0, cfg.cauchy_c),
        cost_robust=res.robust_cost_of_groups(groups_out, cfg.cauchy_c),
        groups=groups_out)


def reanchor(state_new: WindowState, state_ref: WindowState,
             line_param: str = "world") -> WindowState:
    """Gauge repair (`double2vector()`): rotate/translate the solution so
    frame-0 position and yaw match `state_ref` (the pre-solve state). World
    landmarks (Plücker lines) transform along; inverse depths — and lines in
    the anchored `_incamera`/`_instartframe` charts — are frame-anchored and
    invariant."""
    ypr_ref = rot_to_ypr(quat_to_rot(state_ref.q[0]))
    ypr_new = rot_to_ypr(quat_to_rot(state_new.q[0]))
    dyaw = ypr_ref[0] - ypr_new[0]
    z = jnp.zeros_like(dyaw)
    Rz = ypr_to_rot(jnp.stack([dyaw, z, z]))
    q_z = rot_to_quat(Rz)
    t = state_ref.p[0] - Rz @ state_new.p[0]

    p = (state_new.p @ Rz.T) + t
    q = quat_mul(jnp.broadcast_to(q_z, state_new.q.shape), state_new.q)
    v = state_new.v @ Rz.T
    line = plucker_transform(state_new.line, Rz, t) if line_param == "world" else state_new.line
    relo_p = Rz @ state_new.relo_p + t
    relo_q = quat_mul(q_z, state_new.relo_q)
    return state_new._replace(p=p, q=q, v=v, line=line, relo_p=relo_p, relo_q=relo_q)
