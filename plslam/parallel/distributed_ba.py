"""Distributed bundle adjustment: landmark-sharded Schur reduction over a
device mesh.

No reference equivalent — the reference is single-machine ROS with zero
collectives (SURVEY.md §2.6). This is the scaling plan of
SURVEY.md §5.7/§5.8: the reduced camera system of an 11-pose window is tiny
(DC×DC ≈ 172²), so poses are REPLICATED; landmarks (inverse-depth scalars,
4-dof lines) and their observations are SHARDED across the `lmk` mesh axis.

Per LM iteration, inside one `shard_map`:
  1. each shard linearises its own visual factors (jacfwd over
     [camera dims | local landmark dims]),
  2. eliminates its landmark blocks locally (block-diagonal Schur — blocks
     never mix shards, so no communication),
  3. `psum`s its reduced camera contribution (S_shard [DC,DC], rhs [DC]) —
     the only collective, O(DC²) bytes over NVLink,
  4. solves the replicated DC×DC system (every shard redundantly — cheaper
     than broadcasting) and back-substitutes its local landmark deltas.

IMU + prior factors are replicated; shard 0 contributes them (others add 0)
so the psum yields the exact global normal equations. Matches the
single-device solver up to reduction order — tested on a forced-8-device CPU
mesh (SURVEY.md §4 fake-backend technique).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models.solver import reanchor
from plslam.models.state import TangentLayout, WindowState
from plslam.ops.lines import orth_retract
from plslam.utils.geometry import quat_box_plus
from plslam.utils.device import highest_matmul_precision


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("lmk",))


def _split(a, n):
    pad = (-a.shape[0]) % n
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad, *a.shape[1:]), a.dtype)])
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


def _visual_residual(state, pt, ln, focal):
    """Point+line residuals of a local factor shard (shapes from the arrays —
    the single-device residual kernels are capacity-agnostic)."""
    pt_obs, pt_vel, pt_mask, pt_start, pt_valid = pt
    ln_obs, ln_mask, ln_valid = ln
    f_local = res.WindowFactors(
        imu_alpha=None, imu_beta=None, imu_gamma=None, imu_jac=None,
        imu_sqrt_info=None, imu_dt=None, imu_ba=None, imu_bg=None,
        imu_valid=None, g=jnp.zeros(3, state.p.dtype),
        pt_obs=pt_obs, pt_vel=pt_vel,
        pt_td_ref=jnp.zeros((pt_mask.shape[1],), state.p.dtype),
        pt_rowf=jnp.zeros(pt_mask.shape, state.p.dtype), rs_tr=jnp.zeros((), state.p.dtype),
        pt_mask=pt_mask, pt_start=pt_start,
        pt_valid=pt_valid,
        ln_obs=ln_obs, ln_mask=ln_mask, ln_valid=ln_valid,
        ln_start=jnp.zeros(ln_valid.shape, jnp.int32),  # world-param lines only
        relo_obs=None, relo_mask=None, relo_valid=None,
        prior_J=None, prior_r0=None, prior_valid=None,
        prior_p=None, prior_q=None, prior_v=None, prior_ba=None, prior_bg=None,
        prior_p_bc=None, prior_q_bc=None, prior_td=None,
    )
    r_pt = res.point_residuals(state, f_local, focal)
    r_ln = res.line_residuals(state, f_local, focal)
    return r_pt, r_ln


def _retract_local(state: WindowState, dc, dd, dl) -> WindowState:
    """Camera-dim delta dc [DC] + local landmark deltas (dd [mf_s], dl [ml_s,4])."""
    nw = state.p.shape[0]
    dp = dc[0 : nw * 6].reshape(nw, 6)
    dsb = dc[nw * 6 : nw * 15].reshape(nw, 9)
    dext = dc[nw * 15 : nw * 15 + 6]
    dtd = dc[nw * 15 + 6]
    return WindowState(
        p=state.p + dp[:, 0:3],
        q=quat_box_plus(state.q, dp[:, 3:6]),
        v=state.v + dsb[:, 0:3],
        ba=state.ba + dsb[:, 3:6],
        bg=state.bg + dsb[:, 6:9],
        p_bc=state.p_bc + dext[0:3],
        q_bc=quat_box_plus(state.q_bc, dext[3:6]),
        td=state.td + dtd,
        relo_p=state.relo_p,
        relo_q=state.relo_q,
        inv_depth=state.inv_depth + dd,
        line=orth_retract(state.line, dl),
    )


def make_lm_iter(axis, lay, cfg, focal, mf_s, ml_s, dtype, pt, ln, cam_residual):
    """One landmark-sharded LM iteration as a `lax.scan` body, parameterised
    by the mesh axis that shards landmarks. Shared by the 1-D 'lmk' solve
    below and the 2-D ('kf_part','lmk') mesh of `parallel.mesh2d`.

    carry = (state_cam, inv_depth_local, line_local, lam, cost); psum over
    `axis` reduces the DC×DC camera system — the only collective."""
    DC = lay.dim_cam
    pt_valid = pt[4]
    ln_valid = ln[2]
    is0 = (jax.lax.axis_index(axis) == 0).astype(dtype)
    dim_local = DC + mf_s + ml_s * 4
    # frozen camera dims (extrinsic + td, as the single-device free_mask)
    nw = lay.nw
    cam_free = jnp.ones((DC,), dtype).at[nw * 15 :].set(0.0)

    def lm_iter(carry, _):
        st_cam, inv_d, line, lam, _ = carry
        st = st_cam._replace(inv_depth=inv_d, line=line)

        r_pt0, r_ln0 = _visual_residual(st, pt, ln, focal)
        pt_w = res.cauchy_weights(jnp.sum(r_pt0 * r_pt0, -1), cfg.cauchy_c)
        ln_w = res.cauchy_weights(jnp.sum(r_ln0 * r_ln0, -1), cfg.cauchy_c)

        def r_local(delta):
            dc = delta[:DC]
            dd = delta[DC : DC + mf_s]
            dl = delta[DC + mf_s :].reshape(ml_s, 4)
            st_d = _retract_local(st, dc, dd, dl)
            r_pt, r_ln = _visual_residual(st_d, pt, ln, focal)
            r_cam = cam_residual(st_d) * is0
            return jnp.concatenate([
                r_cam,
                (r_pt * pt_w[..., None]).reshape(-1),
                (r_ln * ln_w[..., None]).reshape(-1),
            ])

        zero = jnp.zeros((dim_local,), dtype)
        r0 = r_local(zero)
        J = jax.jacfwd(r_local)(zero)
        H = J.T @ J
        b = J.T @ r0
        cost = jax.lax.psum(0.5 * jnp.sum(r0 * r0), axis)

        # Jacobi scaling; camera diag is global
        dH_cam = jax.lax.psum(jnp.diag(H)[:DC], axis)
        dH_lmk = jnp.diag(H)[DC:]
        lmk_mask = jnp.concatenate([pt_valid, jnp.repeat(ln_valid, 4)])
        sc_cam = cam_free / jnp.sqrt(jnp.maximum(dH_cam, 1e-8))
        sc_lmk = lmk_mask / jnp.sqrt(jnp.maximum(dH_lmk, 1e-8))
        sc = jnp.concatenate([sc_cam, sc_lmk])
        Hs = H * sc[:, None] * sc[None, :]
        bs = b * sc
        damp = lam + 1e-8

        Bd = Hs[:DC, DC : DC + mf_s]
        Bl = Hs[:DC, DC + mf_s :].reshape(DC, ml_s, 4)
        b_d = bs[DC : DC + mf_s]
        b_l = bs[DC + mf_s :].reshape(ml_s, 4)
        d = jnp.diag(Hs)[DC : DC + mf_s] + damp * pt_valid + (1.0 - pt_valid)
        idx = jnp.arange(ml_s)
        Cb = Hs[DC + mf_s :, DC + mf_s :].reshape(ml_s, 4, ml_s, 4)[idx, :, idx, :]
        Cb = Cb + jax.vmap(jnp.diag)(
            (damp * ln_valid + (1.0 - ln_valid))[:, None] * jnp.ones((ml_s, 4), dtype)
        )
        Cb_inv = jnp.linalg.inv(Cb)

        BCd = Bd / d[None, :]
        BCl = jnp.einsum("dma,mab->dmb", Bl, Cb_inv)
        S_local = Hs[:DC, :DC] - BCd @ Bd.T - jnp.einsum("dmb,emb->de", BCl, Bl)
        rhs_local = -bs[:DC] + BCd @ b_d + jnp.einsum("dmb,mb->d", BCl, b_l)

        # ---- the collective: reduce the camera system over the mesh ----
        S = jax.lax.psum(S_local, axis) + jnp.diag(damp * cam_free + (1.0 - cam_free))
        rhs = jax.lax.psum(rhs_local, axis) * cam_free

        cf = jax.scipy.linalg.cho_factor(S)
        dc_s = jax.scipy.linalg.cho_solve(cf, rhs)
        dd_s = (-b_d - Bd.T @ dc_s) / d
        dl_s = jnp.einsum("mab,mb->ma", Cb_inv, -b_l - jnp.einsum("dma,d->ma", Bl, dc_s))

        dc = dc_s * sc_cam
        dd = dd_s * sc_lmk[:mf_s]
        dl = (dl_s.reshape(-1) * sc_lmk[mf_s:]).reshape(ml_s, 4)

        st_try = _retract_local(st, dc, dd, dl)
        r_pt1, r_ln1 = _visual_residual(st_try, pt, ln, focal)
        cost_try = jax.lax.psum(
            0.5 * (jnp.sum((r_pt1 * pt_w[..., None]) ** 2)
                   + jnp.sum((r_ln1 * ln_w[..., None]) ** 2)
                   + jnp.sum((cam_residual(st_try) * is0) ** 2)),
            axis,
        )

        # a failed inner solve (Cholesky on a near-indefinite f32 system at
        # low damping) yields NaN deltas → NaN cost_try: treat as a
        # rejected step (lam grows, next iteration retries) and keep the
        # cost finite instead of letting min(NaN, ·) poison the report
        good = jnp.isfinite(cost_try)
        accept = good & (cost_try < cost)
        pick = lambda a, c: jnp.where(accept, a, c)
        st_cam_new = jax.tree.map(pick, _strip(st_try), _strip(st))
        inv_new = pick(st_try.inv_depth, inv_d)
        line_new = pick(st_try.line, line)
        lam_new = jnp.where(accept, jnp.maximum(lam * 0.4, cfg.lm_lambda_min),
                            jnp.minimum(lam * 5.0, cfg.lm_lambda_max))
        cost_out = jnp.where(good, jnp.minimum(cost_try, cost), cost)
        return (st_cam_new, inv_new, line_new, lam_new, cost_out), None

    return lm_iter


@partial(jax.jit, static_argnames=("lay", "cfg", "mesh", "num_iters"))
@highest_matmul_precision
def distributed_optimize_window(
    state: WindowState,
    f: res.WindowFactors,
    lay: TangentLayout,
    cfg: SolverConfig,
    mesh: Mesh,
    num_iters: int = 8,
):
    """Landmark-sharded LM solve. Returns (state', final cost [replicated])."""
    n = int(mesh.devices.size)
    focal = cfg.focal_length
    DC = lay.dim_cam
    dtype = state.p.dtype

    pt_shards = (
        _split(f.pt_obs, n), _split(f.pt_vel, n), _split(f.pt_mask, n),
        _split(f.pt_start, n), _split(f.pt_valid, n),
    )
    ln_shards = (_split(f.ln_obs, n), _split(f.ln_mask, n), _split(f.ln_valid, n))
    inv_d_s = _split(state.inv_depth, n)
    line_s = _split(state.line, n)
    mf_s = inv_d_s.shape[1]
    ml_s = line_s.shape[1]
    state_cam = state._replace(inv_depth=jnp.zeros((0,), dtype), line=jnp.zeros((0, 6), dtype))

    def cam_residual(st):
        r_imu = res.imu_residuals(st, f).reshape(-1)
        r_pr = res.prior_residual(st, f, lay)
        return jnp.concatenate([r_pr, r_imu])

    state_specs = WindowState(*[P() for _ in WindowState._fields])

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(
            state_specs,
            tuple(P("lmk") for _ in range(5)),
            tuple(P("lmk") for _ in range(3)),
            P("lmk"), P("lmk"),
        ),
        out_specs=(state_specs, P("lmk"), P("lmk"), P()),
        check_vma=False,
    )
    def solve(state_repl, pt_sh, ln_sh, inv_d_l, line_l):
        pt = tuple(a[0] for a in pt_sh)
        ln = tuple(a[0] for a in ln_sh)
        lm_iter = make_lm_iter("lmk", lay, cfg, focal, mf_s, ml_s, dtype,
                               pt, ln, cam_residual)
        lam0 = jnp.asarray(cfg.lm_lambda_init, dtype)
        init = (state_repl, inv_d_l[0], line_l[0], lam0, jnp.zeros((), dtype))
        (st_cam, inv_out, line_out, _, cost), _ = jax.lax.scan(lm_iter, init, None, length=num_iters)
        return st_cam, inv_out[None], line_out[None], cost

    st_cam, inv_out, line_out, cost = solve(state_cam, pt_shards, ln_shards, inv_d_s, line_s)
    state_out = st_cam._replace(
        inv_depth=inv_out.reshape(-1)[: lay.max_f],
        line=line_out.reshape(-1, 6)[: lay.max_l],
    )
    state_out = reanchor(state_out, state)
    return state_out, cost


def _strip(st: WindowState) -> WindowState:
    return st._replace(
        inv_depth=jnp.zeros((0,), st.p.dtype), line=jnp.zeros((0, 6), st.p.dtype)
    )
