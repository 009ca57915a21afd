"""Window BA solver tests: residual stack correctness, Schur-vs-dense solve,
and convergence from a perturbed window back to ground truth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam.config import SolverConfig
from plslam.io import synthetic
from plslam.models import packing, residuals as res, solver
from plslam.models.state import layout, retract
from plslam.utils.geometry import quat_box_minus


CFG = SolverConfig(max_features=48, max_line_feats=12)
LAY = layout(CFG)


@pytest.fixture(scope="module")
def window():
    seq = synthetic.make_sequence(duration=6.0, n_points=120, n_lines=40, seed=3)
    frames = list(range(0, 55, 5))  # 11 keyframes, 0.25 s apart
    state, f = packing.factors_from_synthetic(seq, frames, CFG, LAY)
    return state, f


def test_residuals_zero_at_ground_truth(window):
    state, f = window
    r = res.residual_stack(state, f, LAY, CFG.focal_length)
    # whitened units: IMU midpoint discretisation error ≪ 1σ
    assert float(jnp.max(jnp.abs(r))) < 0.05, float(jnp.max(jnp.abs(r)))
    # visual part should be ~exactly zero
    r_pt = res.point_residuals(state, f, CFG.focal_length)
    r_ln = res.line_residuals(state, f, CFG.focal_length)
    assert float(jnp.max(jnp.abs(r_pt))) < 1e-6
    assert float(jnp.max(jnp.abs(r_ln))) < 1e-6


def test_jacobian_matches_finite_difference(window):
    state, f = window
    mask = jnp.ones((LAY.dim,))
    r0, J = solver.linearize(state, f, LAY, CFG.focal_length, None, None, mask)
    rng = np.random.default_rng(0)
    for _ in range(5):
        d = jnp.asarray(rng.standard_normal(LAY.dim) * 1e-6)
        r1 = res.residual_stack(retract(state, d, LAY), f, LAY, CFG.focal_length)
        r2 = res.residual_stack(retract(state, -d, LAY), f, LAY, CFG.focal_length)
        np.testing.assert_allclose(np.asarray(0.5 * (r1 - r2)), np.asarray(J @ d), atol=1e-9)


def test_schur_matches_dense_solve(window):
    state, f = window
    mask = solver.free_mask(f, LAY, CFG, False, False)
    r0, J = solver.linearize(state, f, LAY, CFG.focal_length, None, None, mask)
    H = J.T @ J
    b = J.T @ r0
    lam = 1e-4
    delta_schur = solver.schur_solve(H, b, LAY, lam, mask)
    # dense reference solve on the same damped/pinned system (the scaled
    # +λI damping equals λ·diag(H) damping in original variables)
    dH = jnp.diag(H)
    pin = 1.0 - mask
    Hd = H + jnp.diag((lam + 1e-8) * dH + pin)
    delta_dense = jnp.linalg.solve(Hd, -(b * mask)) * mask
    np.testing.assert_allclose(np.asarray(delta_schur), np.asarray(delta_dense), atol=1e-8)


def test_optimize_recovers_ground_truth(window):
    state_gt, f = window
    rng = np.random.default_rng(5)
    nw = LAY.nw
    # realistic perturbation (IMU dead-reckoning error scale) on everything
    # except frame 0 (gauge anchor)
    dp = rng.standard_normal((nw, 3)) * 0.01
    dth = rng.standard_normal((nw, 3)) * 0.004
    dp[0] = 0
    dth[0] = 0
    delta = np.zeros(LAY.dim)
    delta[: nw * 6] = np.concatenate([dp, dth], axis=-1).reshape(-1)
    # velocity 1 cm/s; biases at their random-walk scale (large bias jolts
    # put the window solve in a different basin — true of the reference too)
    sb = rng.standard_normal((nw, 9))
    sb[:, 0:3] *= 0.01  # velocity: cm/s dead-reckoning error
    sb[:, 3:6] *= 5e-5  # accel bias: random-walk scale (larger jolts put the
    sb[:, 6:9] *= 5e-6  # gyro bias:  solve in an LM-crawl valley — ref. too)
    delta[LAY.off_sb : LAY.off_ext] = sb.reshape(-1)
    delta[LAY.off_depth : LAY.off_line] = rng.standard_normal(LAY.max_f) * 0.005
    delta[LAY.off_line :] = rng.standard_normal(LAY.max_l * 4) * 0.01
    state_pert = retract(state_gt, jnp.asarray(delta), LAY)

    state_opt, stats = solver.optimize_window(state_pert, f, LAY, CFG, num_iters=10)
    assert float(stats.cost) < float(stats.cost0) * 1e-3
    # frame-0 yaw+position is the gauge anchor; the rest must match GT
    p_err = np.asarray(jnp.linalg.norm(state_opt.p - state_gt.p, axis=-1))
    q_err = np.asarray(jnp.linalg.norm(quat_box_minus(state_opt.q, state_gt.q), axis=-1))
    v_err = np.asarray(jnp.linalg.norm(state_opt.v - state_gt.v, axis=-1))
    assert p_err.max() < 1e-3, p_err
    assert q_err.max() < 1e-3, q_err
    assert v_err.max() < 1e-2, v_err
    # depths recovered
    val = np.asarray(f.pt_valid) > 0
    d_err = np.abs(np.asarray(state_opt.inv_depth - state_gt.inv_depth))[val]
    assert d_err.max() < 2e-3, d_err.max()


def test_structured_assembly_matches_dense(window):
    """The per-factor block assembly must produce the same normal equations
    as the one-big-jacfwd dense path (same jacobians, different summation)."""
    from plslam.models import assembly

    state, f = window
    pt_w, ln_w, relo_w = res.robust_weights(state, f, CFG.focal_length, CFG.cauchy_c)
    mask = jnp.ones((LAY.dim,))
    r0, J = solver.linearize(state, f, LAY, CFG.focal_length, pt_w, ln_w, mask, relo_w)
    H_d = np.asarray(J.T @ J)
    b_d = np.asarray(J.T @ r0)
    H_s, b_s, cost_s = assembly.assemble(state, f, LAY, CFG.focal_length, pt_w, ln_w, relo_w)
    scale_H = np.abs(H_d).max()
    scale_b = np.abs(b_d).max() + 1e-12
    np.testing.assert_allclose(np.asarray(H_s), H_d, atol=1e-9 * scale_H)
    np.testing.assert_allclose(np.asarray(b_s), b_d, atol=1e-9 * scale_b)
    np.testing.assert_allclose(float(cost_s), float(solver.cost_of(r0)), rtol=1e-10)


def test_optimize_structured_matches_dense_solve(window):
    state_gt, f = window
    rng = np.random.default_rng(8)
    delta = np.zeros(LAY.dim)
    delta[6 : LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.005
    pert = retract(state_gt, jnp.asarray(delta), LAY)
    st_s, _ = solver.optimize_window(pert, f, LAY, CFG, num_iters=6, structured=True)
    st_d, _ = solver.optimize_window(pert, f, LAY, CFG, num_iters=6, structured=False)
    np.testing.assert_allclose(np.asarray(st_s.p), np.asarray(st_d.p), atol=1e-6)


def test_optimize_float32(window):
    """The accelerator path (f32 normal equations) must stay accurate to ~mm scale."""
    state_gt, f = window
    to32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, t)
    state32, f32 = to32(state_gt), to32(f)
    rng = np.random.default_rng(6)
    delta = np.zeros(LAY.dim)
    delta[6 : LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.03
    state_pert = retract(state32, jnp.asarray(delta, jnp.float32), LAY)
    state_opt, stats = solver.optimize_window(state_pert, f32, LAY, CFG, num_iters=8)
    p_err = np.asarray(jnp.linalg.norm(state_opt.p - state32.p, axis=-1))
    assert p_err.max() < 5e-3, p_err


def test_blocks_linearization_matches_dense(window):
    """`linearize_blocks` + `schur_solve_blocks` (the production fast path:
    camera-dims jacfwd + landmark jvps, no dense [D,D] H) must reproduce the
    full-tangent dense path's step exactly."""
    state, f = window
    pt_w, ln_w, relo_w = res.robust_weights(state, f, CFG.focal_length, CFG.cauchy_c)
    mask = solver.free_mask(f, LAY, CFG, False, False)
    lam = jnp.asarray(1e-4)

    r0_d, J = solver.linearize(state, f, LAY, CFG.focal_length, pt_w, ln_w, mask, relo_w)
    H = J.T @ J
    b = J.T @ r0_d
    delta_dense = solver.schur_solve(H, b, LAY, lam, mask)

    r0_b, J_cam, blocks = solver.linearize_blocks(
        state, f, LAY, CFG.focal_length, pt_w, ln_w, mask, relo_w)
    np.testing.assert_allclose(np.asarray(r0_b), np.asarray(r0_d), atol=1e-12)
    delta_blocks = solver.schur_solve_blocks(r0_b, J_cam, blocks, LAY, lam, mask)
    scale = np.abs(np.asarray(delta_dense)).max() + 1e-12
    np.testing.assert_allclose(np.asarray(delta_blocks), np.asarray(delta_dense),
                               atol=1e-7 * scale)


def test_optimize_blocks_matches_dense_solve(window):
    state_gt, f = window
    rng = np.random.default_rng(12)
    delta = np.zeros(LAY.dim)
    delta[6 : LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.005
    pert = retract(state_gt, jnp.asarray(delta), LAY)
    st_b, stats_b = solver.optimize_window(pert, f, LAY, CFG, num_iters=6)
    st_d, stats_d = solver.optimize_window(pert, f, LAY, CFG, num_iters=6, dense=True)
    np.testing.assert_allclose(np.asarray(st_b.p), np.asarray(st_d.p), atol=1e-6)
    np.testing.assert_allclose(float(stats_b.cost), float(stats_d.cost), rtol=1e-6)
