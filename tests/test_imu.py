import jax.numpy as jnp
import numpy as np
import pytest

from plslam.io import synthetic
from plslam.ops import imu as imu_ops
from plslam.utils.geometry import quat_box_minus


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(duration=3.0, n_points=8, n_lines=4, seed=1)


def frame_states(seq, k):
    return seq.gt_p[k], seq.gt_q[k], seq.gt_v[k]


def preint_between(seq, k0, k1, ba=None, bg=None, noise=None):
    acc, gyr, dt = synthetic.imu_between(seq, float(seq.frame_t[k0]), float(seq.frame_t[k1]))
    ba = jnp.zeros(3, acc.dtype) if ba is None else ba
    bg = jnp.zeros(3, acc.dtype) if bg is None else bg
    noise = noise or imu_ops.ImuNoise.euroc(acc.dtype)
    return imu_ops.preintegrate(acc, gyr, dt, ba, bg, noise)


def test_residual_zero_at_ground_truth(seq):
    g = jnp.asarray(synthetic.G_WORLD)
    for k0, k1 in [(0, 2), (10, 12), (30, 34)]:
        pre = preint_between(seq, k0, k1)
        p_i, q_i, v_i = frame_states(seq, k0)
        p_j, q_j, v_j = frame_states(seq, k1)
        z = jnp.zeros(3)
        r = imu_ops.imu_residual(p_i, q_i, v_i, z, z, p_j, q_j, v_j, z, z, pre, g)
        # midpoint integration at 200 Hz over 0.1-0.2 s: discretisation error only
        assert float(jnp.max(jnp.abs(r))) < 2e-5, (k0, k1, np.asarray(r))


def test_bias_jacobian_matches_repropagation(seq):
    """First-order bias correction (the stored J blocks) must match actually
    re-running preintegration with shifted biases — the reference's
    `repropagate` consistency."""
    pre0 = preint_between(seq, 0, 4)
    dba = jnp.asarray([0.02, -0.01, 0.015])
    dbg = jnp.asarray([0.004, 0.006, -0.005])
    pre1 = preint_between(seq, 0, 4, ba=dba, bg=dbg)
    a_corr, b_corr, g_corr = imu_ops.bias_corrected_delta(pre0, dba, dbg)
    np.testing.assert_allclose(a_corr, pre1.alpha, atol=5e-5)
    np.testing.assert_allclose(b_corr, pre1.beta, atol=5e-5)
    dth = quat_box_minus(pre1.gamma, g_corr)
    assert float(jnp.max(jnp.abs(dth))) < 5e-5


def test_covariance_psd_and_growth(seq):
    pre_short = preint_between(seq, 0, 1)
    pre_long = preint_between(seq, 0, 8)
    for pre in (pre_short, pre_long):
        w = np.linalg.eigvalsh(np.asarray(pre.cov))
        assert w.min() > -1e-12
    assert np.trace(np.asarray(pre_long.cov)) > np.trace(np.asarray(pre_short.cov))


def test_sqrt_info_whitens(seq):
    pre = preint_between(seq, 0, 4)
    S = imu_ops.sqrt_info_from_cov(pre.cov)
    P = jnp.asarray(pre.cov)
    np.testing.assert_allclose(np.asarray(S @ P @ S.T), np.eye(15), atol=1e-6)


def test_dt_sum(seq):
    pre = preint_between(seq, 0, 2)
    np.testing.assert_allclose(
        float(pre.dt_sum), float(seq.frame_t[2] - seq.frame_t[0]), atol=1e-9
    )


def test_wiggle_preamble_imu_consistent():
    """The initialization-excitation preamble (TrajectoryParams.wiggle_amp)
    must produce IMU samples exactly consistent with its ground-truth poses:
    the preintegrated IMU residual at GT states stays ~0 through the wiggle."""
    params = synthetic.TrajectoryParams(omega=0.3, wiggle_amp=0.2)
    wseq = synthetic.make_sequence(duration=2.0, n_points=8, n_lines=0, seed=2,
                                   params=params)
    g = jnp.asarray(synthetic.G_WORLD)
    for k0, k1 in [(0, 2), (8, 10), (20, 24)]:
        pre = preint_between(wseq, k0, k1)
        p0, q0, v0 = frame_states(wseq, k0)
        p1, q1, v1 = frame_states(wseq, k1)
        z3 = jnp.zeros(3)
        r = imu_ops.imu_residual(p0, q0, v0, z3, z3, p1, q1, v1, z3, z3, pre, g)
        assert float(jnp.max(jnp.abs(r[:9]))) < 2e-3, (k0, k1, np.asarray(r))


def test_associative_scan_matches_sequential():
    """`preintegrate` (lax.associative_scan formulation — log-depth batched
    15×15 matmuls, the accelerator redesign of IntegrationBase::propagate)
    must reproduce the sequential midpoint recursion to float reassociation,
    including zero-dt padded steps (exact identity elements)."""
    rng = np.random.default_rng(0)
    for n, pad in ((20, 0), (20, 492), (200, 0), (1, 0)):
        N = n + pad
        acc = np.zeros((N + 1, 3))
        gyr = np.zeros((N + 1, 3))
        dt = np.zeros(N)
        acc[: n + 1] = rng.normal(0, 2, (n + 1, 3)) + [0, 0, 9.81]
        gyr[: n + 1] = rng.normal(0, 0.5, (n + 1, 3))
        acc[n + 1:] = acc[n]
        gyr[n + 1:] = gyr[n]
        dt[:n] = 0.005
        ba = rng.normal(0, 0.05, 3)
        bg = rng.normal(0, 0.01, 3)
        args = [jnp.asarray(a, jnp.float64) for a in (acc, gyr, dt, ba, bg)]
        noise = imu_ops.ImuNoise.euroc(jnp.float64)
        p_seq = imu_ops.preintegrate_sequential(*args, noise)
        p_par = imu_ops.preintegrate(*args, noise)
        for field in ("alpha", "beta", "gamma", "jac", "cov", "dt_sum"):
            a = np.asarray(getattr(p_seq, field))
            b = np.asarray(getattr(p_par, field))
            scale = max(1.0, float(np.max(np.abs(a))))
            np.testing.assert_allclose(b, a, atol=1e-10 * scale,
                                       err_msg=f"{field} n={n} pad={pad}")
