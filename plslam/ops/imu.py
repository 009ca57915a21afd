"""IMU midpoint preintegration + the 15-dim IMU factor residual.

JAX equivalent of the reference's
`vins_estimator/src/factor/integration_base.h` (`IntegrationBase::
midPointIntegration / propagate / repropagate / evaluate`) and
`factor/imu_factor.h` (`IMUFactor`) — SURVEY.md §2.3 / §A.2
(reconstruction, reference mount empty).

Design: the per-sample sequential recursion becomes one `jax.lax.scan`
carrying (α, β, γ, J, P); `repropagate` is simply re-running the scan with new
bias linearisation points. Error-state ordering is
``[δα(3), δθ(3), δβ(3), δba(3), δbg(3)]`` and the 18-dim noise is
``[n_a0, n_w0, n_a1, n_w1, n_ba, n_bg]`` with diagonal
``(ACC_N², GYR_N², ACC_N², GYR_N², ACC_W², GYR_W²)``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from plslam.utils.geometry import (
    quat_box_minus,
    quat_conj,
    quat_exp,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    skew,
)
from plslam.utils.device import highest_matmul_precision


class ImuNoise(NamedTuple):
    acc_n: jnp.ndarray  # accelerometer white noise density
    gyr_n: jnp.ndarray  # gyroscope white noise density
    acc_w: jnp.ndarray  # accelerometer bias random walk
    gyr_w: jnp.ndarray  # gyroscope bias random walk

    @staticmethod
    def euroc(dtype=jnp.float32):
        """EuRoC config values (SURVEY.md §5.6)."""
        return ImuNoise(*[jnp.asarray(v, dtype) for v in (0.08, 0.004, 4e-5, 2e-6)])


class Preintegration(NamedTuple):
    """Preintegrated IMU delta between two frames (the `IntegrationBase` state)."""

    alpha: jnp.ndarray  # [3]  Δp in frame i
    beta: jnp.ndarray  # [3]  Δv in frame i
    gamma: jnp.ndarray  # [4]  Δq (wxyz)
    jac: jnp.ndarray  # [15,15] d(delta)/d(initial error state) — bias blocks used
    cov: jnp.ndarray  # [15,15] covariance of the error state
    dt_sum: jnp.ndarray  # [] total integration time
    ba: jnp.ndarray  # [3] linearisation accel bias
    bg: jnp.ndarray  # [3] linearisation gyro bias


def _midpoint_step(carry, inp, noise_q):
    """One midpoint step (the body of `midPointIntegration`)."""
    alpha, beta, gamma, J, P, t = carry
    acc0, gyr0, acc1, gyr1, dt, ba, bg = inp
    dtype = alpha.dtype

    w_mid = 0.5 * (gyr0 + gyr1) - bg
    dq = quat_exp(w_mid * dt)
    gamma_new = quat_normalize(quat_mul(gamma, dq))

    R0 = quat_to_rot(gamma)
    R1 = quat_to_rot(gamma_new)
    a0 = acc0 - ba
    a1 = acc1 - ba
    a_mid = 0.5 * (quat_rotate(gamma, a0) + quat_rotate(gamma_new, a1))
    alpha_new = alpha + beta * dt + 0.5 * a_mid * dt * dt
    beta_new = beta + a_mid * dt

    # --- error-state jacobians (standard VINS-Mono midpoint F, V) ---
    I3 = jnp.eye(3, dtype=dtype)
    sk_w = skew(w_mid)
    sk_a0 = skew(a0)
    sk_a1 = skew(a1)
    R0a0 = R0 @ sk_a0
    R1a1 = R1 @ sk_a1
    x = R0a0 + R1a1 @ (I3 - sk_w * dt)  # d(a_mid)/dθ core term (× -1/2)

    F = jnp.zeros((15, 15), dtype=dtype)
    F = F.at[0:3, 0:3].set(I3)
    F = F.at[0:3, 3:6].set(-0.25 * dt * dt * x)
    F = F.at[0:3, 6:9].set(I3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt * dt)
    F = F.at[0:3, 12:15].set(0.25 * R1a1 * dt * dt * dt)
    F = F.at[3:6, 3:6].set(I3 - sk_w * dt)
    F = F.at[3:6, 12:15].set(-I3 * dt)
    F = F.at[6:9, 3:6].set(-0.5 * dt * x)
    F = F.at[6:9, 6:9].set(I3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1a1 * dt * dt)
    F = F.at[9:12, 9:12].set(I3)
    F = F.at[12:15, 12:15].set(I3)

    V = jnp.zeros((15, 18), dtype=dtype)
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt * dt)
    v01 = -0.125 * R1a1 * dt * dt * dt  # 0.25 · (-R1[a1]×dt²) · ½dt
    V = V.at[0:3, 3:6].set(v01)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt * dt)
    V = V.at[0:3, 9:12].set(v01)
    V = V.at[3:6, 3:6].set(0.5 * I3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * I3 * dt)
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    v61 = -0.25 * R1a1 * dt * dt  # 0.5 · (-R1[a1]×dt) · ½dt
    V = V.at[6:9, 3:6].set(v61)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(v61)
    V = V.at[9:12, 12:15].set(I3 * dt)
    V = V.at[12:15, 15:18].set(I3 * dt)

    J_new = F @ J
    P_new = F @ P @ F.T + (V * noise_q[None, :]) @ V.T
    return (alpha_new, beta_new, gamma_new, J_new, P_new, t + dt), None


def _noise_diag(noise: ImuNoise, dtype):
    return jnp.concatenate(
        [
            jnp.full((3,), noise.acc_n**2, dtype),
            jnp.full((3,), noise.gyr_n**2, dtype),
            jnp.full((3,), noise.acc_n**2, dtype),
            jnp.full((3,), noise.gyr_n**2, dtype),
            jnp.full((3,), noise.acc_w**2, dtype),
            jnp.full((3,), noise.gyr_w**2, dtype),
        ]
    )


@highest_matmul_precision
def preintegrate_sequential(acc, gyr, dt, ba, bg, noise: ImuNoise) -> Preintegration:
    """The reference-shaped sequential recursion (`IntegrationBase::
    propagate` step by step, `lax.scan`). Kept as the ground-truth
    implementation `preintegrate` is pinned against — a long sequential
    scan of 15×15 matmuls is latency-bound (its GPU time is not measured)."""
    dtype = acc.dtype
    n = dt.shape[0]
    noise_q = _noise_diag(noise, dtype)
    init = (
        jnp.zeros(3, dtype),
        jnp.zeros(3, dtype),
        quat_identity(dtype),
        jnp.eye(15, dtype=dtype),
        jnp.zeros((15, 15), dtype=dtype),
        jnp.zeros((), dtype),
    )
    ba_b = jnp.broadcast_to(ba, (n, 3))
    bg_b = jnp.broadcast_to(bg, (n, 3))
    xs = (acc[:-1], gyr[:-1], acc[1:], gyr[1:], dt, ba_b, bg_b)
    (alpha, beta, gamma, J, P, t), _ = jax.lax.scan(
        lambda c, i: _midpoint_step(c, i, noise_q), init, xs
    )
    return Preintegration(alpha, beta, gamma, J, P, t, jnp.asarray(ba, dtype), jnp.asarray(bg, dtype))


@highest_matmul_precision
def preintegrate(acc, gyr, dt, ba, bg, noise: ImuNoise) -> Preintegration:
    """Integrate N steps from boundary samples acc/gyr [N+1,3], dt [N].

    Equivalent to `IntegrationBase::propagate` run over the whole buffer;
    `repropagate(ba', bg')` is just calling this again with new biases (the
    raw samples are kept by the caller).

    Parallel formulation: the midpoint recursion is ASSOCIATIVE, so the
    whole integration runs as `lax.associative_scan` (log₂N rounds of
    batched ops) instead of N sequential steps:

      * γᵢ is the prefix quaternion product of the per-step increments
        exp(ω̄ᵢ δtᵢ) — the increments depend only on raw samples and the
        fixed bias linearisation point, never on the carry;
      * with every γᵢ known, the rotated accelerations āᵢ are batched
        elementwise work, and β/α are (nested) prefix sums;
      * the error-state transition/noise pair composes as the monoid
        (F₂,Q₂)∘(F₁,Q₁) = (F₂F₁, F₂Q₁F₂ᵀ+Q₂), giving J = ∏F and P = ⊕Q in
        one associative scan of batched 15×15 matmuls.

    Padded steps (δt = 0) are exact identities of every operation, so
    fixed-shape padding costs nothing and changes nothing. Equality with the
    sequential recursion is pinned by tests/test_imu.py (differences are
    float reassociation only; the sequential path normalizes γ per step,
    this one normalizes the prefix products once). Its GPU time against the
    sequential scan is not measured.
    """
    dtype = acc.dtype
    n = dt.shape[0]
    if n == 0:  # empty buffer → identity preintegration (matches sequential)
        return Preintegration(
            jnp.zeros(3, dtype), jnp.zeros(3, dtype), quat_identity(dtype),
            jnp.eye(15, dtype=dtype), jnp.zeros((15, 15), dtype=dtype),
            jnp.zeros((), dtype), jnp.asarray(ba, dtype), jnp.asarray(bg, dtype))
    noise_q = _noise_diag(noise, dtype)
    I3 = jnp.eye(3, dtype=dtype)

    ba = jnp.asarray(ba, dtype)
    bg = jnp.asarray(bg, dtype)
    dtc = dt[:, None]
    w_mid = 0.5 * (gyr[:-1] + gyr[1:]) - bg  # [n,3]
    dqs = quat_exp(w_mid * dtc)  # [n,4] per-step increments
    # γ chain: prefix quaternion products (associative), normalized once
    gam = jax.lax.associative_scan(quat_mul, dqs)  # [n,4] γ_{i+1}
    gamma_new = quat_normalize(gam)
    gamma_prev = jnp.concatenate([quat_identity(dtype)[None], gamma_new[:-1]], axis=0)

    a0 = acc[:-1] - ba
    a1 = acc[1:] - ba
    a_mid = 0.5 * (quat_rotate(gamma_prev, a0) + quat_rotate(gamma_new, a1))  # [n,3]
    db = a_mid * dtc  # per-step Δβ
    beta_prefix = jnp.concatenate(
        [jnp.zeros((1, 3), dtype), jnp.cumsum(db, axis=0)[:-1]], axis=0)  # β_i
    beta = beta_prefix[-1] + db[-1]
    alpha = jnp.sum(beta_prefix * dtc + 0.5 * a_mid * dtc * dt[:, None], axis=0)

    # batched F [n,15,15], V-noise Q [n,15,15] (same algebra as _midpoint_step)
    R0 = quat_to_rot(gamma_prev)
    R1 = quat_to_rot(gamma_new)
    sk_w = skew(w_mid)
    R0a0 = R0 @ skew(a0)
    R1a1 = R1 @ skew(a1)
    d1 = dtc[..., None]  # [n,1,1]
    x = R0a0 + R1a1 @ (I3 - sk_w * d1)

    Z = jnp.zeros((n, 3, 3), dtype)
    In = jnp.broadcast_to(I3, (n, 3, 3))
    row = lambda *bs: jnp.concatenate(bs, axis=-1)
    F = jnp.concatenate([
        row(In, -0.25 * d1 * d1 * x, In * d1, -0.25 * (R0 + R1) * d1 * d1,
            0.25 * R1a1 * d1 * d1 * d1),
        row(Z, In - sk_w * d1, Z, Z, -In * d1),
        row(Z, -0.5 * d1 * x, In, -0.5 * (R0 + R1) * d1, 0.5 * R1a1 * d1 * d1),
        row(Z, Z, Z, In, Z),
        row(Z, Z, Z, Z, In),
    ], axis=-2)  # [n,15,15]
    v01 = -0.125 * R1a1 * d1 * d1 * d1
    v61 = -0.25 * R1a1 * d1 * d1
    V = jnp.concatenate([
        row(0.25 * R0 * d1 * d1, v01, 0.25 * R1 * d1 * d1, v01, Z, Z),
        row(Z, 0.5 * In * d1, Z, 0.5 * In * d1, Z, Z),
        row(0.5 * R0 * d1, v61, 0.5 * R1 * d1, v61, Z, Z),
        row(Z, Z, Z, Z, In * d1, Z),
        row(Z, Z, Z, Z, Z, In * d1),
    ], axis=-2)  # [n,15,18]
    Q = (V * noise_q[None, None, :]) @ jnp.swapaxes(V, -1, -2)  # [n,15,15]

    def combine(left, right):
        A1, Q1 = left
        A2, Q2 = right
        return A2 @ A1, A2 @ Q1 @ jnp.swapaxes(A2, -1, -2) + Q2

    A_tot, Q_tot = jax.lax.associative_scan(combine, (F, Q))
    return Preintegration(alpha, beta, gamma_new[-1], A_tot[-1], Q_tot[-1],
                          jnp.sum(dt), ba, bg)


def bias_corrected_delta(pre: Preintegration, ba, bg):
    """First-order bias correction of (α, β, γ) (`IntegrationBase::evaluate` preamble)."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    dp_dba = pre.jac[0:3, 9:12]
    dp_dbg = pre.jac[0:3, 12:15]
    dq_dbg = pre.jac[3:6, 12:15]
    dv_dba = pre.jac[6:9, 9:12]
    dv_dbg = pre.jac[6:9, 12:15]
    alpha = pre.alpha + dp_dba @ dba + dp_dbg @ dbg
    beta = pre.beta + dv_dba @ dba + dv_dbg @ dbg
    gamma = quat_normalize(quat_mul(pre.gamma, quat_exp(dq_dbg @ dbg)))
    return alpha, beta, gamma


@highest_matmul_precision
def sqrt_info_from_cov(P, jitter=None):
    """Whitening matrix S with SᵀS = P⁻¹. The reference formed
    `LLT(covariance.inverse()).matrixL().transpose()`; we factor the
    diagonally-SCALED covariance instead (unit diagonal → Cholesky is
    well-conditioned even in float32, where the raw diag spans ~11 decades
    between position and bias-random-walk blocks):
        P = D P̃ D,  P̃ = chol → L̃L̃ᵀ,  S = L̃⁻¹ D⁻¹.
    """
    dtype = P.dtype
    if jitter is None:
        jitter = 1e-10 if dtype == jnp.float64 else 1e-6
    n = P.shape[0]
    P = 0.5 * (P + P.T)
    d = jnp.maximum(jnp.diag(P), 1e-30)
    s = 1.0 / jnp.sqrt(d)  # D⁻¹ diagonal
    Pn = P * s[:, None] * s[None, :]
    Pn = Pn + jitter * jnp.eye(n, dtype=dtype)
    Ln = jnp.linalg.cholesky(Pn)
    return jax.scipy.linalg.solve_triangular(Ln, jnp.diag(s), lower=True)


@highest_matmul_precision
def imu_residual(p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, pre: Preintegration, g):
    """Unwhitened 15-dim IMU residual (`IMUFactor::Evaluate`, SURVEY.md §A.2).

    r_p  = R(q_i)ᵀ( p_j − p_i − v_i Δt + ½ g Δt² ) − α̂
    r_θ  = 2·vec( γ̂⁻¹ ⊗ q_i⁻¹ ⊗ q_j )
    r_v  = R(q_i)ᵀ( v_j − v_i + g Δt ) − β̂
    r_ba = ba_j − ba_i ;  r_bg = bg_j − bg_i
    """
    dt = pre.dt_sum
    alpha, beta, gamma = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = quat_conj(q_i)
    r_p = quat_rotate(qi_inv, p_j - p_i - v_i * dt + 0.5 * g * dt * dt) - alpha
    q_ij = quat_mul(qi_inv, q_j)
    r_th = quat_box_minus(q_ij, gamma)
    r_v = quat_rotate(qi_inv, v_j - v_i + g * dt) - beta
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return jnp.concatenate([r_p, r_th, r_v, r_ba, r_bg])
