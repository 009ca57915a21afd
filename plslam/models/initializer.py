"""Visual-inertial initialization.

JAX equivalent of the reference's `vins_estimator/src/initial/`:
  * `solve_5pts.cpp` (`MotionEstimator::solveRelativeRT`)   → normalized
    8-point essential-matrix RANSAC (host, runs once),
  * `initial_sfm.cpp` (`GlobalSFM::construct`)              → vision-only BA
    reusing the window LM/Schur solver with IMU+prior factors masked off,
  * `initial_alignment.cpp` (`solveGyroscopeBias`,
    `LinearAlignment`, `RefineGravity`)                      → small dense LS
    solves (jnp.linalg.lstsq),
  * `Estimator::initialStructure/visualInitialAlign`        → `try_initialize`.

SURVEY.md §2.3 / §3.3. Deviation from the reference (documented): alignment
uses the 11 window frames only, not the auxiliary `all_image_frame` buffer —
on 10 Hz keyframes the extra frames add little and the fixed-shape window
keeps everything jittable.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from plslam.utils import quat_np as qnp
from plslam.utils.device import pull_all
from plslam.models import residuals as res
from plslam.models import solver as solver_mod
from plslam.models.state import zero_state
from plslam.models import triangulate
from plslam.utils.geometry import (
    gravity_to_rot,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    ypr_to_rot,
)
from plslam.utils.device import highest_matmul_precision

MIN_CORRESPONDENCES = 20
MIN_PARALLAX_INIT = 30.0 / 460.0  # 30 px-equivalent in normalized coords
# physical sanity ceiling on the aligned velocities (m/s). A degenerate init
# window (rotation-dominant parallax) leaves scale nearly unobservable; the
# alignment's free per-frame velocities then absorb the residual and a
# wildly wrong scale passes every algebraic gate (measured: an s≈8× init
# with residual 5e-4, identical in f64 — seeds study, round 5). Wrong scale
# shows up directly as implausible metric velocities (≈8× the true ~1 m/s),
# so reject and retry on the next frame — EuRoC-class platforms fly ≤2.3 m/s
MAX_INIT_VELOCITY = 3.0


# --------------------------------------------------------------------- 8-point
@highest_matmul_precision
def essential_ransac(pts1, pts2, iters=200, thresh=3.0 / 460.0, seed=0):
    """Normalized 8-point essential matrix with RANSAC; returns (R, t, inliers)
    with x2 ≈ R x1 + t up to scale (`MotionEstimator::solveRelativeRT`).

    All hypotheses are built, solved (one batched [iters,8,9] SVD) and scored
    at once — the former sequential 200-iteration Python loop burned ~0.1 s
    per frame exactly while initialization was failing hardest, and runs per
    frame during ESTIMATE_EXTRINSIC=2 calibration (VERDICT r3 weak #7)."""
    rng = np.random.default_rng(seed)
    n = len(pts1)
    if n < 8:
        return None
    x1 = np.concatenate([pts1, np.ones((n, 1))], axis=1)
    x2 = np.concatenate([pts2, np.ones((n, 1))], axis=1)

    def build_A(a1, a2):
        """[..., 8, 9] epipolar design matrix from [..., 8, 3] point pairs."""
        return np.stack(
            [a2[..., 0] * a1[..., 0], a2[..., 0] * a1[..., 1], a2[..., 0],
             a2[..., 1] * a1[..., 0], a2[..., 1] * a1[..., 1], a2[..., 1],
             a1[..., 0], a1[..., 1], np.ones(a1.shape[:-1])], axis=-1)

    def rank2(E):
        """Project [...,3,3] onto the essential manifold (σ = 1,1,0)."""
        U, _, Vt = np.linalg.svd(E)
        S = np.zeros_like(E)
        S[..., 0, 0] = 1.0
        S[..., 1, 1] = 1.0
        return U @ S @ Vt

    def sampson(E):
        """E [...,3,3] → squared Sampson distances [...,N]."""
        Ex1 = np.einsum("...ij,nj->...ni", E, x1)
        Etx2 = np.einsum("...ji,nj->...ni", E, x2)
        num = np.einsum("ni,...ni->...n", x2, Ex1) ** 2
        den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
               + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
        return num / np.maximum(den, 1e-12)

    idx = np.stack([rng.choice(n, 8, replace=False) for _ in range(iters)])
    with np.errstate(all="ignore"):
        A = build_A(x1[idx], x2[idx])  # [iters,8,9]
        _, _, Vt = np.linalg.svd(A)
        E = rank2(Vt[:, -1, :].reshape(-1, 3, 3))  # [iters,3,3]
        d = sampson(E)  # [iters,N]
    inl = (d < thresh * thresh) & np.isfinite(d)
    best_i = int(np.argmax(inl.sum(axis=1)))
    best_in = inl[best_i]
    if best_in.sum() < 12:
        return None
    # refit on the best hypothesis's inliers
    sel = np.nonzero(best_in)[0]
    _, _, Vt = np.linalg.svd(build_A(x1[sel], x2[sel]))
    best_E = rank2(Vt[-1].reshape(3, 3))
    best_in = sampson(best_E) < thresh * thresh

    # decompose + cheirality (`recoverPose`)
    U, _, Vt = np.linalg.svd(best_E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]

    a = x1[best_in]
    b = x2[best_in]
    rows13 = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    row3 = np.array([0.0, 0, 1.0, 0])

    def depth_count(R, t):
        # triangulate with P1=[I|0], P2=[R|t] — one batched [M,4,4] SVD
        P2 = np.concatenate([R, t[:, None]], axis=1)  # [3,4]
        M = np.stack([
            a[:, 0, None] * row3[None] - rows13[0][None],
            a[:, 1, None] * row3[None] - rows13[1][None],
            b[:, 0, None] * P2[2][None] - P2[0][None],
            b[:, 1, None] * P2[2][None] - P2[1][None],
        ], axis=1)  # [M,4,4]
        with np.errstate(all="ignore"):
            _, _, Vt3 = np.linalg.svd(M)
        X = Vt3[:, -1, :]
        w = X[:, 3]
        X3 = X[:, :3] / np.where(np.abs(w) > 1e-12, w, 1e-12)[:, None]
        z1 = X3[:, 2]
        z2 = X3 @ R[2] + t[2]
        return int(np.sum((z1 > 0) & (z2 > 0)))

    R, t = max(cands, key=lambda c: depth_count(*c))
    return R, t, best_in


# ------------------------------------------------------------------------- SFM
def _relative_pose(est):
    """Find reference frame ℓ with enough parallax to the newest frame and
    solve 5-pt relative pose (`Estimator::relativePose`)."""
    nw = est.cfg.window_size
    tbl = est.pt_table
    for l in range(nw):
        both = tbl.active & tbl.mask[:, l] & tbl.mask[:, nw]
        if both.sum() < MIN_CORRESPONDENCES:
            continue
        d = tbl.obs[both, nw] - tbl.obs[both, l]
        parallax = np.mean(np.linalg.norm(d, axis=1))
        if parallax < MIN_PARALLAX_INIT:
            continue
        out = essential_ransac(tbl.obs[both, l], tbl.obs[both, nw])
        if out is None:
            continue
        R, t, _ = out  # x_new = R x_l + t (camera frames)
        return l, R, t
    return None


def _sfm(est, l, R_nl, t_nl):
    """Vision-only window BA (`GlobalSFM::construct`), reusing the LM/Schur
    solver with IMU + prior masked off and frames ℓ, newest pinned (gauge +
    scale). Returns camera poses in the ℓ-camera frame + solved inv depths."""
    nw = est.cfg.window_size
    lay, cfg = est.lay, est.cfg
    # f64 when the runtime has it (SFM conditioning), est.dtype otherwise —
    # requesting f64 under an f32-only runtime just spams truncation warnings
    import jax

    dtype = jnp.float64 if jax.config.x64_enabled else est.dtype
    tbl = est.pt_table

    # initial camera poses: interpolate between identity (ℓ) and (R,t) (newest)
    p_c = np.zeros((nw + 1, 3))
    q_c = np.tile([1.0, 0, 0, 0], (nw + 1, 1))
    q_ln = qnp.rot_to_quat(R_nl.T)  # cam ℓ → cam new ... pose of new in ℓ
    # pose of camera k in ℓ frame: for k=new: R_l_n = R_nl.T, t_l_n = -R_nl.T t_nl
    t_ln = -R_nl.T @ t_nl
    for k in range(nw + 1):
        a = np.clip((k - l) / max(nw - l, 1), 0.0, 1.0) if k >= l else 0.0
        # crude chain initialisation; BA fixes it
        frac_q = np.asarray(_slerp(np.array([1.0, 0, 0, 0]), q_ln, a))
        p_c[k] = a * t_ln
        q_c[k] = frac_q

    # triangulate in ℓ frame with current guesses, then BA
    st = zero_state(cfg, dtype)._replace(
        p=jnp.asarray(p_c), q=jnp.asarray(q_c),
        p_bc=jnp.zeros(3, dtype), q_bc=jnp.asarray([1.0, 0, 0, 0], dtype),
    )
    f = res.empty_factors(cfg, lay, dtype)
    used = tbl.active & (np.sum(tbl.mask, axis=1) >= 2)
    f = f._replace(
        pt_obs=jnp.asarray(tbl.obs, dtype),
        pt_mask=jnp.asarray(tbl.mask.astype(np.float64), dtype),
        pt_start=jnp.asarray(tbl.start),
        pt_valid=jnp.asarray(used.astype(np.float64), dtype),
        imu_valid=jnp.zeros(nw, dtype),
        prior_valid=jnp.zeros((), dtype),
    )
    inv_d, ok = triangulate.triangulate_points(
        st.p, st.q, f.pt_obs, f.pt_mask, f.pt_start
    )
    st = st._replace(inv_depth=jnp.where(jnp.asarray(ok), inv_d, 0.2))
    f = f._replace(pt_valid=f.pt_valid * jnp.asarray(ok, dtype))

    st_out, stats = solver_mod.optimize_window(
        st, f, lay, cfg, num_iters=15, freeze_frames=(l, nw)
    )
    inv_d, ok2 = triangulate.triangulate_points(st_out.p, st_out.q, f.pt_obs, f.pt_mask, f.pt_start)
    st_boot = st_out._replace(inv_depth=jnp.where(jnp.asarray(ok2), inv_d, st_out.inv_depth))
    ok_boot_dev = ok2 & jnp.asarray(used)

    # refinement pass with a cleaner gauge: only frame ℓ pinned (the
    # double-pinned bootstrap bakes the 8-point pose error into the
    # reconstruction shape). Scale is a free gauge direction — LM damping
    # keeps it near the bootstrap value and the VI alignment estimates the
    # metric scale regardless. The refined candidate is only kept if the IMU
    # alignment finds it more consistent (try_initialize scores both).
    st_ref, _ = solver_mod.optimize_window(
        st_boot, f, lay, cfg, num_iters=10, freeze_frames=(l,)
    )
    inv_d, ok3 = triangulate.triangulate_points(st_ref.p, st_ref.q, f.pt_obs, f.pt_mask, f.pt_start)
    st_ref = st_ref._replace(inv_depth=jnp.where(jnp.asarray(ok3), inv_d, st_ref.inv_depth))
    ok_ref_dev = ok3 & jnp.asarray(used)

    # ONE overlapped readback batch for both candidates + the SFM cost
    (p_r, q_r, i_r, okr, p_b, q_b, i_b, okb, cost) = pull_all(
        st_ref.p, st_ref.q, st_ref.inv_depth, ok_ref_dev,
        st_boot.p, st_boot.q, st_boot.inv_depth, ok_boot_dev, stats.cost)
    mean_err = float(cost) / max(1.0, float(np.sum(np.asarray(tbl.mask))))
    cands = [
        (np.asarray(p_r), np.asarray(q_r), np.asarray(i_r), np.asarray(okr)),
        (np.asarray(p_b), np.asarray(q_b), np.asarray(i_b), np.asarray(okb)),
    ]
    return cands, mean_err


def _slerp(q0, q1, a):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -np.asarray(q1), -d
    d = min(d, 1.0)
    th = np.arccos(d)
    if th < 1e-8:
        return q0
    return (np.sin((1 - a) * th) * np.asarray(q0) + np.sin(a * th) * np.asarray(q1)) / np.sin(th)


def _pres_host(est):
    """All interval preintegrations as HOST dicts in ONE overlapped batch of
    readbacks (index k = 1..nw like `est.pres`; None for empty intervals).
    The former per-field np.asarray calls paid a device round trip EACH —
    ~100 per initialization attempt."""
    from plslam.models.estimator import _stack_pres_jit

    nw = est.cfg.window_size
    zero = est._zero_pre()
    pres_dev, valid = [], []
    for k in range(1, nw + 1):
        pre = est.pres[k] if k < len(est.pres) else None
        pres_dev.append(pre if pre is not None else zero)
        valid.append(pre is not None)
    stk = _stack_pres_jit(tuple(pres_dev))
    keys = sorted(stk.keys())
    vals = pull_all(*[stk[k2] for k2 in keys])
    stk_h = {k2: np.asarray(v, np.float64) for k2, v in zip(keys, vals)}
    out = [None]
    for i in range(nw):
        out.append({k2: stk_h[k2][i] for k2 in keys} if valid[i] else None)
    return out


# -------------------------------------------------------------- VI alignment
def _solve_gyro_bias(est, q_bl, pres_h):
    """`solveGyroscopeBias`: LS on preintegrated vs visual rotation deltas."""
    nw = est.cfg.window_size
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for k in range(nw):
        pre = pres_h[k + 1]
        if pre is None:
            continue
        q_ij = qnp.quat_mul(qnp.quat_conj(q_bl[k]), q_bl[k + 1])
        dq = qnp.quat_mul(qnp.quat_conj(pre["gamma"]), q_ij)
        if dq[0] < 0:
            dq = -dq
        J = pre["jac"][3:6, 12:15]
        r = 2.0 * dq[1:4]
        A += J.T @ J
        b += J.T @ r
    if np.linalg.det(A) < 1e-12:
        return np.zeros(3)
    return np.linalg.solve(A, b)


def _linear_alignment(est, p_cl, q_bl, pres_h):
    """`LinearAlignment`: solve velocities (body frames), gravity in ℓ-cam
    frame, and metric scale from the preintegrated deltas."""
    nw = est.cfg.window_size
    n_state = (nw + 1) * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)  # [nw+1,3,3] R_cl_bk

    for k in range(nw):
        pre = pres_h[k + 1]
        if pre is None:
            return None
        dt = float(pre["dt_sum"])
        Ri = R_bl[k]
        Rj = R_bl[k + 1]
        tmp_A = np.zeros((6, 10))
        tmp_b = np.zeros(6)
        tmp_A[0:3, 0:3] = -dt * np.eye(3)
        tmp_A[0:3, 6:9] = 0.5 * Ri.T @ np.eye(3) * dt * dt
        tmp_A[0:3, 9] = Ri.T @ (p_cl[k + 1] - p_cl[k]) / 100.0
        tmp_b[0:3] = pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc
        tmp_A[3:6, 0:3] = -np.eye(3)
        tmp_A[3:6, 3:6] = Ri.T @ Rj
        tmp_A[3:6, 6:9] = Ri.T * dt
        tmp_b[3:6] = pre["beta"]

        # scatter into the big system
        idx = np.concatenate([np.arange(k * 3, k * 3 + 6), np.arange((nw + 1) * 3, n_state)])
        AtA = tmp_A.T @ tmp_A
        Atb = tmp_A.T @ tmp_b
        A[np.ix_(idx, idx)] += AtA
        b[idx] += Atb

    A *= 1000.0
    b *= 1000.0
    x = np.linalg.solve(A, b)
    s = x[-1] / 100.0
    g = x[(nw + 1) * 3 : (nw + 1) * 3 + 3]
    if s < 1e-4 or abs(np.linalg.norm(g) - est.config.imu.g_norm) > 1.5:
        return None
    vels = x[: (nw + 1) * 3].reshape(nw + 1, 3)
    g, s, vels = _refine_gravity(est, p_cl, q_bl, g, pres_h)
    if s is None:
        return None
    return g, s, vels


def _refine_gravity(est, p_cl, q_bl, g0, pres_h):
    """`RefineGravity`: 2-DoF tangent refinement with ‖g‖ fixed to G."""
    nw = est.cfg.window_size
    gn = est.config.imu.g_norm
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)
    g = g0 / np.linalg.norm(g0) * gn
    vels = None
    s = None
    for _ in range(4):
        # tangent basis of the gravity sphere
        a = g / np.linalg.norm(g)
        tmp = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        b1 = np.cross(a, tmp)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(a, b1)
        basis = np.stack([b1, b2], axis=1)  # [3,2]

        n_state = (nw + 1) * 3 + 2 + 1
        A = np.zeros((n_state, n_state))
        bb = np.zeros(n_state)
        for k in range(nw):
            pre = pres_h[k + 1]
            dt = float(pre["dt_sum"])
            Ri, Rj = R_bl[k], R_bl[k + 1]
            tmp_A = np.zeros((6, 9))
            tmp_b = np.zeros(6)
            tmp_A[0:3, 0:3] = -dt * np.eye(3)
            tmp_A[0:3, 6:8] = 0.5 * Ri.T @ basis * dt * dt
            tmp_A[0:3, 8] = Ri.T @ (p_cl[k + 1] - p_cl[k]) / 100.0
            tmp_b[0:3] = pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc - 0.5 * Ri.T @ g * dt * dt
            tmp_A[3:6, 0:3] = -np.eye(3)
            tmp_A[3:6, 3:6] = Ri.T @ Rj
            tmp_A[3:6, 6:8] = Ri.T @ basis * dt
            tmp_b[3:6] = pre["beta"] - Ri.T @ g * dt

            idx = np.concatenate([np.arange(k * 3, k * 3 + 6), np.arange((nw + 1) * 3, n_state)])
            A[np.ix_(idx, idx)] += tmp_A.T @ tmp_A
            bb[idx] += tmp_A.T @ tmp_b
        A *= 1000.0
        bb *= 1000.0
        x = np.linalg.solve(A, bb)
        dg = basis @ x[(nw + 1) * 3 : (nw + 1) * 3 + 2]
        g = (g + dg) / np.linalg.norm(g + dg) * gn
        s = x[-1] / 100.0
        vels = x[: (nw + 1) * 3].reshape(nw + 1, 3)
    if s is None or s < 1e-4:
        return None, None, None
    return g, s, vels


# ----------------------------------------------------- extrinsic calibration
@highest_matmul_precision
def calibrate_extrinsic_rotation(q_cam_deltas, q_imu_deltas):
    """`InitialEXRotation::CalibrationExRotation` (SURVEY.md §2.3): hand-eye
    quaternion least squares for R_bc from paired camera/IMU rotation deltas.

    Solves  q_imu_k ⊗ q_bc = q_bc ⊗ q_cam_k  for all k via the stacked
    4×4 [L(q_imu) − R(q_cam)] system; smallest singular vector = q_bc.
    Returns (q_bc [wxyz], ok) — ok when the second-smallest singular value is
    well separated (enough rotational excitation)."""
    rows = []
    for qi, qc in zip(q_imu_deltas, q_cam_deltas):
        w, x, y, z = [float(v) for v in qi]
        L = np.array([
            [w, -x, -y, -z],
            [x, w, -z, y],
            [y, z, w, -x],
            [z, -y, x, w],
        ])
        w, x, y, z = [float(v) for v in qc]
        R = np.array([
            [w, -x, -y, -z],
            [x, w, z, -y],
            [y, -z, w, x],
            [z, y, -x, w],
        ])
        rows.append(L - R)
    A = np.concatenate(rows, axis=0)
    _, S, Vt = np.linalg.svd(A)
    q = Vt[-1]
    if q[0] < 0:
        q = -q
    ok = len(q_imu_deltas) >= 8 and S[-2] > 0.25
    return q / np.linalg.norm(q), bool(ok)


def _alignment_residual(est, p_cl, q_bl, g, s, vels, pres_h):
    """Mean squared residual of the linear-alignment equations at the solved
    (g, s, velocities) — a measurable SFM↔IMU consistency score used to pick
    between reconstruction candidates."""
    nw = est.cfg.window_size
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)
    total = 0.0
    n = 0
    for k in range(nw):
        pre = pres_h[k + 1]
        if pre is None:
            return np.inf
        dt = float(pre["dt_sum"])
        Ri, Rj = R_bl[k], R_bl[k + 1]
        r_p = (pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc
               - Ri.T @ (s * (p_cl[k + 1] - p_cl[k])) + vels[k] * dt
               - 0.5 * Ri.T @ g * dt * dt)
        r_v = (pre["beta"] - Ri.T @ Rj @ vels[k + 1] + vels[k]
               - Ri.T @ g * dt)
        total += float(r_p @ r_p + r_v @ r_v)
        n += 6
    return total / max(n, 1)


# ----------------------------------------------------------------- top level
@highest_matmul_precision
def try_initialize(est) -> bool:
    """`initialStructure()` + `visualInitialAlign()`."""
    nw = est.cfg.window_size

    # IMU excitation check (variance of acceleration over the window)
    accs = []
    for k in range(1, nw + 1):
        buf = est.imu_bufs[k] if k < len(est.imu_bufs) else None
        if buf is not None and buf.seeded:
            accs.extend(buf.acc)
    if len(accs) > 10:
        g_var = np.var(np.linalg.norm(np.stack(accs), axis=1))
        if g_var < 0.06:
            # the reference logs "IMU excitation not enough!" but proceeds
            # (the gate is commented out in the lineage) — alignment's own
            # scale/gravity sanity checks do the actual rejection
            pass

    rel = _relative_pose(est)
    if rel is None:
        return False
    l, R_nl, t_nl = rel

    cands, mean_err = _sfm(est, l, R_nl, t_nl)
    if mean_err > 10.0:
        return False

    p_bc = np.asarray(est.p_bc, np.float64)
    q_cb = qnp.quat_conj(est.q_bc)

    # Score each SFM candidate (refined gauge first, double-pinned bootstrap
    # second) by how consistently the IMU alignment explains it. The bootstrap
    # is the conservative default: the refined gauge only wins with a
    # decisively better score (it helps near-exact geometry; on noisy imagery
    # its freed gauge can fit feature noise that the score barely sees).
    PREFER_REFINED_FACTOR = 0.3
    pres0 = list(est.pres)  # zero-bias preintegrations (gyro solve is relative)
    best = None
    pres0_h = _pres_host(est)  # zero-bias preintegrations, one pull batch
    for ci, (p_c, q_c, inv_depth, pt_ok) in enumerate(cands):
        est.pres = list(pres0)
        # body poses in the ℓ-camera frame: T_cl_bk = T_cl_ck ∘ (T_b_c)⁻¹
        q_bl = qnp.quat_mul(q_c, q_cb[None, :])
        p_bl = p_c + qnp.quat_rotate(q_bl, np.broadcast_to(-p_bc, (nw + 1, 3)))

        # gyro bias + repropagate
        bg = _solve_gyro_bias(est, q_bl, pres0_h)
        if np.linalg.norm(bg) > 1.0:
            continue
        for k in range(1, nw + 1):
            buf = est.imu_bufs[k]
            if buf.seeded and len(buf.dt) > 0:
                acc, gyr, dts = buf.padded(est.dtype)
                from plslam.models.estimator import _preintegrate_padded

                est.pres[k] = _preintegrate_padded(
                    acc, gyr, dts, jnp.zeros(3, est.dtype), jnp.asarray(bg, est.dtype), est.noise
                )
        pres_h = _pres_host(est)  # repropagated, one pull batch

        out = _linear_alignment(est, p_c, q_bl, pres_h)
        if out is None:
            continue
        g_cl_c, s_c, vels_c = out
        if np.median(np.linalg.norm(vels_c, axis=1)) > MAX_INIT_VELOCITY:
            continue  # implausible metric scale — see MAX_INIT_VELOCITY
        score = _alignment_residual(est, p_c, q_bl, g_cl_c, s_c, vels_c, pres_h)
        if ci == 0:
            score = score / PREFER_REFINED_FACTOR  # refined must win decisively
        if best is None or score < best[0]:
            best = (score, p_c, q_c, inv_depth, pt_ok, q_bl, p_bl, bg, g_cl_c, s_c, vels_c)

    if best is None:
        return False
    _, p_c, q_c, inv_depth, pt_ok, q_bl, p_bl, bg, g_cl, s, vels_body = best
    est.bg[:] = bg
    # leave preintegrations repropagated with the winning bg
    for k in range(1, nw + 1):
        buf = est.imu_bufs[k]
        if buf.seeded and len(buf.dt) > 0:
            acc, gyr, dts = buf.padded(est.dtype)
            from plslam.models.estimator import _preintegrate_padded

            est.pres[k] = _preintegrate_padded(
                acc, gyr, dts, jnp.zeros(3, est.dtype), jnp.asarray(bg, est.dtype), est.noise
            )

    # ---- visualInitialAlign: rescale + rotate world to gravity-aligned frame
    p_m = s * p_bl  # metric body positions in the ℓ-camera frame
    p_m = p_m - p_m[0]
    R0 = np.asarray(gravity_to_rot(jnp.asarray(g_cl)))  # once per successful init
    # zero the yaw of the first body frame in the new world
    R_b0 = qnp.quat_to_rot(q_bl[0])
    yaw0 = float(qnp.rot_to_ypr(R0 @ R_b0)[0])
    Rz = qnp.ypr_to_rot(np.array([-yaw0, 0.0, 0.0]))
    R0 = Rz @ R0

    for k in range(nw + 1):
        est.p[k] = R0 @ p_m[k]
        R_bk = qnp.quat_to_rot(q_bl[k])
        est.q[k] = qnp.rot_to_quat(R0 @ R_bk)
        est.v[k] = R0 @ (R_bk @ vels_body[k])
        est.ba[k] = 0.0
        est.bg[k] = bg

    # depth scale: inverse depths scale by 1/s
    tbl = est.pt_table
    tbl.inv_depth[:] = -1.0
    solved = pt_ok & (inv_depth > 0)
    tbl.inv_depth[solved] = inv_depth[solved] / s
    est.ln_table.solved[:] = False  # lines re-triangulate in the metric frame

    return True
