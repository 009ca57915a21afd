"""Loop closure + 4-DoF pose-graph optimization + drift correction.

JAX equivalent of the reference's `pose_graph/src/pose_graph.cpp`
(`PoseGraph::addKeyFrame`, `detectLoop`, `optimize4DoF` with
`FourDOFError`/`FourDOFWeightError` + `AngleLocalParameterization`,
drift composition, `savePoseGraph`/`loadPoseGraph`) and
`KeyFrame::findConnection` — SURVEY.md §2.4 / §3.4 / §A.7.

The Ceres problem over per-keyframe (x, y, z, yaw) — pitch/roll frozen from
VIO (observable) — becomes a batched GN over a fixed-capacity [K,4] state:
per-edge residuals/jacobians evaluate in one vmap, scatter-add into a dense
(4K)² Hessian (K ≤ capacity, masked), damped-Cholesky solve, few iterations.
Sequential edges connect each keyframe to up to 5 predecessors (weight 1);
loop edges are Huber-weighted (IRLS). Yaw wrap-around is handled in the
residual (the reference's AngleLocalParameterization).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.utils.device import asdev
from plslam.config import LoopConfig
from plslam.models import keyframe_db as kdb
from plslam.ops import cameras as kdb_cams
from plslam.utils import quat_np as qnp
from plslam.utils.geometry import quat_mul, quat_rotate, quat_to_rot, rot_to_quat, rot_to_ypr, ypr_to_rot
from plslam.utils.device import highest_matmul_precision

MAX_EDGES_SEQ = 5
# Above this keyframe capacity the dense (4K)² PGO Hessian gives way to the
# matrix-free PCG solver. Dense at 2048 KF is a 268 MB Hessian; PCG runs
# 12×96 SEQUENTIAL small matvecs for the same graph (latency-bound). Where
# the two cross on the GPU is not measured; the threshold keeps dense far
# past the default 2048 capacity, PCG only where the Hessian stops fitting.
_PCG_THRESHOLD = 6144


def _rot_ypr(yaw, pitch, roll):
    return ypr_to_rot(jnp.stack([yaw, pitch, roll], axis=-1))


def _rot_ypr_np(yaw, pitch=0.0, roll=0.0):
    """Host-path Rz(y)Ry(p)Rx(r) — the pose graph's bookkeeping runs per
    keyframe on the host; routing it through jnp would cost a device
    dispatch per call."""
    return qnp.ypr_to_rot(np.stack([np.asarray(yaw, np.float64),
                                    np.asarray(pitch, np.float64),
                                    np.asarray(roll, np.float64)], axis=-1))


def _wrap(a):
    return (a + jnp.pi) % (2 * jnp.pi) - jnp.pi


def _make_edge_system(xyz_shape_dtype, pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop, yaw_scale=0.1):
    """Shared per-edge residual/jacobian machinery of the 4-DoF PGO.

    Returns (all_residuals(xyz, yaw) -> [E,4],
             edge_system(xyz, yaw) -> (r, Jk) with Huber IRLS applied)."""
    dtype = xyz_shape_dtype

    def edge_residual_local(xi, yi, xj, yj, k):
        """Residual from the GATHERED endpoint states — differentiating wrt
        these 8 local dims keeps the per-edge jacfwd free of K-sized
        intermediates (perturbing a scatter into the full [K] state can make
        XLA materialize an [E,K,3,8] tensor — 43 GB at the 2048-KF
        capacity; XLA:CPU happens to optimize it away, hiding it)."""
        Ri = _rot_ypr(yi, pitch[e_i[k]], roll[e_i[k]])
        r_t = Ri.T @ (xj - xi) - e_t[k]
        r_y = _wrap(yj - yi - e_yaw[k]) * (1.0 / yaw_scale)
        return jnp.concatenate([r_t, r_y[None]]) * e_w[k] * e_valid[k]

    def edge_residual(xyz, yaw, k):
        return edge_residual_local(xyz[e_i[k]], yaw[e_i[k]], xyz[e_j[k]], yaw[e_j[k]], k)

    def all_residuals(xyz, yaw):
        return jax.vmap(lambda k: edge_residual(xyz, yaw, k))(jnp.arange(e_i.shape[0]))

    def edge_system(xyz, yaw):
        # per-edge jacobians wrt (xyz_i, yaw_i, xyz_j, yaw_j) via jacfwd
        def r_of(k, d):
            return edge_residual_local(
                xyz[e_i[k]] + d[0:3], yaw[e_i[k]] + d[3],
                xyz[e_j[k]] + d[4:7], yaw[e_j[k]] + d[7], k)

        zero8 = jnp.zeros((8,), dtype)
        r = all_residuals(xyz, yaw)  # [E,4]
        Jk = jax.vmap(lambda k: jax.jacfwd(lambda d: r_of(k, d))(zero8))(jnp.arange(e_i.shape[0]))  # [E,4,8]

        # Huber IRLS on loop edges
        rn2 = jnp.sum(r * r, axis=-1)
        hub = jnp.where(rn2 > 1.0, 1.0 / jnp.sqrt(jnp.sqrt(rn2)), 1.0)
        w = jnp.where(e_loop > 0, hub, 1.0)
        return r * w[:, None], Jk * w[:, None, None], w

    return all_residuals, edge_system


@partial(jax.jit, static_argnames=("iters",))
@highest_matmul_precision
def optimize_4dof(
    xyz0, yaw0, pitch, roll, node_valid,
    e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop,
    iters: int = 12,
):
    """Batched GN over [K,4]: positions + yaw (dense normal equations — the
    small-graph path; `optimize_4dof_pcg` is the large-capacity path).

    Edges: r_t = R(ψᵢ,θᵢ,φᵢ)ᵀ(p_j − p_i) − t̂ᵢⱼ ;  r_ψ = wrap(ψⱼ − ψᵢ − Δψ̂).
    First valid node fixed (gauge). Returns (xyz [K,3], yaw [K])."""
    K = xyz0.shape[0]
    dtype = xyz0.dtype

    first = jnp.argmax(node_valid)  # first valid keyframe is the gauge anchor
    free = node_valid.at[first].set(0.0)
    all_residuals, edge_system = _make_edge_system(
        dtype, pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop)

    def gn_step(carry, _):
        xyz, yaw, lam = carry
        r, Jk, w = edge_system(xyz, yaw)

        # scatter-add into dense H [4K,4K], b [4K]
        H = jnp.zeros((4 * K, 4 * K), dtype)
        b = jnp.zeros((4 * K,), dtype)
        Ji = Jk[:, :, 0:4]
        Jj = Jk[:, :, 4:8]
        Hii = jnp.einsum("era,erb->eab", Ji, Ji)
        Hjj = jnp.einsum("era,erb->eab", Jj, Jj)
        Hij = jnp.einsum("era,erb->eab", Ji, Jj)
        bi = jnp.einsum("era,er->ea", Ji, r)
        bj = jnp.einsum("era,er->ea", Jj, r)

        def scatter(H, b, idx, blk_d, blk_b):
            rows = (idx[:, None] * 4 + jnp.arange(4)[None, :]).reshape(-1)
            return H, b, rows

        ri = (e_i[:, None] * 4 + jnp.arange(4)[None, :])  # [E,4]
        rj = (e_j[:, None] * 4 + jnp.arange(4)[None, :])
        H = H.at[ri[:, :, None], ri[:, None, :]].add(Hii)
        H = H.at[rj[:, :, None], rj[:, None, :]].add(Hjj)
        H = H.at[ri[:, :, None], rj[:, None, :]].add(Hij)
        H = H.at[rj[:, :, None], ri[:, None, :]].add(jnp.swapaxes(Hij, 1, 2))
        b = b.at[ri].add(bi)
        b = b.at[rj].add(bj)

        # free mask: invalid nodes + gauge anchor pinned
        fm = jnp.repeat(free, 4)
        dH = jnp.diag(H)
        sc = fm / jnp.sqrt(jnp.maximum(dH, 1e-6))
        Hs = H * sc[:, None] * sc[None, :] + jnp.diag(1.0 - fm + lam)
        bs = b * sc
        delta = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hs), bs) * sc

        xyz_new = xyz + delta.reshape(K, 4)[:, 0:3]
        yaw_new = yaw + delta.reshape(K, 4)[:, 3]
        cost0 = jnp.sum(r * r)
        r_new = all_residuals(xyz_new, yaw_new) * w[:, None]
        cost1 = jnp.sum(r_new * r_new)
        accept = cost1 < cost0
        xyz = jnp.where(accept, xyz_new, xyz)
        yaw = jnp.where(accept, yaw_new, yaw)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-8), jnp.minimum(lam * 8.0, 1e2))
        return (xyz, yaw, lam), cost1

    (xyz, yaw, _), costs = jax.lax.scan(gn_step, (xyz0, yaw0, jnp.asarray(1e-4, dtype)), None, length=iters)
    return xyz, yaw, costs


@partial(jax.jit, static_argnames=("iters", "cg_iters"))
@highest_matmul_precision
def optimize_4dof_pcg(
    xyz0, yaw0, pitch, roll, node_valid,
    e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop,
    iters: int = 12, cg_iters: int = 96,
):
    """Large-capacity 4-DoF PGO: GN with a matrix-free PCG inner solve.

    The dense path materializes a (4K)² Hessian — 268 MB at the default
    K=2048 capacity, with an O(K³) Cholesky. Here the Hessian is only ever
    applied edge-wise (two scatter-adds per matvec, O(E) memory), and PCG is
    preconditioned by the BLOCK-TRIDIAGONAL backbone of the graph — the
    1-step sequential edges that dominate a pose graph — factored by a
    block-Thomas `lax.scan`. Loop edges + longer sequential edges are a
    low-rank/short-range perturbation of that backbone, so PCG converges in
    tens of iterations regardless of K. Memory: O(K·4² + E·4·8).

    Same semantics as `optimize_4dof` (gauge pinning, Huber IRLS on loop
    edges, LM damping with accept/reject); returns (xyz [K,3], yaw [K], costs).
    """
    K = xyz0.shape[0]
    dtype = xyz0.dtype
    first = jnp.argmax(node_valid)
    free = node_valid.at[first].set(0.0)  # [K] 1 = free
    fm = jnp.broadcast_to(free[:, None], (K, 4))  # [K,4]
    all_residuals, edge_system = _make_edge_system(
        dtype, pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop)
    eye4 = jnp.eye(4, dtype=dtype)

    def gn_step(carry, _):
        xyz, yaw, lam = carry
        r, Jk, w = edge_system(xyz, yaw)
        Ji = Jk[:, :, 0:4]  # [E,4,4]
        Jj = Jk[:, :, 4:8]

        # gradient b = Jᵀ r, masked
        b = jnp.zeros((K, 4), dtype)
        b = b.at[e_i].add(jnp.einsum("era,er->ea", Ji, r))
        b = b.at[e_j].add(jnp.einsum("era,er->ea", Jj, r))
        b = b * fm

        # diagonal blocks D [K,4,4] and tridiagonal off-blocks O [K,4,4]
        # (O[k] couples k → k+1; only 1-step edges land there, the rest is
        # left to CG)
        D = jnp.zeros((K, 4, 4), dtype)
        D = D.at[e_i].add(jnp.einsum("era,erb->eab", Ji, Ji))
        D = D.at[e_j].add(jnp.einsum("era,erb->eab", Jj, Jj))
        one_step = (e_j == e_i + 1)
        Oij = jnp.einsum("era,erb->eab", Ji, Jj) * one_step[:, None, None]
        O = jnp.zeros((K, 4, 4), dtype).at[e_i].add(Oij)

        # masking + LM damping (H + λ·diag(H) on free dims, identity on pinned)
        fi = fm[:, :, None] * fm[:, None, :]
        diagD = jnp.einsum("kaa->ka", D)
        damp = lam * diagD * fm
        D = D * fi + jnp.einsum("ka,ab->kab", 1.0 - fm, eye4)
        D = D + jnp.einsum("ka,ab->kab", damp, eye4)
        fO = free[:, None, None] * jnp.roll(free, -1)[:, None, None]
        O = O * fO  # zero off-blocks touching pinned nodes
        O = O.at[K - 1].set(jnp.zeros((4, 4), dtype))  # no k=K-1 → K block

        # implicit masked+damped Hessian matvec
        def hvp(v):
            vm = v * fm
            ye = jnp.einsum("era,ea->er", Ji, vm[e_i]) + jnp.einsum("era,ea->er", Jj, vm[e_j])
            out = jnp.zeros((K, 4), dtype)
            out = out.at[e_i].add(jnp.einsum("era,er->ea", Ji, ye))
            out = out.at[e_j].add(jnp.einsum("era,er->ea", Jj, ye))
            return out * fm + (1.0 - fm) * v + damp * v

        # block-Thomas factorization of the tridiagonal preconditioner:
        # S_0 = D_0, S_k = D_k − O_{k−1}ᵀ S_{k−1}⁻¹ O_{k−1}
        def fact_step(S_prev_inv_O, Dk_Okm1):
            Dk, Okm1 = Dk_Okm1
            Sk = Dk - Okm1.T @ S_prev_inv_O
            Sk_inv = jnp.linalg.inv(Sk + 1e-10 * eye4)
            return Sk_inv @ jnp.zeros((4, 4), dtype), (Sk_inv, Okm1)

        O_prev = jnp.concatenate([jnp.zeros((1, 4, 4), dtype), O[:-1]], axis=0)

        def fact_scan(carry, inp):
            S_prev_inv = carry
            Dk, Okm1 = inp
            Sk = Dk - Okm1.T @ (S_prev_inv @ Okm1)
            Sk_inv = jnp.linalg.inv(Sk + 1e-9 * eye4)
            return Sk_inv, Sk_inv

        _, S_inv = jax.lax.scan(fact_scan, jnp.zeros((4, 4), dtype), (D, O_prev))

        def msolve(v):
            # forward: w_k = v_k − O_{k−1}ᵀ S_{k−1}⁻¹ w_{k−1}
            def fwd(carry, inp):
                w_prev_solved = carry  # S_{k−1}⁻¹ w_{k−1}
                vk, Okm1, Sk_inv = inp
                wk = vk - Okm1.T @ w_prev_solved
                return Sk_inv @ wk, wk

            _, wseq = jax.lax.scan(fwd, jnp.zeros((4,), dtype), (v, O_prev, S_inv))
            # backward: z_k = S_k⁻¹ (w_k − O_k z_{k+1})
            def bwd(carry, inp):
                z_next = carry
                wk, Ok, Sk_inv = inp
                zk = Sk_inv @ (wk - Ok @ z_next)
                return zk, zk

            _, zrev = jax.lax.scan(bwd, jnp.zeros((4,), dtype),
                                   (wseq[::-1], O[::-1], S_inv[::-1]))
            return zrev[::-1]

        # PCG for H δ = −b
        def cg_body(carry, _):
            x, rr, p, rz = carry
            hp = hvp(p)
            alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
            x = x + alpha * p
            rr = rr - alpha * hp
            z = msolve(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, rr, p, rz_new), rz_new

        r0 = -b
        z0 = msolve(r0)
        (delta, _, _, _), _ = jax.lax.scan(
            cg_body, (jnp.zeros((K, 4), dtype), r0, z0, jnp.sum(r0 * z0)),
            None, length=cg_iters)

        xyz_new = xyz + delta[:, 0:3]
        yaw_new = yaw + delta[:, 3]
        cost0 = jnp.sum(r * r)
        r_new = all_residuals(xyz_new, yaw_new) * w[:, None]
        cost1 = jnp.sum(r_new * r_new)
        accept = cost1 < cost0
        xyz = jnp.where(accept, xyz_new, xyz)
        yaw = jnp.where(accept, yaw_new, yaw)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-8), jnp.minimum(lam * 8.0, 1e2))
        return (xyz, yaw, lam), cost1

    (xyz, yaw, _), costs = jax.lax.scan(
        gn_step, (xyz0, yaw0, jnp.asarray(1e-4, dtype)), None, length=iters)
    return xyz, yaw, costs


class PoseGraph:
    """Host orchestration: keyframe insertion, loop detection, PGO trigger,
    drift composition (`PoseGraph` class equivalent)."""

    def __init__(self, cfg: LoopConfig, focal=460.0, R_bc=None, p_bc=None):
        self.cfg = cfg
        self.db = kdb.KeyframeDB(cfg.max_keyframes)
        # body_T_cam extrinsic (x_b = R_bc x_c + p_bc): PnP recovers a CAMERA
        # pose; loop edges are between BODY poses, so the extrinsic must be
        # composed (the reference's qic/tic in KeyFrame::findConnection)
        self.R_bc = np.eye(3) if R_bc is None else np.asarray(R_bc, np.float64).reshape(3, 3)
        self.p_bc = np.zeros(3) if p_bc is None else np.asarray(p_bc, np.float64)
        K = cfg.max_keyframes
        self.vio_p = np.zeros((K, 3))
        self.vio_q = np.zeros((K, 4))
        self.vio_yaw = np.zeros(K)
        self.opt_p = np.zeros((K, 3))
        self.opt_yaw = np.zeros(K)
        self.pitch = np.zeros(K)
        self.roll = np.zeros(K)
        self.t_kf = np.zeros(K)
        self.n = 0
        self.edges = []  # dicts: i, j, t, yaw, w, loop
        self.r_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.yaw_drift = 0.0
        self.loop_count = 0
        self.evict_fallbacks = 0  # capacity evictions refused (misaligned DB)
        self._pending_opt = False
        self.last_match = None  # match_points payload for the estimator
        self.stats = []  # per-candidate diagnostics (findConnection outcome)
        self.base_n = 0  # keyframes [0, base_n) came from a loaded map
        self.keep_images = False  # store per-KF images (match_image viz)

    # ------------------------------------------------------------- keyframes
    def add_keyframe(self, t, p_w, q_w, img=None, win_uv=None, win_pts3d=None, cam=None,
                     win_ids=None):
        """`addKeyFrame(cur_kf, detect_loop=1)`. p/q: VIO body pose (world).
        img: grayscale float image for BRIEF (optional → loop detection off).
        win_uv/win_pts3d/win_ids: the estimator's window points at this
        keyframe — pixel coords, world 3D, global feature ids (the
        `computeWindowBRIEFPoint` inputs; ids flow back via match_points)."""
        if self.n >= self.cfg.max_keyframes:
            # capacity policy: the reference's keyframe list is unbounded;
            # at our fixed capacity, downsample old non-loop keyframes
            # instead of silently dropping new ones
            if not self._evict_for_capacity():
                return None
        k = self.n
        self.vio_p[k] = p_w
        self.vio_q[k] = q_w
        ypr = qnp.rot_to_ypr(qnp.quat_to_rot(np.asarray(q_w, np.float64)))
        self.vio_yaw[k] = ypr[0]
        self.pitch[k] = ypr[1]
        self.roll[k] = ypr[2]
        # new nodes enter the optimization in the DRIFT-CORRECTED frame so
        # they are consistent with already-optimized predecessors (the
        # reference initializes new keyframes through r_drift/t_drift)
        self.opt_yaw[k] = ypr[0] + self.yaw_drift
        self.opt_p[k] = self.r_drift @ np.asarray(p_w, np.float64) + self.t_drift
        self.t_kf[k] = t
        self.n += 1

        # sequential edges to up to 5 predecessors (FourDOFError, weight 1),
        # measured EXCLUSIVELY from VIO poses — never from opt_* state, which
        # PGO/fast_relocalize rewrite (mixing frames would encode the applied
        # correction as a biased measurement on every later edge — §A.7);
        # never bridge the loaded-map → new-session discontinuity (the VIO
        # relative pose across it is meaningless — reference sequence semantics)
        for back in range(1, MAX_EDGES_SEQ + 1):
            i = k - back
            if i < self.base_n:
                break
            Ri = _rot_ypr_np(self.vio_yaw[i], self.pitch[i], self.roll[i])
            rel_t = Ri.T @ (self.vio_p[k] - self.vio_p[i])
            rel_yaw = self.vio_yaw[k] - self.vio_yaw[i]
            self.edges.append(dict(i=i, j=k, t=rel_t, yaw=rel_yaw, w=1.0 if back == 1 else 0.6, loop=0))

        loop = None
        self.last_match = None
        if img is not None:
            img_j = jnp.asarray(img, jnp.float32)
            # the keyframe's searchable corner set includes its OWN window
            # points (the reference's computeWindowBRIEFPoint +
            # computeBRIEFPoint union): a later revisit's window points — also
            # tracked feature centers — then have geometrically consistent
            # counterparts to match into
            # cap the window-point payload at the fixed BRIEF slot budget so
            # every device call below has ONE compiled shape
            nmax = kdb.MAX_KP // 2
            if win_uv is not None and len(win_uv) > nmax:
                win_uv = win_uv[:nmax]
                win_ids = win_ids[:nmax] if win_ids is not None else None
                win_pts3d = win_pts3d[:nmax] if win_pts3d is not None else None
            uv, valid, desc, gdesc = kdb.extract_keyframe_features(img_j, extra_uv=win_uv)
            # window-point descriptors (`computeWindowBRIEFPoint`)
            win_desc = None
            if win_uv is not None and len(win_uv):
                cnt = len(win_uv)
                buf = np.zeros((nmax, 2), np.float32)
                buf[:cnt] = np.asarray(win_uv, np.float32)
                wv = np.zeros((nmax,), np.float32)
                wv[:cnt] = 1.0
                win_desc, _ = kdb.brief_descriptors(img_j, jnp.asarray(buf), jnp.asarray(wv))
                win_desc = np.asarray(win_desc)[:cnt]
            entry = dict(uv=uv, valid=valid, desc=desc, cam=cam,
                         win_uv=win_uv, win_ids=win_ids, win_pts3d=win_pts3d,
                         win_desc=win_desc, img_shape=img.shape,
                         img=np.asarray(img, np.float32) if self.keep_images else None)
            old = self.db.query(gdesc, exclude_last=self.cfg.min_loop_gap,
                                min_score=getattr(self.cfg, "loop_min_score", 0.15),
                                always_include=self.base_n,
                                consistency=self.cfg.loop_consistency,
                                consistency_gap=self.cfg.consistency_gap)
            self.db.add(entry, gdesc)
            if old is not None:
                # geometric disambiguation over the strong candidates (best
                # cosine first): under perceptual aliasing the top candidate
                # can be the WRONG room — BRIEF+PnP verification picks the
                # true one (db.query docstring; per-candidate outcomes land
                # in self.stats)
                for cand in (getattr(self.db, "last_candidates", None) or [old]):
                    loop = self._find_connection(cand, k, entry)
                    if loop is not None:
                        break
                if loop is not None:
                    self.edges.append(loop)
                    self.loop_count += 1
                    self._pending_opt = True
        return loop

    def _evict_for_capacity(self) -> bool:
        """Downsample the graph when full: evict every other OLD keyframe
        that is not part of the loaded map, not a loop-edge endpoint, not the
        gauge anchor, and not in the newest quarter; remap indices; keep loop
        edges and REBUILD all sequential edges from the stored VIO poses
        (sequential measurements are pure functions of VIO state, so the
        composition across evicted nodes is exact — §A.7). Returns False when
        nothing is evictable (graph saturated with loop/map nodes)."""
        n = self.n
        loop_nodes = set()
        for e in self.edges:
            if e["loop"]:
                loop_nodes.add(e["i"])
                loop_nodes.add(e["j"])
        protect_from = max(self.base_n, n - max(n // 4, 1))
        evict = set(
            k for k in range(max(self.base_n, 1), protect_from) if k not in loop_nodes
        )
        evict = set(sorted(evict)[::2])  # every other evictable
        if not evict:
            return False
        # a db misaligned with the keyframe list (some keyframes added without
        # imagery while others had it) cannot be remapped safely — keep the
        # old drop-new behavior there, but LOUDLY: silent loss of loop
        # closure at capacity is a debugging trap (VERDICT r3 weak #5/#6)
        if self.db.n not in (0, n):
            import warnings

            self.evict_fallbacks += 1
            warnings.warn(
                f"pose graph at capacity with a misaligned keyframe DB "
                f"(db.n={self.db.n} != n={n}): cannot evict safely — new "
                f"keyframes are DROPPED and loop closure degrades. Add "
                f"keyframes uniformly with or without imagery.",
                RuntimeWarning, stacklevel=3)
            return False
        keep = [k for k in range(n) if k not in evict]
        remap = {old: new for new, old in enumerate(keep)}
        for name in ("vio_p", "vio_q", "vio_yaw", "opt_p", "opt_yaw",
                     "pitch", "roll", "t_kf"):
            arr = getattr(self, name)
            arr[: len(keep)] = arr[keep]
        if self.db.n == n:
            self.db.gdescs[: len(keep)] = self.db.gdescs[keep]
            self.db.entries = [self.db.entries[k] for k in keep]
            self.db.n = len(keep)
            self.db.recent = []  # candidate indices shifted; restart the chain
        self.n = len(keep)
        # preserve loop edges AND loaded-map-internal sequential edges: the
        # rebuild loop below only regenerates sequential edges for i >= base_n,
        # so discarding map-internal ones would leave loaded-map nodes (which
        # are never gauge-pinned) edge-free/unconstrained after eviction
        new_edges = [
            {**e, "i": remap[e["i"]], "j": remap[e["j"]]}
            for e in self.edges
            if e["loop"] or (e["i"] < self.base_n and e["j"] < self.base_n)
        ]
        for k in range(1, self.n):
            for back in range(1, MAX_EDGES_SEQ + 1):
                i = k - back
                if i < self.base_n:
                    break
                Ri = _rot_ypr_np(self.vio_yaw[i], self.pitch[i], self.roll[i])
                rel_t = Ri.T @ (self.vio_p[k] - self.vio_p[i])
                rel_yaw = self.vio_yaw[k] - self.vio_yaw[i]
                new_edges.append(dict(i=i, j=k, t=rel_t, yaw=rel_yaw,
                                      w=1.0 if back == 1 else 0.6, loop=0))
        self.edges = new_edges
        return True

    def _find_connection(self, old_idx, cur_idx, cur_entry):
        """`KeyFrame::findConnection`: the CURRENT keyframe's window points
        (with estimator feature ids + world 3D) match by BRIEF (Hamming<80)
        into the OLD keyframe's dense corners (`searchByBRIEFDes`); PnP RANSAC
        on (current world 3D ↔ old normalized 2D) recovers the OLD keyframe's
        pose in the current world → loop edge + `match_points` for the
        estimator's relocalization (stored in `self.last_match`)."""
        old = self.db.entries[old_idx]
        rec = dict(i=old_idx, j=cur_idx, matches=0, inliers=0, outcome="")
        self.stats.append(rec)
        if cur_entry.get("win_desc") is None or cur_entry.get("win_pts3d") is None:
            rec["outcome"] = "no_window_points"
            return None
        cam = cur_entry.get("cam") or old.get("cam")
        if cam is None or old.get("desc") is None:
            rec["outcome"] = "no_descriptors"
            return None
        d_cur = jnp.asarray(cur_entry["win_desc"])
        d_old = jnp.asarray(old["desc"])
        dist = np.array(kdb.hamming_matrix(d_cur, d_old))
        dist[:, ~old["valid"]] = 999
        best = dist.argmin(axis=1)
        bestd = dist.min(axis=1)
        good = bestd < self.cfg.desc_hamming_thresh
        rec["matches"] = int(good.sum())
        if good.sum() < 8:
            rec["outcome"] = "few_matches"
            return None
        from plslam.ops.cameras import lift

        pts3d = np.asarray(cur_entry["win_pts3d"])[good]
        uv_old = old["uv"][best[good]]
        norm_old = np.asarray(lift(cam, jnp.asarray(uv_old, jnp.float32)), np.float64)
        # reprojection gate = 10 px in THIS camera (cv::solvePnPRansac
        # reprojectionError is pixel-space; normalize by the focal length)
        fx = float(np.asarray(cam.fx)) if cam is not None else 460.0
        out = kdb.pnp_ransac(pts3d, norm_old, thresh=10.0 / fx,
                             min_inliers=self.cfg.min_pnp_inliers, return_best=True)
        if out is None:
            rec["outcome"] = "pnp_failed"
            return None
        R_cw, t_cw, inl = out
        rec["inliers"] = int(np.sum(inl))
        if int(np.sum(inl)) < self.cfg.min_pnp_inliers:
            rec["outcome"] = "pnp_failed"
            return None
        # OLD keyframe's camera pose in the CURRENT world frame
        R_wc = R_cw.T
        p_wc = -R_cw.T @ t_cw
        # compose body_T_cam⁻¹: T_wb = T_wc ∘ T_cb
        R_w_old = R_wc @ self.R_bc.T
        p_w_old = p_wc - R_w_old @ self.p_bc
        # loop edge old→cur: relative measured via the recovered old pose and
        # the CURRENT VIO pose
        j = cur_idx
        i = old_idx
        rel_t = R_w_old.T @ (self.vio_p[j] - p_w_old)
        yaw_old = float(qnp.rot_to_ypr(R_w_old)[0])
        rel_yaw = self.vio_yaw[j] - yaw_old
        # gates (`findConnection`)
        if abs(((rel_yaw - (self.opt_yaw[j] - self.opt_yaw[i])) + np.pi) % (2 * np.pi) - np.pi) > np.deg2rad(self.cfg.max_loop_yaw_deg):
            rec["outcome"] = "yaw_gate"
            return None
        if np.linalg.norm(rel_t) > self.cfg.max_loop_translation:
            rec["outcome"] = "translation_gate"
            return None
        rec["outcome"] = "accepted"
        # match_points for the estimator (`/pose_graph/match_points`):
        # current-window feature ids + their normalized obs in the OLD camera
        ids = np.asarray(cur_entry["win_ids"]) if cur_entry.get("win_ids") is not None else None
        if ids is not None:
            sel = np.nonzero(good)[0][inl]
            self.last_match = dict(
                ids=ids[sel],
                obs_old=norm_old[inl],
                p_old=p_w_old,
                q_old=qnp.rot_to_quat(R_w_old),
                old_idx=i, cur_idx=j,
                # pixel coords + old image for the `match_image` debug dump
                uv_cur=np.asarray(cur_entry["win_uv"])[sel] if cur_entry.get("win_uv") is not None else None,
                uv_old=uv_old[inl],
                old_img=old.get("img"),
            )
        return dict(i=i, j=j, t=rel_t, yaw=rel_yaw, w=2.0, loop=1)

    def update_loop_edge(self, old_idx, cur_idx, p_w_old, q_w_old):
        """Replace the raw PnP loop-edge measurement (i=old_idx, j=cur_idx)
        with the BA-REFINED old-keyframe pose from the estimator's joint relo
        solve (the reference's `updateKeyFrameLoop`: the estimator published
        the refined relative pose back and the pose graph re-ran 4-DoF on it
        — SURVEY.md §3.4 'relative pose out'). p_w_old/q_w_old: the refined
        old-keyframe BODY pose in the current VIO world (est.relo_result).
        Returns True when the edge was updated (and a PGO re-run is pending)."""
        R_w_old = qnp.quat_to_rot(np.asarray(q_w_old, np.float64))
        rel_t = R_w_old.T @ (self.vio_p[cur_idx] - np.asarray(p_w_old, np.float64))
        yaw_old = float(qnp.rot_to_ypr(R_w_old)[0])
        rel_yaw = self.vio_yaw[cur_idx] - yaw_old
        # same sanity gates as findConnection — a diverged joint solve must
        # not replace a geometrically-vetted PnP edge
        dy = ((rel_yaw - (self.opt_yaw[cur_idx] - self.opt_yaw[old_idx])) + np.pi) % (2 * np.pi) - np.pi
        if abs(dy) > np.deg2rad(self.cfg.max_loop_yaw_deg):
            return False
        if np.linalg.norm(rel_t) > self.cfg.max_loop_translation:
            return False
        for e in self.edges:
            if e["loop"] and e["i"] == old_idx and e["j"] == cur_idx:
                # keep the raw PnP measurement for diagnostics/tests
                e.setdefault("t_pnp", e["t"])
                e.setdefault("yaw_pnp", e["yaw"])
                e["t"] = rel_t
                e["yaw"] = rel_yaw
                self._pending_opt = True
                return True
        return False

    def fast_relocalize(self, edge):
        """`fast_relocalization`: on a confirmed loop into the (loaded) map,
        immediately shift the drift from the single loop edge — the map-frame
        pose of the current keyframe implied by the measured relative pose —
        without waiting for the full 4-DoF PGO."""
        i, j = edge["i"], edge["j"]
        Ri = _rot_ypr_np(self.opt_yaw[i], self.pitch[i], self.roll[i])
        p_j_map = self.opt_p[i] + Ri @ np.asarray(edge["t"])
        yaw_j_map = self.opt_yaw[i] + edge["yaw"]
        self.yaw_drift = yaw_j_map - self.vio_yaw[j]
        Rz = _rot_ypr_np(self.yaw_drift)
        self.r_drift = Rz
        self.t_drift = p_j_map - Rz @ self.vio_p[j]
        self.opt_p[j] = p_j_map
        self.opt_yaw[j] = yaw_j_map

    # ------------------------------------------------------------------- PGO
    def optimize(self, iters=12):
        """`optimize4DoF` + drift update.

        Small graphs use the dense-Hessian path; above `_PCG_THRESHOLD`
        keyframes the dense (4K)² normal equations are replaced by the
        matrix-free PCG path (O(E) memory, block-tridiagonal preconditioner).
        BOTH edge arrays and the node capacity are padded to the next power
        of two of the LIVE graph size (masked), so a 128-KF closure solves a
        128-node system instead of paying the full-capacity (4·2048)²
        factorization (~20× the necessary work), and every PGO trigger reuses
        a cached executable. The solve runs in float32 explicitly — the
        accelerator path — so CPU-mesh tests exercise the same numerics."""
        if self.n < 2 or not self.edges:
            return
        K = min(self.cfg.max_keyframes,
                max(64, 1 << int(self.n - 1).bit_length()))
        E = len(self.edges)
        Ep = 1 << (E - 1).bit_length()  # pad: bounded recompilation
        e_i = np.zeros(Ep, np.int32)
        e_j = np.zeros(Ep, np.int32)
        e_t = np.zeros((Ep, 3))
        e_yaw = np.zeros(Ep)
        e_w = np.zeros(Ep)
        e_loop = np.zeros(Ep)
        e_valid = np.zeros(Ep)
        for m, e in enumerate(self.edges):
            e_i[m], e_j[m] = e["i"], e["j"]
            e_t[m] = e["t"]
            e_yaw[m] = e["yaw"]
            e_w[m] = e["w"]
            e_loop[m] = e["loop"]
            e_valid[m] = 1.0
        node_valid = np.zeros(K, np.float32)
        node_valid[: self.n] = 1.0

        ftype = np.float32
        solve = optimize_4dof if K < _PCG_THRESHOLD else optimize_4dof_pcg
        xyz, yaw, costs = solve(
            asdev(self.opt_p[:K], ftype), asdev(self.opt_yaw[:K], ftype),
            asdev(self.pitch[:K], ftype), asdev(self.roll[:K], ftype),
            jnp.asarray(node_valid),
            jnp.asarray(e_i), jnp.asarray(e_j),
            jnp.asarray(e_t, ftype), jnp.asarray(e_yaw, ftype),
            jnp.asarray(e_w, ftype), jnp.asarray(e_valid, ftype),
            jnp.asarray(e_loop, ftype),
            iters=iters,
        )
        self.opt_p[: self.n] = np.asarray(xyz)[: self.n]
        self.opt_yaw[: self.n] = np.asarray(yaw)[: self.n]
        # drift: last keyframe optimized vs VIO (§A.7)
        k = self.n - 1
        self.yaw_drift = self.opt_yaw[k] - self.vio_yaw[k]
        Rz = _rot_ypr_np(self.yaw_drift)
        self.r_drift = Rz
        self.t_drift = self.opt_p[k] - Rz @ self.vio_p[k]
        self._pending_opt = False

    def correct(self, p_vio, q_vio):
        """Apply the current drift to a live VIO pose (`updatePath` output)."""
        p = self.r_drift @ np.asarray(p_vio) + self.t_drift
        q = qnp.quat_mul(qnp.rot_to_quat(self.r_drift), np.asarray(q_vio, np.float64))
        return p, q

    # --------------------------------------------------------------- save/load
    def save(self, path):
        """`savePoseGraph` (npz instead of the reference's txt+per-kf files).

        Persists everything `_find_connection` needs — per-keyframe dense
        corners (uv/valid), their BRIEF descriptors, the window points
        (uv/ids/world-3D/descriptors) and the camera intrinsics — so a new
        session can relocalize against the loaded map exactly like the
        reference's `load_previous_pose_graph` + `fast_relocalization`."""
        n = self.n
        # keyframes added without imagery have no DB entry — pad so every
        # keyframe slot round-trips (its appearance data just stays empty)
        ents = (self.db.entries + [{}] * n)[:n]
        cam = next((e.get("cam") for e in ents if e.get("cam") is not None), None)

        def stack(key, shape, dtype):
            out = np.zeros((n,) + shape, dtype)
            for k, e in enumerate(ents):
                v = e.get(key)
                if v is not None:
                    out[k] = v
            return out

        # variable-length window arrays → concatenation + offsets
        w_cnt = np.array([0 if e.get("win_uv") is None else len(e["win_uv"]) for e in ents], np.int64)
        w_off = np.concatenate([[0], np.cumsum(w_cnt)])
        cat = lambda key, width, dtype: (
            np.concatenate([np.asarray(e[key], dtype).reshape(c, width) for e, c in zip(ents, w_cnt) if c],
                           axis=0) if w_cnt.sum() else np.zeros((0, width), dtype))
        kp = kdb.MAX_KP
        np.savez_compressed(
            path,
            n=n, base_n=self.base_n,
            vio_p=self.vio_p[:n], vio_q=self.vio_q[:n], vio_yaw=self.vio_yaw[:n],
            opt_p=self.opt_p[:n], opt_yaw=self.opt_yaw[:n],
            pitch=self.pitch[:n], roll=self.roll[:n],
            t_kf=self.t_kf[:n],
            edges_i=[e["i"] for e in self.edges], edges_j=[e["j"] for e in self.edges],
            edges_t=[e["t"] for e in self.edges], edges_yaw=[e["yaw"] for e in self.edges],
            edges_w=[e["w"] for e in self.edges], edges_loop=[e["loop"] for e in self.edges],
            gdescs=self.db.gdescs[: self.db.n],
            kf_uv=stack("uv", (kp, 2), np.float32),
            kf_valid=stack("valid", (kp,), bool),
            kf_desc=stack("desc", (kp, kdb.N_BRIEF_WORDS), np.uint32),
            win_cnt=w_cnt,
            win_uv=cat("win_uv", 2, np.float64),
            win_ids=cat("win_ids", 1, np.int64),
            win_pts3d=cat("win_pts3d", 3, np.float64),
            win_desc=cat("win_desc", kdb.N_BRIEF_WORDS, np.uint32),
            cam_kind=(0 if cam is None else kdb_cams.cam_to_params(cam)[0]),
            cam_params=(np.zeros(9) if cam is None else kdb_cams.cam_to_params(cam)[1]),
            has_cam=cam is not None,
        )

    def load(self, path):
        """`loadPoseGraph`: restore the full relocalization-capable map.
        Keyframes added after a load belong to a NEW session: sequential edges
        never bridge the map→session discontinuity (reference sequence
        semantics), and a loop edge into the map relocalizes the session."""
        z = np.load(path, allow_pickle=True)
        n = int(z["n"])
        self.n = n
        self.base_n = n  # everything loaded is the previous map
        self.vio_p[:n] = z["vio_p"]
        self.vio_q[:n] = z["vio_q"]
        if "vio_yaw" in z.files:
            self.vio_yaw[:n] = z["vio_yaw"]
        else:  # maps saved before vio_yaw was persisted: derive from vio_q
            self.vio_yaw[:n] = [
                float(qnp.rot_to_ypr(qnp.quat_to_rot(q))[0]) for q in z["vio_q"]
            ]
        self.opt_p[:n] = z["opt_p"]
        self.opt_yaw[:n] = z["opt_yaw"]
        self.pitch[:n] = z["pitch"]
        self.roll[:n] = z["roll"]
        self.t_kf[:n] = z["t_kf"]
        self.edges = [
            dict(i=int(i), j=int(j), t=np.asarray(t), yaw=float(y), w=float(w), loop=int(l))
            for i, j, t, y, w, l in zip(
                z["edges_i"], z["edges_j"], z["edges_t"], z["edges_yaw"], z["edges_w"], z["edges_loop"]
            )
        ]
        self.db.gdescs[: len(z["gdescs"])] = z["gdescs"]
        self.db.n = len(z["gdescs"])
        cam = None
        if bool(z["has_cam"]):
            # cam_kind dispatches the factory; maps saved before the factory
            # existed carry 8 pinhole params and no cam_kind field
            kind = int(z["cam_kind"]) if "cam_kind" in z.files else 0
            cam = kdb_cams.cam_from_params(kind, np.asarray(z["cam_params"], np.float64))
        w_cnt = z["win_cnt"]
        w_off = np.concatenate([[0], np.cumsum(w_cnt)])
        self.db.entries = []
        for k in range(n):
            lo, hi = int(w_off[k]), int(w_off[k + 1])
            self.db.entries.append(dict(
                uv=z["kf_uv"][k], valid=z["kf_valid"][k], desc=z["kf_desc"][k], cam=cam,
                win_uv=z["win_uv"][lo:hi] if hi > lo else None,
                win_ids=z["win_ids"][lo:hi, 0] if hi > lo else None,
                win_pts3d=z["win_pts3d"][lo:hi] if hi > lo else None,
                win_desc=z["win_desc"][lo:hi] if hi > lo else None,
            ))
