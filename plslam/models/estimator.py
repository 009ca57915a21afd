"""Sliding-window visual-inertial estimator — the central state machine.

JAX equivalent of the reference's `vins_estimator/src/estimator.cpp`
(`Estimator::processIMU/processImage`, `solveOdometry`, `slideWindow`,
`failureDetection`, `clearState` — SURVEY.md §2.3 / §3.3) plus the
measurement-alignment host loop of `estimator_node.cpp`.

Split of responsibilities:
  host (this class, numpy): feature-table surgery, keyframe decision, window
    shifting, IMU buffering — cheap bookkeeping the reference also did on CPU.
  device (jitted fns): preintegration scan, triangulation, the LM/Schur
    window solve, marginalization — all fixed-shape, compiled once.

Asynchronous ROS callbacks collapse into a synchronous `process_imu` /
`process_frame` API (offline measurement pairing is array slicing —
SURVEY.md §2.3 row 'Estimator node').
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from plslam.config import PLSlamConfig
from plslam.models import marginalization as marg
from plslam.models import residuals as res
from plslam.models import solver as solver_mod
from plslam.models import triangulate
from plslam.models.feature_table import LineTable, PointTable
from plslam.models.state import WindowState, layout, zero_state
from plslam.ops import imu as imu_ops
from plslam.utils import quat_np as qnp
from plslam.utils.device import asdev
from plslam.utils.geometry import rot_to_quat
from plslam.utils.device import highest_matmul_precision

MARGIN_OLD = 0
MARGIN_SECOND_NEW = 1
IMU_PAD = 512  # max IMU samples per (possibly merged) keyframe interval


class ImuBuffer:
    """Samples of one keyframe interval, including the boundary sample of the
    previous interval (the reference's `IntegrationBase` ctor + push_back)."""

    def __init__(self):
        self.acc: list = []
        self.gyr: list = []
        self.dt: list = []  # len == len(acc) - 1 once seeded

    @property
    def seeded(self):
        return len(self.acc) > 0

    def seed(self, acc, gyr):
        self.acc = [np.asarray(acc, np.float64)]
        self.gyr = [np.asarray(gyr, np.float64)]
        self.dt = []

    def append(self, acc, gyr, dt):
        self.acc.append(np.asarray(acc, np.float64))
        self.gyr.append(np.asarray(gyr, np.float64))
        self.dt.append(float(dt))

    @staticmethod
    def merged(a: "ImuBuffer", b: "ImuBuffer") -> "ImuBuffer":
        m = ImuBuffer()
        if not a.seeded:
            return b
        m.acc = a.acc + b.acc[1:]
        m.gyr = a.gyr + b.gyr[1:]
        m.dt = a.dt + b.dt
        return m

    def padded(self, dtype):
        n = min(len(self.dt), IMU_PAD)
        acc = np.zeros((IMU_PAD + 1, 3))
        gyr = np.zeros((IMU_PAD + 1, 3))
        dts = np.zeros(IMU_PAD)
        if n > 0:
            acc[: n + 1] = np.stack(self.acc[: n + 1])
            gyr[: n + 1] = np.stack(self.gyr[: n + 1])
            acc[n + 1 :] = acc[n]
            gyr[n + 1 :] = gyr[n]
            dts[:n] = self.dt[:n]
        return jnp.asarray(acc, dtype), jnp.asarray(gyr, dtype), jnp.asarray(dts, dtype)


class Estimator:
    def __init__(self, config: PLSlamConfig, dtype=None):
        self.config = config
        self.cfg = config.solver
        self.lay = layout(self.cfg)
        self.dtype = dtype or (jnp.float64 if self.cfg.dtype == "float64" else jnp.float32)
        self.noise = imu_ops.ImuNoise(
            *[jnp.asarray(v, self.dtype) for v in
              (config.imu.acc_n, config.imu.gyr_n, config.imu.acc_w, config.imu.gyr_w)]
        )
        self.g = jnp.asarray([0.0, 0.0, config.imu.g_norm], self.dtype)
        self.clear_state()

    # ------------------------------------------------------------- state mgmt
    def clear_state(self):
        """`Estimator::clearState()` — full re-initialization."""
        nw = self.cfg.window_size + 1
        self.frame_count = 0  # slot index the NEXT frame occupies (0..nw-1)
        self.initialized = False
        self.timestamps = np.zeros(nw)
        self.td_pair = np.zeros(nw)  # per-slot IMU-pairing td (factor td_i)
        self.p = np.zeros((nw, 3))
        self.q = np.tile([1.0, 0, 0, 0], (nw, 1)).astype(np.float64)
        self.v = np.zeros((nw, 3))
        self.ba = np.zeros((nw, 3))
        self.bg = np.zeros((nw, 3))
        ext = self.config.extrinsic
        R_bc = np.asarray(ext.rot).reshape(3, 3)
        self.q_bc = np.array(rot_to_quat(jnp.asarray(R_bc)))
        self.p_bc = np.array(ext.trans, np.float64)
        self.td = float(self.config.temporal.td)
        self.pt_table = PointTable(self.cfg)
        self.ln_table = LineTable(self.cfg)
        self.line_w = np.zeros((self.cfg.max_line_feats, 6))
        self.line_w[:, 1] = 5.0
        self.line_w[:, 5] = 1.0
        # imu_bufs[k] holds samples spanning (frame k-1 → frame k); [0] covers
        # the pre-first-frame samples and is never used as a factor
        self.imu_bufs: list[ImuBuffer] = [ImuBuffer()]
        self.pres: list[Optional[dict]] = [None]
        self.prior: Optional[marg.Prior] = None
        self.last_acc = None
        self.last_gyr = None
        # solves since the last (re-)initialization: the post-init health
        # gate in _failure_detection only watches the first few solves
        self.solves_since_init = 0
        self._init_bad_solves = 0
        # observability log persists across failure-triggered re-inits (the
        # failure entry itself must stay visible to monitoring)
        self.metrics: list[dict] = getattr(self, "metrics", [])
        self._zero_state_cache = getattr(self, "_zero_state_cache", None)
        self._zero_pre_cache = getattr(self, "_zero_pre_cache", None)
        self._empty_factors_cache = getattr(self, "_empty_factors_cache", None)
        self._pending = None  # deferred solve awaiting finalize()
        self._pending_prior = None
        self._kf_snapshot = None
        self.relo: Optional[dict] = None  # pending relocalization frame
        self.relo_result: Optional[dict] = None  # refined relative pose out
        # ESTIMATE_EXTRINSIC=2: the body↔camera rotation is unknown — run the
        # hand-eye calibration on live rotation-delta pairs until the
        # excitation criterion passes, THEN allow initialization and fall into
        # =1 in-solver refinement (the reference's `CalibrationExRotation`
        # loop in processImage, SURVEY.md §2.3 `initial_ex_rotation` row)
        self.ex_calibrated = self.config.extrinsic.estimate_extrinsic != 2
        self._ex_qcam: list = []
        self._ex_qimu: list = []

    # ---------------------------------------------------------------- inputs
    def process_imu(self, dt: float, acc, gyr):
        """`Estimator::processIMU` — buffer the sample and dead-reckon the
        newest state slot (the solver's initial guess)."""
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        first = self.last_acc is None
        buf = self.imu_bufs[-1]
        if not buf.seeded:
            # interval opens with the boundary sample (the reference passed
            # acc_0/gyr_0 into the IntegrationBase constructor)
            if first:
                buf.seed(acc, gyr)
                self.last_acc, self.last_gyr = acc, gyr
                return
            buf.seed(self.last_acc, self.last_gyr)
        buf.append(acc, gyr, dt)

        # midpoint dead-reckoning on the newest slot (pure numpy — this runs
        # at IMU rate on the host, no device dispatches)
        k = min(self.frame_count, self.cfg.window_size)
        self._deadreckon_step(k, self.last_acc, self.last_gyr, acc, gyr, dt)
        self.last_acc, self.last_gyr = acc, gyr

    def _deadreckon_step(self, k, acc0, gyr0, acc1, gyr1, dt):
        ba, bg = self.ba[k], self.bg[k]
        g = np.array([0.0, 0.0, self.config.imu.g_norm])
        w_mid = 0.5 * (gyr0 + gyr1) - bg
        q_old = self.q[k].copy()
        q_new = qnp.quat_normalize(qnp.quat_mul(q_old, qnp.quat_exp(w_mid * dt)))
        a0 = qnp.quat_rotate(q_old, acc0 - ba) - g
        a1 = qnp.quat_rotate(q_new, acc1 - ba) - g
        a_mid = 0.5 * (a0 + a1)
        self.p[k] += self.v[k] * dt + 0.5 * a_mid * dt * dt
        self.v[k] += a_mid * dt
        self.q[k] = q_new

    def _replay_open_buffer(self):
        """Re-apply the dead-reckoning of IMU samples that arrived while a
        deferred solve was in flight: their host prediction ran on the
        pre-solve state, which the finalize writeback just replaced — replay
        onto the solved (post-slide) state reproduces the synchronous path
        bit-for-bit (the reference's `update()` re-bases its predictor the
        same way)."""
        buf = self.imu_bufs[-1]
        if not buf.seeded or not buf.dt:
            return
        k = min(self.frame_count, self.cfg.window_size)
        for i, dt in enumerate(buf.dt):
            self._deadreckon_step(k, buf.acc[i], buf.gyr[i],
                                  buf.acc[i + 1], buf.gyr[i + 1], dt)

    def _close_interval(self, k: int):
        """Preintegrate the interval ending at frame slot k."""
        buf = self.imu_bufs[k]
        if len(buf.dt) == 0:
            self.pres[k] = None
            return
        acc, gyr, dts = buf.padded(self.dtype)
        kb = max(k - 1, 0)
        self.pres[k] = _preintegrate_padded(
            acc, gyr, dts,
            asdev(self.ba[kb], self.dtype),
            asdev(self.bg[kb], self.dtype),
            self.noise,
        )

    # ---------------------------------------------------------------- frames
    def process_frame(self, t: float, pt_ids, pt_obs, pt_vel=None, ln_ids=None, ln_obs=None,
                      oracle_state: Optional[dict] = None, defer_solve: bool = False):
        """`Estimator::processImage`. Returns a per-frame metrics dict.

        oracle_state: optional {p,q,v} ground truth for the newest frame —
        bootstrap mode standing in for `initialStructure()` in tests.
        defer_solve=True dispatches the fused solve program and returns
        WITHOUT reading its results back; the caller overlaps other work with
        the device round trip and `finalize()` (called automatically by the
        next `process_frame`/`latest_pose`/`window_points`) completes the
        frame — results are bit-identical to the synchronous path (buffered
        IMU dead-reckoning is replayed onto the solved state, exactly like
        the reference's `update()` re-basing its high-rate predictor)."""
        self.finalize()
        fc = min(self.frame_count, self.cfg.window_size)
        # restart handshake (`feature_tracker_node` timestamp-jump detection →
        # estimator restart_callback): non-monotonic or >1 s gap ⇒ full reset
        last_t = self.timestamps[max(fc - 1, 0)] if self.frame_count > 0 else None
        if last_t is not None and (t < last_t - 1e-9 or t - last_t > 1.0):
            self.clear_state()
            fc = 0
        self.timestamps[fc] = t
        # td the IMU pairing used for THIS frame (the feeder reads est.td
        # live right before process_frame) — the ProjectionTdFactor's td_i
        self.td_pair[fc] = self.td
        self._close_interval(fc)

        self.pt_table.add_frame(fc, pt_ids, pt_obs, pt_vel)
        if ln_ids is not None and len(ln_ids):
            self.ln_table.add_frame(fc, ln_ids, ln_obs)

        if not self.ex_calibrated and fc >= 1:
            self._calibrate_extrinsic_step(fc)

        keyframe = self.pt_table.parallax_keyframe_decision(fc)
        marg_flag = MARGIN_OLD if keyframe else MARGIN_SECOND_NEW
        # MARGIN_SECOND_NEW merges interval (nw-1→nw) into (nw-2→nw-1); if the
        # merged sample count would overflow the fixed IMU_PAD bucket (long
        # hover/stationary runs of non-keyframes), force a keyframe instead of
        # silently truncating the preintegration (the factor would then span
        # less time than the frame gap).
        nw = self.cfg.window_size
        if (marg_flag == MARGIN_SECOND_NEW and self.frame_count >= nw
                and len(self.imu_bufs[nw - 1].dt) + len(self.imu_bufs[nw].dt) > IMU_PAD):
            keyframe = True
            marg_flag = MARGIN_OLD

        if oracle_state is not None and not self.initialized:
            self.p[fc] = oracle_state["p"]
            self.q[fc] = oracle_state["q"]
            self.v[fc] = oracle_state["v"]

        # long_tracked = features re-observed in THIS frame with ≥2 window
        # observations — the reference's `last_track_num`, which its
        # failureDetection fires on when it collapses (<2: texture-less
        # stretch / blanked frames — SURVEY.md §5.3)
        long_tracked = (self.pt_table.mask[:, fc] > 0) & (
            np.sum(self.pt_table.mask, axis=1) >= 2)
        m = {"t": t, "frame": fc, "keyframe": bool(keyframe),
             "tracked": int(self.pt_table.active.sum()),
             "long_tracked": int(long_tracked.sum())}

        if self.frame_count < self.cfg.window_size:
            # window still filling
            self.frame_count += 1
            self.imu_bufs.append(ImuBuffer())
            self.pres.append(None)
            self.p[self.frame_count] = self.p[self.frame_count - 1]
            self.q[self.frame_count] = self.q[self.frame_count - 1]
            self.v[self.frame_count] = self.v[self.frame_count - 1]
            self.metrics.append(m)
            return m

        if not self.initialized:
            if oracle_state is not None:
                self.initialized = True
                self.solves_since_init = 0
            else:
                from plslam.models import initializer

                # ESTIMATE_EXTRINSIC=2 gates initialization until the
                # hand-eye calibration converges (the reference's
                # `initialStructure` requires ESTIMATE_EXTRINSIC != 2)
                if self.ex_calibrated and initializer.try_initialize(self):
                    self.initialized = True
                    self.solves_since_init = 0
                else:
                    self._slide_uninitialized()
                    self.metrics.append(m)
                    return m

        # ---------------- solve odometry (ONE fused device program) ----------
        bundle_dev, prior, mode = self._dispatch_solve(marg_flag)
        # the next interval's open IMU buffer must exist at dispatch time so
        # samples arriving before finalize() land in the right interval
        self.imu_bufs.append(ImuBuffer())
        self.pres.append(None)
        # record WHICH relo request (if any) the dispatched bundle solved:
        # a set_relo_frame between dispatch and finalize must not be consumed
        # against this bundle's (zero-state) relo outputs
        self._pending = dict(bundle=bundle_dev, prior=prior, mode=mode,
                             marg_flag=marg_flag, m=m, relo=self.relo)
        if not defer_solve:
            self.finalize()
        return m

    def finalize(self):
        """Complete a deferred `process_frame`: pull the solve bundle, apply
        the host-side table surgery / failure detection / window slide, then
        replay the dead-reckoning of any IMU samples that arrived while the
        solve was in flight. No-op when nothing is pending."""
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        m = pend["m"]
        self._pending_prior = pend["prior"] if pend["mode"] != "none" else None
        m.update(self._finish_solve(pend["bundle"], pend["relo"]))
        self.solves_since_init += 1
        if self._failure_detection(m):
            m["failure"] = True
            self.metrics.append(m)
            self.clear_state()
            return
        self._slide(pend["marg_flag"])
        self._replay_open_buffer()
        self.metrics.append(m)

    # ------------------------------------------------- extrinsic calibration
    def _gyro_delta_q(self, fc: int):
        """Gyro-only midpoint rotation delta over the interval ending at frame
        fc (the bias-free `delta_q` the reference's CalibrationExRotation
        paired with the visual delta) — pure host numpy, no device readback."""
        buf = self.imu_bufs[fc] if fc < len(self.imu_bufs) else None
        if buf is None or not buf.seeded or not buf.dt:
            return None
        bg = self.bg[max(fc - 1, 0)]
        q = np.array([1.0, 0.0, 0.0, 0.0])
        for i, dt in enumerate(buf.dt):
            w_mid = 0.5 * (buf.gyr[i] + buf.gyr[i + 1]) - bg
            q = qnp.quat_normalize(qnp.quat_mul(q, qnp.quat_exp(w_mid * dt)))
        return q

    def _calibrate_extrinsic_step(self, fc: int):
        """ESTIMATE_EXTRINSIC=2 live flow (`CalibrationExRotation` per frame,
        SURVEY.md §2.3): pair the camera rotation delta between the two newest
        frames (8-pt essential on tracked correspondences — runs only while
        uncalibrated) with the gyro-integrated IMU delta; the hand-eye LS
        installs R_bc once the rotational-excitation criterion passes, after
        which estimate_extrinsic behaves like =1 (in-solver refinement)."""
        from plslam.models import initializer as ini

        tbl = self.pt_table
        both = tbl.active & (tbl.mask[:, fc - 1] > 0) & (tbl.mask[:, fc] > 0)
        if both.sum() >= 9:
            out = ini.essential_ransac(tbl.obs[both, fc - 1], tbl.obs[both, fc],
                                       iters=60)
            if out is not None:
                R, _, _ = out  # x_fc = R x_{fc-1} (camera frames, up to t)
                q_cam = qnp.rot_to_quat(R.T)  # q_c(fc-1)→c(fc)
                q_imu = self._gyro_delta_q(fc)
                if q_imu is not None:
                    self._ex_qcam.append(q_cam)
                    self._ex_qimu.append(q_imu)
        if len(self._ex_qcam) >= self.cfg.window_size:
            q_bc, ok = ini.calibrate_extrinsic_rotation(self._ex_qcam, self._ex_qimu)
            if ok:
                self.q_bc = np.asarray(q_bc, np.float64)
                self.ex_calibrated = True
                self._ex_qcam, self._ex_qimu = [], []

    # --------------------------------------------------------- relocalization
    def set_relo_frame(self, match_ids, match_obs_norm, relo_p, relo_q):
        """`Estimator::setReloFrame`: register an old keyframe's matched
        feature observations (by global feature id, normalized coords in the
        old camera) + its pose guess. The next window solve adds relo
        projection factors and refines the old pose jointly; the refined
        relative transform lands in `self.relo_result`."""
        mf = self.cfg.max_features
        obs = np.zeros((mf, 2))
        mask = np.zeros(mf)
        slot_of = {int(i): s for s, i in enumerate(self.pt_table.ids) if i >= 0}
        n = 0
        for fid, ob in zip(match_ids, match_obs_norm):
            s = slot_of.get(int(fid))
            if s is not None:
                obs[s] = ob
                mask[s] = 1.0
                n += 1
        if n < 8:
            return False
        self.relo = dict(obs=obs, mask=mask, p=np.asarray(relo_p, np.float64),
                         q=np.asarray(relo_q, np.float64))
        return True

    def _extract_relo_result(self, p_old, q_old, p_cur, q_cur):
        """Relative pose old-kf ← newest window frame after the joint solve
        (the reference's `relo_relative_t/q` published back to the pose graph).
        Pure numpy — runs on already-pulled bundle values."""
        q_rel = qnp.quat_mul(qnp.quat_conj(q_old), q_cur)
        t_rel = qnp.quat_rotate(qnp.quat_conj(q_old), p_cur - p_old)
        self.relo_result = dict(t=t_rel, q=q_rel, p_old=p_old, q_old=q_old)

    # ------------------------------------------------------------ device I/O
    def _device_state(self) -> WindowState:
        if self._zero_state_cache is None:
            self._zero_state_cache = zero_state(self.cfg, self.dtype)
        st = self._zero_state_cache
        return st._replace(
            p=asdev(self.p, self.dtype),
            q=asdev(self.q, self.dtype),
            v=asdev(self.v, self.dtype),
            ba=asdev(self.ba, self.dtype),
            bg=asdev(self.bg, self.dtype),
            p_bc=asdev(self.p_bc, self.dtype),
            q_bc=asdev(self.q_bc, self.dtype),
            td=asdev(self.td, self.dtype),
            relo_p=asdev(self.relo["p"] if self.relo else np.zeros(3), self.dtype),
            relo_q=asdev(self.relo["q"] if self.relo else np.array([1.0, 0, 0, 0]), self.dtype),
            inv_depth=jnp.asarray(
                np.where(self.pt_table.inv_depth > 0, self.pt_table.inv_depth, 0.2), self.dtype
            ),
            line=asdev(self.line_w, self.dtype),
        )

    def _zero_pre(self):
        """Cached device dict standing in for a not-yet-closed interval."""
        if self._zero_pre_cache is None:
            dtype = self.dtype
            self._zero_pre_cache = {
                "alpha": jnp.zeros(3, dtype), "beta": jnp.zeros(3, dtype),
                "gamma": jnp.asarray([1.0, 0, 0, 0], dtype),
                "jac": jnp.eye(15, dtype=dtype), "sqrt_info": jnp.eye(15, dtype=dtype),
                "dt_sum": jnp.zeros((), dtype),
                "ba": jnp.zeros(3, dtype), "bg": jnp.zeros(3, dtype),
            }
        return self._zero_pre_cache

    def _factors(self) -> res.WindowFactors:
        lay, dtype = self.lay, self.dtype
        if self._empty_factors_cache is None:
            self._empty_factors_cache = res.empty_factors(self.cfg, lay, dtype)
        f = self._empty_factors_cache
        W = lay.nw - 1
        zero = self._zero_pre()
        pres, vb = [], []
        for k in range(1, W + 1):
            pre = self.pres[k] if k < len(self.pres) else None
            pres.append(pre if pre is not None else zero)
            vb.append(0.0 if pre is None else 1.0)
        # ONE dispatch stacks all preintegration fields (instead of ~90 eager
        # per-field stacks, each its own dispatch)
        stk = _stack_pres_jit(tuple(pres))
        f = f._replace(
            imu_alpha=stk["alpha"], imu_beta=stk["beta"], imu_gamma=stk["gamma"],
            imu_jac=stk["jac"], imu_sqrt_info=stk["sqrt_info"], imu_dt=stk["dt_sum"],
            imu_ba=stk["ba"], imu_bg=stk["bg"],
            imu_valid=jnp.asarray(vb, dtype), g=self.g,
        )
        pt_used = self.pt_table.used_in_solver()
        camc = self.config.camera
        if self.config.temporal.rolling_shutter:
            # image-row fraction of each observation (row ≈ fy·y_norm + cy)
            rowf = np.clip(
                (camc.fy * self.pt_table.obs[..., 1] + camc.cy) / max(camc.image_height, 1),
                0.0, 1.0,
            )
            rs_tr = self.config.temporal.rolling_shutter_tr
        else:
            rowf = np.zeros_like(self.pt_table.obs[..., 1])
            rs_tr = 0.0
        f = f._replace(
            pt_obs=asdev(self.pt_table.obs, dtype),
            pt_vel=asdev(self.pt_table.vel, dtype),
            pt_td_ref=asdev(self.td_pair, dtype),
            pt_rowf=jnp.asarray(rowf, dtype),
            rs_tr=jnp.asarray(rs_tr, dtype),
            pt_mask=asdev(self.pt_table.mask.astype(np.float64), dtype),
            pt_start=asdev(self.pt_table.start),
            pt_valid=jnp.asarray(pt_used.astype(np.float64), dtype),
        )
        ln_used = self.ln_table.usable()
        f = f._replace(
            ln_obs=asdev(self.ln_table.obs, dtype),
            ln_mask=asdev(self.ln_table.mask.astype(np.float64), dtype),
            ln_valid=jnp.asarray(ln_used.astype(np.float64), dtype),
            ln_start=asdev(self.ln_table.start),
        )
        if self.relo is not None:
            f = f._replace(
                relo_obs=asdev(self.relo["obs"], dtype),
                relo_mask=asdev(self.relo["mask"], dtype),
                relo_valid=jnp.ones((), dtype),
            )
        if self.prior is not None:
            f = marg.install_prior(f, self.prior)
        return f

    # --------------------------------------------------------------- solving
    def _cam_poses_np(self):
        q_wc = qnp.quat_mul(self.q, self.q_bc[None, :])
        p_wc = self.p + qnp.quat_rotate(self.q, np.broadcast_to(self.p_bc, self.p.shape))
        return p_wc, q_wc

    def _dispatch_solve(self, marg_flag: int):
        """`solveOdometry()` + `optimization()` + outlier gating +
        marginalization, dispatched as ONE device program with ONE packed
        readback; `_finish_solve` does the host bookkeeping on the pulled
        bundle. Returns (bundle_device, prior_device, marg_mode)."""
        st = self._device_state()
        f = self._factors()
        tbl, ltb = self.pt_table, self.ln_table
        nw, MF, ML = self.cfg.window_size, self.cfg.max_features, self.cfg.max_line_feats
        solvable = tbl.solvable()
        tri_need = solvable & (tbl.inv_depth <= 0)
        fb4 = np.sum(tbl.mask, axis=1) >= 4
        ln_active2 = ltb.active & (np.sum(ltb.mask, axis=1) >= 2)
        lneed = ln_active2 & ~ltb.solved
        mode = ("old" if marg_flag == MARGIN_OLD
                else ("new" if self.prior is not None else "none"))
        fmask = lambda a: asdev(a.astype(np.float64), self.dtype)
        prior, bundle_dev = _backend_program(
            st, f, fmask(solvable), fmask(tri_need), fmask(fb4),
            fmask(lneed), fmask(ln_active2),
            self.lay, self.cfg,
            ee=self.config.extrinsic.estimate_extrinsic > 0,
            etd=self.config.temporal.estimate_td,
            iters=self.cfg.max_num_iterations,
            marg_mode=mode)
        try:
            bundle_dev.copy_to_host_async()  # start the RTT immediately
        except Exception:
            pass
        return bundle_dev, prior, mode

    def _finish_solve(self, bundle_dev, dispatched_relo=None) -> dict:
        tbl, ltb = self.pt_table, self.ln_table
        nw, MF, ML = self.cfg.window_size, self.cfg.max_features, self.cfg.max_line_feats
        # np.array (copy): device views are read-only, host state is mutated
        b = np.array(bundle_dev, np.float64)  # the ONE readback

        NW = nw + 1
        off = 0

        def take(n, shape=None):
            nonlocal off
            v = b[off: off + n]
            off += n
            return v.reshape(shape) if shape else v

        self.p = take(NW * 3, (NW, 3))
        self.q = take(NW * 4, (NW, 4))
        self.v = take(NW * 3, (NW, 3))
        self.ba = take(NW * 3, (NW, 3))
        self.bg = take(NW * 3, (NW, 3))
        self.p_bc = take(3)
        self.q_bc = take(4)
        self.td = float(take(1)[0])
        relo_p = take(3)
        relo_q = take(4)
        inv = take(MF)
        self.line_w = take(ML * 6, (ML, 6))
        commit = take(MF) > 0
        lcommit = take(ML) > 0
        pt_valid = take(MF) > 0
        ln_solved = take(ML) > 0
        pt_err = take(MF)
        ln_err = take(ML)
        p_w = take(MF * 3, (MF, 3))
        cost0, cost, cr0, cr, acc = take(5)

        # triangulation commits + solved-depth writeback + removeFailures
        ltb.solved |= lcommit
        tbl.inv_depth[pt_valid] = inv[pt_valid]
        failed = pt_valid & (inv <= 0)
        if np.any(failed):
            tbl.drop(np.nonzero(failed)[0])
        # removeOutlier / removeLineOutlier (10 px reprojection gates)
        bad = pt_valid & (pt_err > 10.0)
        if np.any(bad):
            tbl.drop(np.nonzero(bad)[0])
        badl = ln_solved & (ln_err > 10.0)
        if np.any(badl):
            ltb.drop(np.nonzero(badl)[0])
        # keyframe payload snapshot (window_points) — post-drop, pre-slide
        kf_m = pt_valid & (tbl.mask[:, nw] > 0) & (tbl.ids >= 0)
        self._kf_snapshot = (tbl.ids[kf_m].copy(), tbl.obs[kf_m, nw].copy(),
                             p_w[kf_m].copy())
        if dispatched_relo is not None:
            # extract only the relo that was actually IN the dispatched solve;
            # clear the live request only if it is still that same one (a
            # fresher set_relo_frame stays pending for the next solve)
            self._extract_relo_result(relo_p, relo_q, self.p[nw], self.q[nw])
            if self.relo is dispatched_relo:
                self.relo = None
        return dict(
            cost0=float(cost0), cost=float(cost), cost_robust0=float(cr0),
            cost_robust=float(cr), iters_accepted=int(acc),
            n_pts=int(pt_valid.sum()), n_lines=int(ln_solved.sum()),
        )

    def _failure_detection(self, m: Optional[dict] = None) -> bool:
        """`Estimator::failureDetection` (SURVEY.md §5.3): tracked-feature
        collapse, bias blow-up, position/z jump → clearState + re-init."""
        nw = self.cfg.window_size
        if m is not None and m.get("long_tracked", 99) < 2:
            return True
        # post-init health gate: a bad visual-inertial alignment (degenerate
        # init geometry — rotation-dominant parallax leaves scale nearly
        # unobservable and the alignment's free velocities absorb the
        # residual, so the alignment's own gates pass) shows up as a large
        # PERSISTENT window-solve cost. Measured on rendered EuRoC-class
        # noise: healthy inits solve at ≤0.9 cost/point over the first
        # solves (one-solve transients higher), a scale-8× init holds ≥3.5
        # on EVERY solve — and the bad equilibrium persists (f64 identical),
        # so only a restart fixes it. Requiring 3 consecutive bad solves
        # rejects the bad equilibrium without tripping on transients;
        # clearState + re-init a few frames later recovers (the window
        # geometry changes).
        if (m is not None and self.solves_since_init <= 8
                and m.get("cost") is not None):
            bad = m["cost"] / max(m.get("n_pts", 0), 1) > 2.0
            self._init_bad_solves = (self._init_bad_solves + 1) if bad else 0
            if self._init_bad_solves >= 3:
                return True
        if np.linalg.norm(self.ba[nw]) > 2.5 or np.linalg.norm(self.bg[nw]) > 1.0:
            return True
        dp = self.p[nw] - self.p[nw - 1]
        if np.linalg.norm(dp) > 5.0 or abs(dp[2]) > 1.0:
            return True
        return False

    # ---------------------------------------------------------------- slide
    def _slide(self, flag: int):
        """`slideWindow()` — the prior itself was already computed inside the
        fused backend program (`_pending_prior`); this is pure host surgery."""
        nw = self.cfg.window_size
        if flag == MARGIN_OLD:
            self.prior = self._pending_prior
            p_wc, q_wc = self._cam_poses_np()
            old0_p, old0_q = p_wc[0].copy(), q_wc[0].copy()
            self._roll_states()
            self.pt_table.slide_old(old0_p, old0_q, p_wc[1], q_wc[1])
            self.ln_table.slide_old()
            self.imu_bufs.pop(1)
            self.pres.pop(1)
        else:
            if self.prior is not None:
                self.prior = self._pending_prior
            # merge interval (nw-1→nw) into (nw-2→nw-1): frame nw-1 dies
            merged = ImuBuffer.merged(self.imu_bufs[nw - 1], self.imu_bufs[nw])
            self.imu_bufs[nw - 1] = merged
            self.imu_bufs.pop(nw)
            self.pres.pop(nw)
            acc, gyr, dts = merged.padded(self.dtype)
            self.pres[nw - 1] = _preintegrate_padded(
                acc, gyr, dts,
                asdev(self.ba[nw - 2], self.dtype),
                asdev(self.bg[nw - 2], self.dtype),
                self.noise,
            )
            for arr in (self.p, self.q, self.v, self.ba, self.bg):
                arr[nw - 1] = arr[nw]
            self.timestamps[nw - 1] = self.timestamps[nw]
            self.td_pair[nw - 1] = self.td_pair[nw]
            self.pt_table.slide_new()
            self.ln_table.slide_new()
        # NOTE: the next interval's open ImuBuffer was already appended at
        # solve-dispatch time (deferred finalize must not lose samples)

    def _slide_uninitialized(self):
        """During failed initialization the reference always slides old."""
        p_wc, q_wc = self._cam_poses_np()
        old0_p, old0_q = p_wc[0].copy(), q_wc[0].copy()
        self._roll_states()
        self.pt_table.slide_old(old0_p, old0_q, p_wc[1], q_wc[1])
        self.ln_table.slide_old()
        self.imu_bufs.pop(1)
        self.pres.pop(1)
        self.imu_bufs.append(ImuBuffer())
        self.pres.append(None)

    def _roll_states(self):
        for name in ("p", "q", "v", "ba", "bg"):
            arr = getattr(self, name)
            arr[:-1] = arr[1:]
        self.timestamps[:-1] = self.timestamps[1:]
        self.td_pair[:-1] = self.td_pair[1:]

    # ---------------------------------------------------------------- output
    def window_points(self):
        """(ids, norm_obs [n,2], world_3d [n,3]) of triangulated features
        observed in the newest solved frame — the keyframe payload the
        reference published on `/keyframe_point` (SURVEY.md §3.3).

        Uses the PRE-slide solve snapshot captured by `_solve_odometry`
        (the table has already slid by the time callers run; the snapshot's
        world points came out of the fused backend bundle — no extra device
        readback here)."""
        self.finalize()
        if self._kf_snapshot is None:
            return np.zeros(0, np.int64), np.zeros((0, 2)), np.zeros((0, 3))
        ids, obs, p_w = self._kf_snapshot
        return ids, obs, p_w

    def latest_pose(self):
        self.finalize()
        k = self.cfg.window_size if self.initialized else max(min(self.frame_count, self.cfg.window_size) - 1, 0)
        return self.timestamps[k], self.p[k].copy(), self.q[k].copy()

    def imu_rate_pose(self):
        """IMU-rate propagated odometry — the newest slot as dead-reckoned by
        `process_imu` between solves (the reference's `predict()` →
        `pubLatestOdometry` high-rate output, SURVEY.md §2.3). Returns
        (p, q, v)."""
        k = min(self.frame_count, self.cfg.window_size)
        return self.p[k].copy(), self.q[k].copy(), self.v[k].copy()


def _preintegrate_padded(acc, gyr, dts, ba, bg, noise):
    pre = _preint_jit(acc, gyr, dts, ba, bg, noise)
    return {
        "alpha": pre.alpha, "beta": pre.beta, "gamma": pre.gamma, "jac": pre.jac,
        "sqrt_info": imu_ops.sqrt_info_from_cov(pre.cov), "dt_sum": pre.dt_sum,
        "ba": pre.ba, "bg": pre.bg,
    }


@jax.jit
def _preint_jit(acc, gyr, dts, ba, bg, noise):
    return imu_ops.preintegrate(acc, gyr, dts, ba, bg, noise)


@jax.jit
def _stack_pres_jit(pres: tuple):
    """Stack W per-interval preintegration dicts field-wise in one program."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *pres)


@jax.jit
def _world_points_jit(st, f):
    # one dispatch per keyframe instead of the ~20-op eager chain
    return res._world_points(st, f)


from functools import partial as _partial  # noqa: E402


@highest_matmul_precision
def backend_tick(st, f, solvable, tri_need, fb4, lneed, ln_active2,
                 lay, cfg, ee: bool, etd: bool, iters: int, marg_mode: str,
                 marg_old_flag=None):
    """The whole per-frame backend as composable device code: triangulation →
    window solve → marginalization → outlier/stats extraction. Un-jitted so
    it also chains inside larger programs (the offline burst scan in
    models/burst.py).

    marg_mode: 'old' (MARGIN_OLD), 'new' (MARGIN_SECOND_NEW with a live
    prior), 'none', or 'dynamic' — with 'dynamic', `marg_old_flag` (a traced
    0/1 scalar) selects old-vs-second-new via lax.cond at RUN time (the burst
    scan's keyframe decision is data-dependent).

    Returns (st_out, stats, prior, aux) with aux = dict(commit, lcommit,
    pt_valid, ln_solved, pt_err, ln_err, p_w)."""
    from plslam.models.state import cam_poses

    dtype = st.p.dtype
    lp = cfg.line_param
    # ---- FeatureManager::triangulate/triangulateLine at pre-solve poses ----
    p_wc, q_wc = cam_poses(st)
    inv_tri, ok = triangulate.triangulate_points(p_wc, q_wc, f.pt_obs, f.pt_mask, f.pt_start)
    okf = ok.astype(dtype)
    commit = tri_need * okf
    inv0 = jnp.where(commit > 0, inv_tri, st.inv_depth)
    inv0 = jnp.where((tri_need * (1.0 - okf) * fb4) > 0, 1.0 / 5.0, inv0)  # INIT_DEPTH
    L_tri, okl = triangulate.triangulate_lines(p_wc, q_wc, f.ln_obs, f.ln_mask, f.ln_start)
    oklf = okl.astype(dtype)
    lcommit = lneed * oklf
    line0 = jnp.where(lcommit[:, None] > 0, L_tri, st.line)
    # post-triangulation validity (used_in_solver / usable semantics).
    # f.pt_valid is the HOST used_in_solver mask (st.inv_depth is unusable
    # here: _device_state substitutes 0.2 for every non-positive depth, so
    # `st.inv_depth > 0` is vacuously true) — mirror the line path: gate on
    # previously-solved | newly-committed | INIT_DEPTH-fallback so failed
    # 2-3-obs triangulations never enter the solve at the 0.2 placeholder.
    fallback = tri_need * (1.0 - okf) * fb4
    pt_valid = solvable * jnp.maximum(f.pt_valid, jnp.maximum(commit, fallback))
    ln_solved = ln_active2 * jnp.maximum(f.ln_valid, lcommit)  # prev solved | new
    st = st._replace(inv_depth=inv0, line=line0)
    f = f._replace(pt_valid=pt_valid, ln_valid=ln_solved)

    if lp != "world":
        st = st._replace(line=res.lines_from_world(st, st.line, f.ln_start, lp))
    st_out, stats = solver_mod.optimize_window(
        st, f, lay, cfg, estimate_extrinsic=ee, estimate_td=etd, num_iters=iters)
    if lp != "world":
        st_out = st_out._replace(line=res.lines_to_world(st_out, f.ln_start, lp))

    if marg_mode == "old":
        prior = marg.marginalize_old(st_out, f, lay, cfg, groups=stats.groups)
    elif marg_mode == "new":
        prior = marg.marginalize_second_new(st_out, f, lay, cfg)
    elif marg_mode == "dynamic":
        prior = jax.lax.cond(
            marg_old_flag > 0,
            lambda: marg.marginalize_old(st_out, f, lay, cfg, groups=stats.groups),
            lambda: marg.marginalize_second_new(st_out, f, lay, cfg),
        )
    else:
        prior = None

    # ---- removeOutlier / removeLineOutlier gating metrics (from the solver's
    # carried residual groups — no re-evaluation) ----
    _, _, r_pt, r_ln, _ = stats.groups
    err_px = jnp.linalg.norm(r_pt, axis=-1) * 1.5  # whitened → pixels
    pt_err = jnp.max(jnp.where(f.pt_mask > 0, err_px, 0.0), axis=1)
    err_ln = jnp.max(jnp.abs(r_ln), axis=-1) * 1.5
    ln_err = jnp.max(jnp.where(f.ln_mask > 0, err_ln, 0.0), axis=1)

    p_w = res._world_points(st_out, f)  # keyframe payload (window_points)
    aux = dict(commit=commit, lcommit=lcommit, pt_valid=pt_valid,
               ln_solved=ln_solved, pt_err=pt_err, ln_err=ln_err, p_w=p_w)
    return st_out, stats, prior, aux


@_partial(jax.jit, static_argnames=("lay", "cfg", "ee", "etd", "iters", "marg_mode"))
def _backend_program(st, f, solvable, tri_need, fb4, lneed, ln_active2,
                     lay, cfg, ee: bool, etd: bool, iters: int, marg_mode: str):
    """`backend_tick` as ONE XLA program returning the prior (device
    -resident) plus ONE packed host bundle.

    One dispatch and one readback per frame: the former split path made
    ~10 device→host round trips per frame (triangulate pulls, 10-array
    writeback, outlier pulls)."""
    st_out, stats, prior, aux = backend_tick(
        st, f, solvable, tri_need, fb4, lneed, ln_active2,
        lay, cfg, ee, etd, iters, marg_mode)
    dtype = st_out.p.dtype
    commit, lcommit = aux["commit"], aux["lcommit"]
    pt_valid, ln_solved = aux["pt_valid"], aux["ln_solved"]
    pt_err, ln_err, p_w = aux["pt_err"], aux["ln_err"], aux["p_w"]

    bundle = jnp.concatenate([
        st_out.p.reshape(-1), st_out.q.reshape(-1), st_out.v.reshape(-1),
        st_out.ba.reshape(-1), st_out.bg.reshape(-1),
        st_out.p_bc, st_out.q_bc, st_out.td[None],
        st_out.relo_p, st_out.relo_q,
        st_out.inv_depth, st_out.line.reshape(-1),
        commit, lcommit, pt_valid, ln_solved,
        pt_err, ln_err, p_w.reshape(-1),
        jnp.stack([stats.cost0, stats.cost, stats.cost_robust0,
                   stats.cost_robust, stats.accepted.astype(dtype)]),
    ])
    return prior, bundle
