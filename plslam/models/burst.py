"""Offline burst mode: the REAL per-frame pipeline chained on device.

The streaming loop (`runner.run_euroc`) pays one device→host round trip per
published frame plus host feature-table surgery and ~30 H2D factor uploads
(what that costs on the GPU against the scanned chunk is not measured).

EuRoC evaluation is OFFLINE replay, so this module runs the REAL data flow —
point+line frontends → device-resident feature tables (`device_table.py`) →
factor assembly → triangulation → LM/Schur window solve → FEJ
marginalization → outlier gating → window slide — as ONE `lax.scan` over B
published frames per dispatch, with ONE packed readback per chunk. This is
SURVEY.md §7 hard parts #2 (fixed-shape dynamic state) and #4 (host/device
choreography) completed: nothing but images and IMU samples crosses
host→device, and only trajectory outputs cross back.

Semantics match the streaming loop operation-for-operation (same tick
bodies: `frontend_points._pt_programs` / `frontend_lines._ln_program` /
`estimator.backend_tick`; same table state machine — pinned by
tests/test_device_table.py and tests/test_burst.py). Known bounded
deviations, all documented where they occur:
  * the keyframe-decision branch (MARGIN_OLD vs SECOND_NEW) runs through
    `lax.cond`/masked selects instead of host control flow;
  * the newest-state initial guess comes from applying the interval's
    preintegration delta instead of per-sample host dead-reckoning — the
    same midpoint integrator, equal up to float association;
  * with `estimate_td`, the IMU pairing uses the chunk-start td (streaming
    re-pairs per frame). The factors record that pairing td per frame
    (`td_pair` carry → `pt_td_ref`), so the solver corrects only the
    REMAINING (td − td_pair) exactly like streaming — the deviation is
    just a ≤1-chunk lag in the pairing point, bounded by
    tests/test_burst.py::test_burst_with_estimate_td; exact when
    estimate_td is off;
  * loop closure runs at CHUNK granularity: each step emits the keyframe
    payload (window points as pixel uv + world 3D + ids — the reference's
    `/keyframe_pose` + `/keyframe_point` topics) in the chunk readback, and
    the host runs place recognition + PnP + 4-DoF PGO on every keyframe of
    the chunk after it lands (`runner._burst_tail`). This matches the
    reference's ASYNCHRONOUS pose-graph thread, which also processed
    keyframes several frames behind the estimator; drift corrections apply
    from the next chunk on. When a loop wants the relocalization round trip
    (joint relo solve → refined edge), the burst hands back to streaming for
    it and re-enters afterwards — relo factors are a window-solve feature,
    not a scan feature.

Reference lineage: one `process()` iteration of `estimator_node.cpp`
(SURVEY.md §3.3) is the scanned unit.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from plslam.models import device_table as dtab
from plslam.models import marginalization as marg
from plslam.models import residuals as res
from plslam.models.estimator import IMU_PAD, backend_tick
from plslam.ops import cameras
from plslam.models.state import WindowState, cam_poses, layout, zero_state
from plslam.ops import imu as imu_ops
from plslam.utils.geometry import quat_mul, quat_rotate

PT_KEY_SEED = 7  # FrontendPoints._key seed — must match for equivalence


class BurstCarry(NamedTuple):
    pt_fe: tuple  # (uv, valid, norm, ids, cnt, next_id)
    pyr: tuple  # previous image pyramid
    ln_fe: tuple  # (segs, desc, valid_f, ids, next_id)
    frame_i: jnp.ndarray  # int32 RNG fold counter (continues the stream's)
    st: WindowState
    ptab: dtab.DevPointTable
    ltab: dtab.DevLineTable
    prior: marg.Prior
    imu: dict  # factor-side preintegrations: alpha[W,3] … valid[W]
    raw_acc: jnp.ndarray  # [IMU_PAD+1,3] raw samples of interval at slot W-2
    raw_gyr: jnp.ndarray
    raw_dts: jnp.ndarray  # [IMU_PAD]
    raw_n: jnp.ndarray  # [] int32
    td_pair: jnp.ndarray  # [NW] per-slot IMU-pairing td (ProjectionTdFactor td_i)
    fail: jnp.ndarray  # [] bool — sticky failureDetection latch


def _tree_where(c, a, b):
    return jax.tree.map(lambda x, y: jnp.where(c, x, y) if x.ndim == 0
                        else jnp.where(jnp.reshape(c, (1,) * x.ndim), x, y), a, b)


def _pre_fields(pre):
    return {
        "alpha": pre.alpha, "beta": pre.beta, "gamma": pre.gamma,
        "jac": pre.jac, "sqrt_info": imu_ops.sqrt_info_from_cov(pre.cov),
        "dt_sum": pre.dt_sum, "ba": pre.ba, "bg": pre.bg,
    }


@lru_cache(maxsize=None)
def _burst_program(cfg, pt_statics: tuple, ln_statics: tuple, stride: int,
                   with_lines: bool, ee: bool, etd: bool, fe_dtype, dtype):
    """Build the chunked burst program once per static configuration.

    pt_statics: (cell, N, fisheye, mask_img)  — _pt_programs key.
    ln_statics: (max_lines, octaves, binary)  — _ln_program key.
    fe_dtype: the FRONTEND dtype (f32 in deployment); `dtype` the backend's —
    the streaming path runs the same split, casting at the publish boundary.
    """
    from plslam.models.frontend_lines import _ln_program
    from plslam.models.frontend_points import _pt_programs

    lay = layout(cfg)
    W = cfg.window_size
    NW = W + 1
    iters = cfg.max_num_iterations
    min_par = cfg.keyframe_parallax / cfg.focal_length
    pt_progs = _pt_programs(*pt_statics, fe_dtype)
    pt_tick, pt_light = pt_progs[2], pt_progs[3]
    ln_tick = _ln_program(*ln_statics, fe_dtype)[1] if with_lines else None
    base_key = jax.random.PRNGKey(PT_KEY_SEED)

    def step(consts, carry: BurstCarry, inp):
        cam, f_thresh, min_score, fov_mask, noise, g = consts
        imgs, img_dts, npre, acc, gyr, dts, n_imu, td0 = inp

        # --------------- frontends: track every camera frame -----------------
        # the stream publishes the FIRST frame of each stride group
        # (`publish = k % stride == 0`); the later frames run the LIGHT
        # track-only tick (pyramid + LK, no RANSAC/detect — the reference's
        # non-PUB_THIS_FRAME work split), and the line pass runs on the
        # published frame only (the reference's line node FREQ-throttles the
        # whole LSD+LBD pass) — identical to the streaming loop
        pyr, pt_fe, ln_fe = carry.pyr, carry.pt_fe, carry.ln_fe
        pt_bundle = ln_out = None
        for s in range(stride):
            from plslam.models.frontend_points import dev_image

            img_s = dev_image(imgs[s], fe_dtype)  # uint8 H2D → f32 on device
            if s == 0:
                key = jax.random.fold_in(base_key, carry.frame_i)
                pyr, pt_fe, pt_bundle = pt_tick(
                    cam, pyr, img_s, pt_fe, f_thresh, key, img_dts[0],
                    min_score, fov_mask)
                if with_lines:
                    ln_fe, ln_out = ln_tick(cam, img_s, pyr[1], True, *ln_fe)
            else:
                pyr, pt_fe = pt_light(cam, pyr, img_s, pt_fe, fov_mask)
        frame_i = carry.frame_i + stride

        # ------------- publish: table insertion at the newest column ---------
        # (cast at the frontend→backend boundary, like the streaming unpack)
        bf, pt_ids = pt_bundle
        fe_norm, fe_vel = bf[:, 2:4].astype(dtype), bf[:, 4:6].astype(dtype)
        fe_valid = (bf[:, 6] > 0) & (pt_ids >= 0)
        ptab = dtab.pt_add_frame(carry.ptab, W, pt_ids, fe_norm, fe_vel, fe_valid)
        if with_lines:
            lb, ln_ids = ln_out
            ln_valid = (lb[:, 4] > 0) & (ln_ids >= 0)
            ltab = dtab.ln_add_frame(carry.ltab, W, ln_ids,
                                     lb[:, 0:4].astype(dtype), ln_valid)
        else:
            ltab = carry.ltab

        long_tracked = jnp.sum(((ptab.mask[:, W] > 0)
                                & (jnp.sum(ptab.mask, axis=1) >= 2)).astype(jnp.int32))

        # --------------------------- keyframe decision ------------------------
        kf = dtab.pt_parallax_keyframe(ptab, W, min_par)
        # IMU_PAD overflow on a SECOND_NEW merge forces a keyframe (estimator
        # process_frame does the same)
        kf = kf | (carry.raw_n + n_imu > IMU_PAD)

        # --------------- close the interval + predict the newest slot --------
        # npre was preintegrated OUTSIDE the scan (vmapped over the chunk) at
        # the chunk-start bias: a 512-step sequential scan per frame INSIDE
        # the scan dominated the wall clock (measured: burst slower than
        # streaming). The factor corrects to the live bias to first order via
        # its stored jacobian — the same mechanism that makes the streaming
        # path's one-solve-stale linearization bias exact — and the predictor
        # applies the identical correction by hand here.
        st = carry.st
        dt = npre["dt_sum"]
        dba = st.ba[W] - npre["ba"]
        dbg = st.bg[W] - npre["bg"]
        J = npre["jac"]
        alpha_c = npre["alpha"] + J[0:3, 9:12] @ dba + J[0:3, 12:15] @ dbg
        beta_c = npre["beta"] + J[6:9, 9:12] @ dba + J[6:9, 12:15] @ dbg
        dth = J[3:6, 12:15] @ dbg
        gamma_c = quat_mul(npre["gamma"],
                           jnp.concatenate([jnp.ones((1,), dtype), 0.5 * dth]))
        Rq = lambda q, v: quat_rotate(q, v)
        p_pred = st.p[W] + st.v[W] * dt - 0.5 * g * dt * dt + Rq(st.q[W], alpha_c)
        v_pred = st.v[W] - g * dt + Rq(st.q[W], beta_c)
        q_pred = quat_mul(st.q[W], gamma_c)
        q_pred = q_pred / jnp.maximum(jnp.linalg.norm(q_pred), 1e-12)
        st = st._replace(p=st.p.at[W].set(p_pred), q=st.q.at[W].set(q_pred),
                         v=st.v.at[W].set(v_pred))

        imu_f = dict(carry.imu)
        for k in npre:
            imu_f[k] = imu_f[k].at[W - 1].set(npre[k])
        imu_f["valid"] = imu_f["valid"].at[W - 1].set(1.0)

        # ------------------------- factor assembly ---------------------------
        # this frame's IMU pairing used the chunk-start td (td0 input)
        td_pair = carry.td_pair.at[W].set(td0)
        f = res.empty_factors(cfg, lay, dtype)
        f = f._replace(
            imu_alpha=imu_f["alpha"], imu_beta=imu_f["beta"],
            imu_gamma=imu_f["gamma"], imu_jac=imu_f["jac"],
            imu_sqrt_info=imu_f["sqrt_info"], imu_dt=imu_f["dt_sum"],
            imu_ba=imu_f["ba"], imu_bg=imu_f["bg"], imu_valid=imu_f["valid"],
            g=g,
            pt_obs=ptab.obs, pt_vel=ptab.vel, pt_mask=ptab.mask,
            pt_start=ptab.start, pt_td_ref=td_pair,
            ln_obs=ltab.obs, ln_mask=ltab.mask, ln_start=ltab.start,
        )
        active = ptab.ids >= 0
        nobs = jnp.sum(ptab.mask, axis=1)
        solvable = (active & (nobs >= 2)).astype(dtype)
        used = (active & (ptab.inv_depth > 0) & (nobs >= 2)).astype(dtype)
        tri_need = solvable * (ptab.inv_depth <= 0)
        fb4 = (nobs >= 4).astype(dtype)
        lactive = ltab.ids >= 0
        lobs = jnp.sum(ltab.mask, axis=1)
        ln_active2 = (lactive & (lobs >= 2)).astype(dtype)
        lneed = ln_active2 * (1.0 - ltab.solved)
        f = f._replace(pt_valid=used, ln_valid=ln_active2 * ltab.solved)
        f = marg.install_prior(f, carry.prior)
        st = st._replace(
            inv_depth=jnp.where(ptab.inv_depth > 0, ptab.inv_depth, 0.2),
            line=ltab.line_w,
        )

        # ------------------- solve + marginalize (backend) -------------------
        st_out, stats, prior_new, aux = backend_tick(
            st, f, solvable, tri_need, fb4, lneed, ln_active2,
            lay, cfg, ee, etd, iters, "dynamic",
            marg_old_flag=kf.astype(dtype))

        # ------------- post-solve table updates (_finish_solve) --------------
        ptv = aux["pt_valid"] > 0
        inv = st_out.inv_depth
        ptab = ptab._replace(inv_depth=jnp.where(ptv, inv, ptab.inv_depth))
        drop = (ptv & (inv <= 0)) | (ptv & (aux["pt_err"] > 10.0))
        ptab = dtab._pt_clear_where(ptab, drop)
        ltab = ltab._replace(
            solved=jnp.maximum(ltab.solved, aux["lcommit"]),
            line_w=st_out.line,
        )
        dropl = (aux["ln_solved"] > 0) & (aux["ln_err"] > 10.0)
        ltab = dtab._ln_clear_where(ltab, dropl)

        # ------------------------- failure detection -------------------------
        dp = st_out.p[W] - st_out.p[W - 1]
        fail_now = ((long_tracked < 2)
                    | (jnp.linalg.norm(st_out.ba[W]) > 2.5)
                    | (jnp.linalg.norm(st_out.bg[W]) > 1.0)
                    | (jnp.linalg.norm(dp) > 5.0) | (jnp.abs(dp[2]) > 1.0))
        fail = carry.fail | fail_now

        # ------------------------------ slides --------------------------------
        # ONE branch executes per step (lax.cond, not compute-both-and-select:
        # the slide of the ~35-leaf st/ptab/ltab/imu carry is pure data
        # movement; computing both branches and selecting costs the data
        # movement of both — scripts/profile_burst.py ablates it)
        def _slide_old():
            roll1 = lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0)
            st_old = st_out._replace(
                p=roll1(st_out.p), q=roll1(st_out.q), v=roll1(st_out.v),
                ba=roll1(st_out.ba), bg=roll1(st_out.bg))
            p_wc, q_wc = cam_poses(st_out)
            ptab_old = dtab.pt_slide_old(ptab, p_wc[0], q_wc[0], p_wc[1], q_wc[1])
            ltab_old = dtab.ln_slide_old(ltab)
            imu_old = {k: jnp.concatenate([v[1:], v[-1:]], axis=0)
                       for k, v in imu_f.items()}
            td_pair_old = jnp.concatenate([td_pair[1:], td_pair[-1:]])
            return (st_old, ptab_old, ltab_old, imu_old,
                    acc, gyr, dts, n_imu, td_pair_old)

        def _slide_new():
            copy_new = lambda a: a.at[W - 1].set(a[W])
            st_new = st_out._replace(
                p=copy_new(st_out.p), q=copy_new(st_out.q), v=copy_new(st_out.v),
                ba=copy_new(st_out.ba), bg=copy_new(st_out.bg))
            # merge raw samples: (W-2→W-1) ⊕ (W-1→W) — ImuBuffer.merged —
            # and re-preintegrate the merged interval (runs ONLY on
            # SECOND_NEW steps now that the whole slide is branch-selected)
            i1 = jnp.arange(IMU_PAD + 1)
            n1 = carry.raw_n
            take2 = jnp.clip(i1 - n1, 0, IMU_PAD)
            acc_m = jnp.where((i1 <= n1)[:, None], carry.raw_acc, acc[take2])
            gyr_m = jnp.where((i1 <= n1)[:, None], carry.raw_gyr, gyr[take2])
            i0 = jnp.arange(IMU_PAD)
            dts_m = jnp.where(i0 < n1, carry.raw_dts,
                              dts[jnp.clip(i0 - n1, 0, IMU_PAD - 1)])
            n_m = jnp.minimum(n1 + n_imu, IMU_PAD)
            mf = _pre_fields(imu_ops.preintegrate(
                acc_m, gyr_m, dts_m, st_new.ba[W - 2], st_new.bg[W - 2], noise))
            imu_new = dict(imu_f)
            for k in mf:
                imu_new[k] = imu_new[k].at[W - 2].set(mf[k])
            imu_new["valid"] = imu_new["valid"].at[W - 2].set(1.0)
            ptab_new = dtab.pt_slide_new(ptab)
            ltab_new = dtab.ln_slide_new(ltab)
            td_pair_new = td_pair.at[W - 1].set(td_pair[W])
            return (st_new, ptab_new, ltab_new, imu_new,
                    acc_m, gyr_m, dts_m, n_m, td_pair_new)

        (st_s, ptab_s, ltab_s, imu_s, racc_s, rgyr_s, rdts_s, rn_s,
         td_pair_s) = jax.lax.cond(kf, _slide_old, _slide_new)
        new_carry = BurstCarry(
            pt_fe=pt_fe, pyr=pyr, ln_fe=ln_fe, frame_i=frame_i,
            st=st_s, ptab=ptab_s, ltab=ltab_s, prior=prior_new, imu=imu_s,
            raw_acc=racc_s, raw_gyr=rgyr_s, raw_dts=rdts_s, raw_n=rn_s,
            td_pair=td_pair_s, fail=fail,
        )
        # sticky failure: freeze the estimator state, keep the frontends
        # ticking (streaming clears + re-initializes on the host — the chunk
        # driver detects the flag and falls back)
        frozen = BurstCarry(
            pt_fe=pt_fe, pyr=pyr, ln_fe=ln_fe, frame_i=frame_i,
            st=carry.st, ptab=carry.ptab, ltab=carry.ltab, prior=carry.prior,
            imu=carry.imu, raw_acc=carry.raw_acc, raw_gyr=carry.raw_gyr,
            raw_dts=carry.raw_dts, raw_n=carry.raw_n,
            td_pair=carry.td_pair, fail=fail,
        )
        out_carry = jax.tree.map(
            lambda a, b: _tree_where(carry.fail, a, b), frozen, new_carry)
        # keyframe payload (window_points → the reference's /keyframe_point):
        # solved, outlier-surviving points observed in the newest frame, as
        # pixel uv (for BRIEF) + world 3D + global ids. Rides the chunk
        # readback (B×MF×6 floats), so loop closure costs no extra round
        # trips.
        kf_pts = ptv & ~drop & (ptab.mask[:, W] > 0) & (ptab.ids >= 0)
        uv_px = cameras.normalized_to_pixel(cam, ptab.obs[:, W])
        out = (st_out.p[W], st_out.q[W], kf, stats.cost, fail,
               long_tracked, jnp.sum(aux["pt_valid"]), st_out.td,
               ptab.ids, kf_pts, uv_px, aux["p_w"])
        return out_carry, out

    @jax.jit
    def chunk(consts, carry, inputs):
        imgs, img_dts, acc, gyr, dts, n_imu, td0s = inputs
        noise = consts[4]
        # one VMAPPED preintegration pass for the whole chunk (B-wide batched
        # 512-step scan ≈ the cost of ONE interval) at the chunk-start bias;
        # factors + predictor bias-correct to the live estimate (see step)
        ba0 = carry.st.ba[W - 1]
        bg0 = carry.st.bg[W - 1]
        pres = jax.vmap(
            lambda a, gy, d: _pre_fields(imu_ops.preintegrate(a, gy, d, ba0, bg0, noise))
        )(acc, gyr, dts)
        return jax.lax.scan(lambda c, i: step(consts, c, i), carry,
                            (imgs, img_dts, pres, acc, gyr, dts, n_imu, td0s))

    return chunk


# --------------------------------------------------------------- host driver
class ImuChunkPacker:
    """ImuFeeder's measurement pairing (boundary-interpolated at t_img + td —
    SURVEY.md §3.3 `getMeasurements`) producing PADDED per-interval arrays
    for the burst scan instead of feeding an estimator."""

    def __init__(self, imu_t, acc, gyr, i0, prev_t, prev_acc, prev_gyr):
        self.t = np.asarray(imu_t, np.float64)
        self.acc = np.asarray(acc, np.float64)
        self.gyr = np.asarray(gyr, np.float64)
        self.i = i0
        self.prev_t = prev_t
        self.prev_acc = prev_acc
        self.prev_gyr = prev_gyr

    def interval(self, t_img, td):
        """Padded (acc [PAD+1,3], gyr [PAD+1,3], dts [PAD], n) for the
        interval ending at t_img+td, seeded with the previous boundary."""
        t_b = float(t_img) + float(td)
        accs = [self.prev_acc]
        gyrs = [self.prev_gyr]
        ts = [self.prev_t]
        n = len(self.t)
        while self.i < n and self.t[self.i] < t_b - 1e-9:
            accs.append(self.acc[self.i])
            gyrs.append(self.gyr[self.i])
            ts.append(self.t[self.i])
            self.i += 1
        if self.i < n:
            t1 = self.t[self.i]
            if t1 <= t_b + 1e-9:
                accs.append(self.acc[self.i])
                gyrs.append(self.gyr[self.i])
                ts.append(t1)
                self.i += 1
            else:
                w = (t_b - ts[-1]) / (t1 - ts[-1])
                accs.append((1.0 - w) * accs[-1] + w * self.acc[self.i])
                gyrs.append((1.0 - w) * gyrs[-1] + w * self.gyr[self.i])
                ts.append(t_b)
        self.prev_t, self.prev_acc, self.prev_gyr = ts[-1], accs[-1], gyrs[-1]
        m = min(len(ts) - 1, IMU_PAD)
        acc_p = np.zeros((IMU_PAD + 1, 3))
        gyr_p = np.zeros((IMU_PAD + 1, 3))
        dts_p = np.zeros(IMU_PAD)
        acc_p[: m + 1] = np.stack(accs[: m + 1])
        gyr_p[: m + 1] = np.stack(gyrs[: m + 1])
        acc_p[m + 1:] = acc_p[m]
        gyr_p[m + 1:] = gyr_p[m]
        dts_p[:m] = np.diff(ts[: m + 1])
        return acc_p, gyr_p, dts_p, m


def make_carry(est, fp, fl, dtype) -> BurstCarry:
    """Hand the streaming estimator + frontends over to the burst scan."""
    nw = est.cfg.window_size
    if fl is not None:
        ln_fe = fl.prev
    else:  # lines off: a minimal placeholder pytree (never read)
        fe_dtype = fp.dtype
        ln_fe = (jnp.zeros((1, 4), fe_dtype), jnp.zeros((1, 1), fe_dtype),
                 jnp.zeros((1,), fe_dtype), jnp.full((1,), -1, jnp.int32),
                 jnp.zeros((), jnp.int32))
    st = est._device_state()
    # carry tables hold the RAW host truth (negative inv_depth = unsolved);
    # the per-step assembly applies the 0.2 substitution itself
    ptab = dtab.from_host_point_table(est.pt_table, dtype)
    ltab = dtab.from_host_line_table(est.ln_table, est.line_w, dtype)
    f = est._factors()
    imu = {"alpha": f.imu_alpha, "beta": f.imu_beta, "gamma": f.imu_gamma,
           "jac": f.imu_jac, "sqrt_info": f.imu_sqrt_info, "dt_sum": f.imu_dt,
           "ba": f.imu_ba, "bg": f.imu_bg, "valid": f.imu_valid}
    buf = est.imu_bufs[nw - 1]
    acc_p, gyr_p, dts_p = buf.padded(dtype)
    if est.prior is None:
        raise ValueError("burst handoff requires a live marginalization prior")
    return BurstCarry(
        pt_fe=fp._state, pyr=tuple(fp.prev_pyr), ln_fe=ln_fe,
        frame_i=jnp.asarray(fp._frame_i, jnp.int32),
        st=st, ptab=ptab, ltab=ltab, prior=est.prior, imu=imu,
        raw_acc=acc_p, raw_gyr=gyr_p, raw_dts=dts_p,
        raw_n=jnp.asarray(len(buf.dt), jnp.int32),
        td_pair=jnp.asarray(est.td_pair, dtype),
        fail=jnp.asarray(False),
    )


def sync_back(est, fp, fl, carry: BurstCarry, last_t: float, ts_win=None):
    """Write the burst carry back into the host estimator + frontends so
    streaming (or checkpoint/save) can continue from where the burst ended.

    The factor-side state must come back COMPLETE: window states, feature
    tables, the marginalization prior, AND the per-interval preintegrations
    (`est.pres`) + the newest closed interval's raw samples (`est.imu_bufs`,
    for a SECOND_NEW merge right after handback). Omitting the
    preintegrations left the streamed solves running against the PRE-burst
    IMU factors — measured: the first post-handback solve saw cost0 ≈ 8e5
    and the trajectory walked off at ~0.27 m/frame while the stale window
    flushed (burst-vs-streaming divergence was ≤1.1 cm up to that point)."""
    from plslam.models.estimator import ImuBuffer
    from plslam.utils.device import pull_all

    nw = est.cfg.window_size
    (p, q, v, ba, bg, p_bc, q_bc, td, raw_acc, raw_gyr, raw_dts, raw_n,
     imu_valid, td_pair) = [
        np.asarray(x) for x in pull_all(
            carry.st.p, carry.st.q, carry.st.v, carry.st.ba, carry.st.bg,
            carry.st.p_bc, carry.st.q_bc, carry.st.td,
            carry.raw_acc, carry.raw_gyr, carry.raw_dts, carry.raw_n,
            carry.imu["valid"], carry.td_pair)]
    est.p, est.q, est.v, est.ba, est.bg = [
        a.astype(np.float64) for a in (p, q, v, ba, bg)]
    est.p_bc, est.q_bc, est.td = p_bc.astype(np.float64), q_bc.astype(np.float64), float(td)
    est.td_pair[:] = td_pair.astype(np.float64)
    pt_pulled = jax.tree.map(np.asarray, carry.ptab)
    dtab.to_host_point_table(est.pt_table, pt_pulled)
    if fl is not None:
        ln_pulled = jax.tree.map(np.asarray, carry.ltab)
        est.line_w = dtab.to_host_line_table(est.ln_table, ln_pulled)
    est.prior = carry.prior
    # factor-side preintegrations: carry row i = interval (i→i+1) post-slide,
    # rows 0..W-2 closed ↦ est.pres[1..W-1]; est.pres[W] is the OPEN interval
    # (row W-1 is a stale duplicate the next step would overwrite)
    keys = ("alpha", "beta", "gamma", "jac", "sqrt_info", "dt_sum", "ba", "bg")
    est.pres = [None] + [
        ({k: carry.imu[k][i] for k in keys} if imu_valid[i] > 0 else None)
        for i in range(nw - 1)
    ] + [None]
    # raw samples of the newest closed interval (the SECOND_NEW merge source;
    # older intervals' raw buffers are represented only by their
    # preintegrations — exactly what the factors need)
    n_raw = int(raw_n)
    newest = ImuBuffer()
    newest.acc = [raw_acc[i].astype(np.float64) for i in range(n_raw + 1)]
    newest.gyr = [raw_gyr[i].astype(np.float64) for i in range(n_raw + 1)]
    newest.dt = [float(d) for d in raw_dts[:n_raw]]
    est.imu_bufs = [ImuBuffer() for _ in range(nw - 1)] + [newest, ImuBuffer()]
    if ts_win is not None:
        # per-slot timestamps tracked on the HOST by the chunk driver (the
        # publish times + keyframe flags fully determine the slide; f32
        # device stamps would lose ~100 s of precision on epoch-scale EuRoC
        # times) — checkpoint/save right after handback stores true stamps
        est.timestamps[:] = np.asarray(ts_win, np.float64)
    else:
        est.timestamps[:] = last_t  # fallback: newest stamp everywhere
    fp._state = carry.pt_fe
    fp.prev_pyr = list(carry.pyr)
    fp._frame_i = int(carry.frame_i)
    fp.prev_t = last_t
    if fl is not None:
        fl.prev = carry.ln_fe
