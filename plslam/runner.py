"""Sequence runners: drive the estimator over a dataset.

Replaces the reference's roslaunch graph + `estimator_node.cpp` callback
plumbing (SURVEY.md §3.3) with a synchronous host loop. The synthetic runner
uses ground-truth feature associations (a perfect frontend) — isolating
backend accuracy exactly the way the reference never could; the full runner
plugs in the real tracker frontends.
"""
from __future__ import annotations

import numpy as np

from plslam.config import PLSlamConfig
from plslam.io.synthetic import SyntheticSequence
from plslam.models.estimator import Estimator


class ImuFeeder:
    """`getMeasurements` measurement pairing (SURVEY.md §3.3 / :119): feed the
    estimator every IMU sample strictly before `t_img + td`, then ONE boundary
    sample linearly interpolated exactly AT `t_img + td` — so each keyframe
    interval's preintegration spans exactly the (td-shifted) frame gap instead
    of snapping to the sample grid (up to ±half an IMU period of error
    otherwise). td is read live from the estimator at every frame, so online
    td estimation shifts the pairing just like the reference's
    `estimator_node.cpp::getMeasurements`."""

    def __init__(self, imu_t, acc, gyr):
        self.t = np.asarray(imu_t, np.float64)
        self.acc = np.asarray(acc, np.float64)
        self.gyr = np.asarray(gyr, np.float64)
        self.i = 0
        self.prev_t = None
        self.prev_acc = None
        self.prev_gyr = None

    def _feed(self, est, t, acc, gyr):
        dt = (t - self.prev_t) if self.prev_t is not None else 0.005
        est.process_imu(dt, acc, gyr)
        self.prev_t, self.prev_acc, self.prev_gyr = t, acc, gyr

    def feed_until(self, est, t_img):
        """Feed samples up to the interpolated boundary at t_img + est.td."""
        t_b = float(t_img) + float(est.td)
        n = len(self.t)
        while self.i < n and self.t[self.i] < t_b - 1e-9:
            self._feed(est, self.t[self.i], self.acc[self.i], self.gyr[self.i])
            self.i += 1
        if self.i >= n:
            return  # stream ended before the boundary — nothing to interpolate
        t1 = self.t[self.i]
        if t1 <= t_b + 1e-9:
            # a sample lies exactly on the boundary — consume it verbatim
            self._feed(est, t1, self.acc[self.i], self.gyr[self.i])
            self.i += 1
            return
        if self.prev_t is None:
            return  # boundary precedes the first IMU sample
        # linear interpolation between the last fed sample and sample i; the
        # un-consumed sample i opens the next interval with dt = t1 − t_b
        w = (t_b - self.prev_t) / (t1 - self.prev_t)
        acc_b = (1.0 - w) * self.prev_acc + w * self.acc[self.i]
        gyr_b = (1.0 - w) * self.prev_gyr + w * self.gyr[self.i]
        self._feed(est, t_b, acc_b, gyr_b)


def run_euroc(
    seq_path: str,
    config: PLSlamConfig | None = None,
    use_lines: bool = True,
    loop_closure: bool | None = None,
    max_frames: int | None = None,
    progress: bool = False,
    pipeline: bool = True,
    burst: int = 0,
    record_tracks: dict | None = None,
):
    """Full pipeline on an EuRoC ASL sequence: image frontends → estimator →
    pose graph (the whole reference launch graph in one loop — SURVEY.md §1).

    `pipeline=True` software-pipelines the host IO stage: frame k+1's PNG
    decode + CLAHE run on a worker thread (the native decoder releases the
    GIL) while frame k's frontends + backend solve run — the PP row of
    SURVEY.md §2.6, replacing the reference's feature_tracker/estimator
    process overlap. Outputs are bit-identical to the synchronous loop (the
    pipeline only moves WHEN images are decoded, never what is computed).

    `burst=B` (offline replay only): once initialized, process B published
    frames per device dispatch — the REAL pipeline (frontends →
    device-resident feature tables → solve → marginalization → slide) as a
    `lax.scan` with ONE readback per chunk (`models/burst.py`), instead of
    one round trip per frame. Loop closure works in burst mode: keyframe
    payloads ride the chunk readback and place recognition + PnP + 4-DoF PGO
    run per chunk on the host — the cadence of the reference's asynchronous
    pose-graph thread; a loop that wants the relocalization round trip hands
    back to streaming for the joint solve and burst re-enters after. Live
    viz still forces streaming (it is a per-frame host consumer). Outputs
    are equal to the streaming loop up to float association (documented
    bounded deviations in models/burst.py).

    Returns (ts, ps, qs, estimator, pose_graph)."""
    import jax.numpy as jnp

    from plslam.io.euroc import EurocSequence
    from plslam.models.frontend_lines import FrontendLines
    from plslam.models.frontend_points import FrontendPoints
    from plslam.models.pose_graph import PoseGraph
    from plslam.ops.cameras import make_camera

    config = config or PLSlamConfig()
    loop_closure = config.loop.loop_closure if loop_closure is None else loop_closure
    seq = EurocSequence.load(seq_path)
    # CameraFactory dispatch on model_type (PINHOLE / KANNALA_BRANDT / MEI /
    # SCARAMUZZA) — every downstream consumer goes through the generic
    # lift/project interface, so the whole pipeline follows the model
    cam = make_camera(config.camera)
    est = Estimator(config)
    # the reference loads `fisheye_mask.jpg` (nonzero = usable FOV); absent a
    # file, `fisheye: 1` falls back to the standard centered circle
    fisheye_mask = None
    if config.tracker.fisheye and config.tracker.fisheye_mask:
        from plslam.io import native

        fisheye_mask = native.load_png_gray(config.tracker.fisheye_mask)
        if fisheye_mask is None:
            import sys

            print(f"warning: could not load fisheye_mask "
                  f"{config.tracker.fisheye_mask!r}; using centered circle",
                  file=sys.stderr)
    fp = FrontendPoints(cam, max_cnt=config.tracker.max_cnt,
                        min_dist=config.tracker.min_dist,
                        f_thresh_px=config.tracker.f_threshold,
                        focal=config.camera.fx,  # px→normalized via the real camera
                        min_score=config.tracker.min_score,
                        fisheye=config.tracker.fisheye,
                        fisheye_mask=fisheye_mask)
    fLines = FrontendLines(cam, max_lines=config.tracker.max_lines,
                           binary_desc=config.tracker.line_desc == "binary") if use_lines else None
    pgraph = PoseGraph(config.loop, focal=config.solver.focal_length,
                       R_bc=np.asarray(config.extrinsic.rot).reshape(3, 3),
                       p_bc=np.asarray(config.extrinsic.trans)) if loop_closure else None
    viz = None
    if config.tracker.show_track:
        from plslam.eval.viz import TrackVisualizer

        viz = TrackVisualizer(config.output_path, every=4)
        if pgraph is not None:
            pgraph.keep_images = True  # enables the loop match_image dump
    if pgraph is not None and config.loop.load_previous_pose_graph:
        import os

        pg_file = config.loop.pose_graph_save_path
        if os.path.isdir(pg_file):
            pg_file = os.path.join(pg_file, "pose_graph.npz")
        if os.path.exists(pg_file):
            pgraph.load(pg_file)

    # FREQ control: like the reference's feature_tracker_node, the frontends
    # track EVERY camera frame (20 Hz — consecutive-frame LK keeps per-tick
    # optical flow inside the tracker's capture range) but only PUBLISH to the
    # estimator every `stride`th frame (`FREQ`≈10 Hz, SURVEY.md §2.1/§3.1)
    stride = max(1, round(20 / config.tracker.freq))
    n_pub = 0
    max_pub = max_frames if max_frames is not None else len(seq.cam_t)

    def _load(k):
        img = seq.image(k)
        return _clahe(img) if config.tracker.equalize else img

    executor = None
    pending = None
    if pipeline:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1)
        pending = executor.submit(_load, 0)

    ts_out, ps_out, qs_out = [], [], []
    feeder = ImuFeeder(seq.imu_t, seq.imu_acc, seq.imu_gyr)
    deferred_ctx = None
    relo_edge = {"ij": None}  # loop edge awaiting the refined relative pose

    def _emit(ctx):
        """Trajectory + pose-graph output work for a published frame (runs
        one published frame later in pipeline mode — `est.latest_pose()`
        finalizes the deferred solve)."""
        m, img_k = ctx
        est.finalize()
        # relocalization round trip CLOSED (`updateKeyFrameLoop`): the joint
        # solve's BA-refined old-keyframe pose replaces the raw PnP loop-edge
        # measurement, then the 4-DoF PGO re-runs on the refined edge
        if pgraph is not None and est.relo_result is not None and relo_edge["ij"] is not None:
            oi, cj = relo_edge["ij"]
            pgraph.update_loop_edge(oi, cj, est.relo_result["p_old"],
                                    est.relo_result["q_old"])
            relo_edge["ij"] = None
            est.relo_result = None
        elif relo_edge["ij"] is not None and est.relo is None and est.relo_result is None:
            # the pending round trip died (failure detection ran clear_state,
            # wiping est.relo/relo_result) — clear the edge so the raw PnP
            # measurement stands and burst mode can re-enter after recovery
            relo_edge["ij"] = None
        # emit only frames that were actually solved (the serial loop's
        # `if est.initialized` gate, evaluated at the frame's own time)
        if "cost" not in m or m.get("failure") or not est.initialized:
            return
        tt, p, q = est.latest_pose()
        if pgraph is not None and m.get("keyframe"):
            ids_w, norm_w, pts3d_w = est.window_points()
            from plslam.ops.cameras import normalized_to_pixel

            uv_w = None
            if len(ids_w):
                # fixed-shape projection (a per-keyframe point count would
                # recompile normalized_to_pixel for every distinct count)
                mf = config.solver.max_features
                buf = np.zeros((mf, 2))
                buf[: len(ids_w)] = norm_w
                uv_all = np.asarray(
                    normalized_to_pixel(cam, jnp.asarray(buf, jnp.float32)), np.float64)
                uv_w = uv_all[: len(ids_w)]
            loop = pgraph.add_keyframe(
                tt, p, q, img=img_k, cam=cam,
                win_uv=uv_w, win_pts3d=pts3d_w, win_ids=ids_w,
            )
            if loop is not None and pgraph.last_match is not None:
                # relocalization feedback (`/pose_graph/match_points` →
                # `setReloFrame`): next solve refines the loop jointly
                mm = pgraph.last_match
                if est.set_relo_frame(mm["ids"], mm["obs_old"], mm["p_old"], mm["q_old"]):
                    relo_edge["ij"] = (mm["old_idx"], mm["cur_idx"])
                if viz is not None and mm.get("old_img") is not None and mm.get("uv_cur") is not None:
                    viz.match_image(img_k, mm["uv_cur"], mm["old_img"], mm["uv_old"],
                                    tag=f"{mm['old_idx']}_{mm['cur_idx']}")
            if (loop is not None and config.loop.fast_relocalization
                    and loop["i"] < pgraph.base_n):
                # loop edge lands in the LOADED map: snap the drift from
                # this single edge immediately (`fast_relocalization`)
                pgraph.fast_relocalize(loop)
        if pgraph is not None:
            if pgraph._pending_opt:
                pgraph.optimize()
            # drift correction applies to EVERY published pose, not only
            # keyframes (the reference's loop-corrected output path)
            p, q = pgraph.correct(p, q)
        ts_out.append(tt)
        ps_out.append(p)
        qs_out.append(q)

    prev_cam_t = None
    n_cam = len(seq.cam_t)
    k = 0
    # track recording (for the large-window refinement mode) needs per-frame
    # id/obs readbacks — a streaming-loop consumer, so it forces streaming
    burst_ok = burst > 0 and viz is None and record_tracks is None
    while k < n_cam:
        if n_pub >= max_pub:
            break
        # ---- offline burst handoff (models/burst.py): once the estimator is
        # initialized with a live prior, chunks of `burst` published frames
        # run as ONE device dispatch; streaming resumes for any tail. A
        # pending relocalization round trip (relo request or unconsumed
        # refined edge) keeps the loop in streaming until it resolves ----
        if (burst_ok and k % stride == 0 and est.initialized
                and est.prior is not None and est.relo is None
                and relo_edge["ij"] is None
                # the post-init health gate must see the first solves in
                # streaming (failure → clearState + re-init there)
                and getattr(est, "solves_since_init", 99) > 6):
            if deferred_ctx is not None:
                _emit(deferred_ctx)
                deferred_ctx = None
            est.finalize()  # drain any in-flight deferred solve
            if (est.initialized and est.prior is not None
                    and est.relo is None and relo_edge["ij"] is None):
                # (finalize may have tripped failure detection → re-check)
                k2, n_pub, relo_match = _burst_tail(
                    seq, config, est, fp, fLines, feeder, k, stride, burst,
                    _load, ts_out, ps_out, qs_out, n_pub, max_pub, progress,
                    pgraph=pgraph, cam=cam)
                if relo_match is not None:
                    # loop found mid-burst → relocalization handshake: the
                    # streaming solve refines the edge, then burst re-enters
                    mm = relo_match
                    if est.set_relo_frame(mm["ids"], mm["obs_old"],
                                          mm["p_old"], mm["q_old"]):
                        relo_edge["ij"] = (mm["old_idx"], mm["cur_idx"])
                elif k2 == k:
                    burst_ok = False  # burst made no progress — stream on
                k = k2
                prev_cam_t = float(seq.cam_t[k - 1]) if k > 0 else None
                if executor is not None and k < n_cam:
                    pending = executor.submit(_load, k)
                continue
        t = seq.cam_t[k]
        # restart handshake: on a camera-stream timestamp discontinuity the
        # reference's tracker published `restart` and BOTH ends reset — the
        # estimator resets itself in process_frame; the frontends' device
        # -resident track state resets here so no cross-gap track survives
        if prev_cam_t is not None and (t < prev_cam_t - 1e-9 or t - prev_cam_t > 1.0):
            fp.reset()
            if fLines is not None:
                fLines.reset()
        prev_cam_t = t
        if executor is not None:
            img = pending.result()
            if k + 1 < len(seq.cam_t):
                pending = executor.submit(_load, k + 1)
        else:
            img = _load(k)
        publish = k % stride == 0
        want_pts = publish or viz is not None
        # "defer": both frontends DISPATCH first, then their bundle pulls
        # overlap each other's device round trips
        out_h = fp.process(img, t, want_output="defer" if want_pts else False,
                           light=not want_pts)
        if fLines is not None and publish:
            # the reference's line node FREQ-throttles the WHOLE LSD+LBD
            # pass, so lines run on published frames only (matching spans
            # publish→publish). Share the point frontend's device-resident
            # pyramid: level 0 IS the uploaded image (no second 1.4 MB H2D),
            # level 1 the line octave (same 5-tap blur + decimate)
            oct1 = fp.prev_pyr[1] if fp.prev_pyr is not None and len(fp.prev_pyr) > 1 else None
            img_dev = fp.prev_pyr[0] if fp.prev_pyr is not None else img
            ln_h = fLines.process(img_dev, t, oct1=oct1, want_output="defer")
        if viz is not None:
            ids, pts, vel, uv = out_h.get()
            viz.track_frame(img, uv, fp.track_cnt[fp.prev_valid])
        if not publish:
            k += 1
            continue  # tracked on device, not published (FREQ control)
        if fLines is not None:
            # both frontend bundles ride ONE device→host round trip
            from plslam.models.frontend_points import OutputHandle

            (ids, pts, vel, uv), (ln_ids, ln_segs) = OutputHandle.get_joint(out_h, ln_h)
        else:
            ids, pts, vel, uv = out_h.get()
            ln_ids, ln_segs = None, None
        n_pub += 1
        if record_tracks is not None and len(ids):
            # frontend tracks keyed by publish time: feature ids + normalized
            # obs (the /feature topic payload) for offline re-packing
            record_tracks[float(t)] = (np.asarray(ids).copy(),
                                       np.asarray(pts, np.float64).copy())
        # publish-frame output work of the PREVIOUS published frame runs here
        # — its deferred solve's round trip overlapped this frame's decode +
        # tracking + frontend readbacks (the reference's frontend↔backend
        # process overlap, SURVEY.md §2.6 PP; results bit-identical)
        if deferred_ctx is not None:
            _emit(deferred_ctx)
            deferred_ctx = None
        feeder.feed_until(est, t)
        m = est.process_frame(float(t), ids, pts, vel, ln_ids, ln_segs,
                              defer_solve=pipeline)
        ctx = (m, img)
        if pipeline:
            deferred_ctx = ctx
        else:
            _emit(ctx)
        if progress and k % 100 == 0:
            print(f"[{k}] t={t:.2f} init={est.initialized} pts={m.get('n_pts')} lines={m.get('n_lines')}")
        k += 1
    if deferred_ctx is not None:
        _emit(deferred_ctx)  # drain the last in-flight solve
    if pgraph is not None and pgraph._pending_opt:
        # a loop that landed in the final burst chunk (or final published
        # frame) still gets its 4-DoF solve — on the raw PnP edge if the
        # relocalization round trip never got a frame to run on
        pgraph.optimize()
    if executor is not None:
        executor.shutdown(wait=False, cancel_futures=True)
    if pgraph is not None and config.loop.save_pose_graph:
        import os

        pg_file = config.loop.pose_graph_save_path
        if not pg_file.endswith(".npz"):
            os.makedirs(pg_file, exist_ok=True)
            pg_file = os.path.join(pg_file, "pose_graph.npz")
        pgraph.save(pg_file)
    return np.asarray(ts_out), np.asarray(ps_out), np.asarray(qs_out), est, pgraph


def _burst_tail(seq, config, est, fp, fLines, feeder, k0, stride, B,
                load, ts_out, ps_out, qs_out, n_pub, max_pub, progress,
                pgraph=None, cam=None):
    """Chunked offline-burst driver (models/burst.py): run the remaining
    sequence in chunks of B published frames, ONE device dispatch + ONE
    packed readback per chunk. With a pose graph, every keyframe's payload
    (pixel uv + world 3D + ids) rides the chunk readback and loop closure
    runs per chunk on the host — the reference pose-graph thread's
    asynchronous cadence. Returns (next camera frame index for the streaming
    loop, updated n_pub, pending relo match or None). Falls back (returns
    early) on timestamp jumps, failure detection, or a loop that needs the
    relocalization round trip; the streaming loop handles all three."""
    import jax
    import jax.numpy as jnp

    from plslam.models import burst as burst_mod
    from plslam.utils.device import pull_all

    cfg = config.solver
    dtype = est.dtype
    cam_t = np.asarray(seq.cam_t, np.float64)
    n_cam = len(cam_t)
    if n_pub + B > max_pub or k0 + B * stride > n_cam:
        return k0, n_pub, None  # not enough frames left for one full chunk
    with_lines = fLines is not None
    pt_statics = (fp.min_dist, fp.max_cnt, fp.fisheye, fp._mask_img is not None)
    ln_statics = ((fLines.max_lines, fLines.octaves, fLines.binary_desc)
                  if with_lines else (1, 1, False))
    fe_dtype = fp.dtype
    prog = burst_mod._burst_program(
        cfg, pt_statics, ln_statics, stride, with_lines,
        config.extrinsic.estimate_extrinsic > 0,
        config.temporal.estimate_td, fe_dtype, dtype)
    mask_arg = fp._mask_img if fp._mask_img is not None else jnp.zeros((1, 1), fe_dtype)
    consts = (fp.cam, jnp.asarray(fp.f_thresh, fe_dtype),
              jnp.asarray(fp.min_score, fe_dtype), mask_arg, est.noise, est.g)
    try:
        carry = burst_mod.make_carry(est, fp, fLines, dtype)
    except ValueError:
        return k0, n_pub, None
    packer = burst_mod.ImuChunkPacker(
        seq.imu_t, seq.imu_acc, seq.imu_gyr,
        feeder.i, feeder.prev_t, feeder.prev_acc, feeder.prev_gyr)
    from concurrent.futures import ThreadPoolExecutor

    k = k0
    prev_t = float(cam_t[k0 - 1]) if k0 > 0 else float(cam_t[0]) - 0.05
    last_pub_t = prev_t
    W = cfg.window_size
    # per-slot window timestamps, replicated on the host from the chunk's
    # publish times + keyframe flags (the estimator's exact slide rules) —
    # sync_back restores the true array, not a flattened copy
    ts_win = est.timestamps.copy()
    td = float(est.td)
    failed = False
    relo_match = None
    # one-chunk decode prefetch: the next chunk's PNG decode + CLAHE AND its
    # uint8 H2D upload run on a worker thread while the device executes the
    # current chunk's scan. Images ship as uint8 (to_u8 — 4× fewer bytes
    # than float32) and the scan casts on device (dev_image).
    from plslam.models.frontend_points import to_u8

    pool = ThreadPoolExecutor(max_workers=1)

    def decode(kk):
        fr = [load(kk + i) for i in range(B * stride)]
        u8 = np.stack([to_u8(f) for f in fr])
        return fr, jnp.asarray(u8.reshape(B, stride, *fr[0].shape))

    prefetch = pool.submit(decode, k0)
    import time as _time

    while not failed and n_pub + B <= max_pub and k + B * stride <= n_cam:
        tchunk = cam_t[k: k + B * stride]
        dts_cam = np.diff(np.concatenate([[prev_t], tchunk]))
        if np.any(dts_cam <= 0) or np.any(dts_cam > 1.0):
            break  # timestamp jump → streaming handles the restart handshake
        t_c0 = _time.perf_counter()
        frames, imgs = prefetch.result() if prefetch is not None else decode(k)
        t_dec = _time.perf_counter()
        if k + 2 * B * stride <= n_cam:
            prefetch = pool.submit(decode, k + B * stride)
        else:
            prefetch = None
        img_dts = jnp.asarray(dts_cam.reshape(B, stride), fe_dtype)
        accs, gyrs, dtss, ns = [], [], [], []
        for j in range(B):
            a, g_, d, m = packer.interval(float(tchunk[j * stride]), td)
            accs.append(a)
            gyrs.append(g_)
            dtss.append(d)
            ns.append(m)
        inp = (imgs, img_dts,
               jnp.asarray(np.stack(accs), dtype), jnp.asarray(np.stack(gyrs), dtype),
               jnp.asarray(np.stack(dtss), dtype), jnp.asarray(ns, jnp.int32),
               jnp.full((B,), td, dtype))  # pairing td of every chunk frame
        t_pack = _time.perf_counter()
        carry, outs = prog(consts, carry, inp)
        (p_b, q_b, kf_b, cost_b, fail_b, lt_b, np_b, td_b,
         ids_b, kfm_b, uv_b, pw_b) = pull_all(*outs)
        t_pull = _time.perf_counter()
        if progress:
            print(f"[burst chunk @{k}] decode-wait={t_dec-t_c0:.3f}s "
                  f"pack+h2d={t_pack-t_dec:.3f}s scan+pull={t_pull-t_pack:.3f}s")
        for j in range(B):
            if fail_b[j]:
                failed = True
                break
            tt = float(tchunk[j * stride])
            # timestamp slide mirror (process_frame writes slot W, then
            # MARGIN_OLD rolls left / SECOND_NEW copies W→W-1)
            ts_win[W] = tt
            if kf_b[j]:
                ts_win[:-1] = ts_win[1:]
            else:
                ts_win[W - 1] = ts_win[W]
            p_raw = np.asarray(p_b[j], np.float64)
            q_raw = np.asarray(q_b[j], np.float64)
            if pgraph is not None and kf_b[j]:
                # pose-graph keyframe from the chunk payload (the streaming
                # loop's _emit keyframe branch, at chunk cadence)
                sel = np.asarray(kfm_b[j])
                loop = pgraph.add_keyframe(
                    tt, p_raw, q_raw, img=frames[j * stride], cam=cam,
                    win_uv=np.asarray(uv_b[j], np.float64)[sel],
                    win_pts3d=np.asarray(pw_b[j], np.float64)[sel],
                    win_ids=np.asarray(ids_b[j])[sel])
                if loop is not None and relo_match is None:
                    if (config.loop.fast_relocalization
                            and loop["i"] < pgraph.base_n):
                        pgraph.fast_relocalize(loop)
                    # relocalization round trip runs INDEPENDENTLY of the
                    # fast_relocalize snap (streaming _emit does both):
                    # finish this chunk, hand back to streaming for the
                    # joint solve, then burst re-enters
                    if pgraph.last_match is not None:
                        relo_match = dict(pgraph.last_match)
                if pgraph._pending_opt and relo_match is None:
                    pgraph.optimize()
            if pgraph is not None:
                p_out, q_out = pgraph.correct(p_raw, q_raw)
            else:
                p_out, q_out = p_raw, q_raw
            ts_out.append(tt)
            ps_out.append(p_out)
            qs_out.append(q_out)
            est.metrics.append({
                "t": tt, "keyframe": bool(kf_b[j]), "cost": float(cost_b[j]),
                "tracked": int(lt_b[j]), "long_tracked": int(lt_b[j]),
                "n_pts": int(np_b[j]), "burst": True,
            })
            n_pub += 1
            last_pub_t = tt
        td = float(td_b[-1])  # estimate_td: next chunk pairs at the live td
        prev_t = float(tchunk[-1])
        k += B * stride
        if relo_match is not None:
            break
        if progress:
            print(f"[burst {k}] t={prev_t:.2f} pts={int(np_b[-1])} cost={float(cost_b[-1]):.3g}")
    pool.shutdown(wait=False, cancel_futures=True)
    burst_mod.sync_back(est, fp, fLines, carry, last_pub_t, ts_win=ts_win)
    feeder.i = packer.i
    feeder.prev_t, feeder.prev_acc, feeder.prev_gyr = (
        packer.prev_t, packer.prev_acc, packer.prev_gyr)
    # the next open interval must seed with the chunk-boundary IMU sample
    # (process_imu seeds from last_acc/last_gyr — the reference passed
    # acc_0/gyr_0 into the IntegrationBase constructor)
    if packer.prev_acc is not None:
        est.last_acc = np.asarray(packer.prev_acc, np.float64)
        est.last_gyr = np.asarray(packer.prev_gyr, np.float64)
    if failed:
        # streaming semantics: failureDetection → clearState + re-init
        est.clear_state()
    return k, n_pub, relo_match


def run_synthetic_large_window(
    seq: SyntheticSequence,
    config: PLSlamConfig | None = None,
    frame_stride: int = 2,
    kf_stride: int = 5,
    rounds: int = 3,
    num_iters: int = 8,
    oracle_init: bool = True,
):
    """Live large-window mode (SURVEY.md §5.7 — beyond the reference).

    Streams the sequence through the ordinary sliding-window estimator for
    the LIVE trajectory, accumulating every `kf_stride`-th published frame as
    a keyframe; then refines the FULL keyframe history with one
    keyframe-partitioned consensus BA (`parallel.consensus`) — partitions of
    window_size+1 keyframes solved in parallel (vmap; device-shardable on the
    'kf_part' mesh axis), boundary-pose consensus between rounds. The
    reference cannot do this at all: its Ceres window is hard-capped at 11
    frames and older information survives only through the marginalization
    prior; here the whole trajectory re-solves as a single nonlinear VI-BA.

    Initialization is honest: partition states come from the LIVE (drifted)
    estimates — positions/rotations from the streamed output, velocities by
    finite differences, biases from the estimator's final window, inverse
    depths re-triangulated from the live poses (no ground truth anywhere).

    Returns (kf_t, live_p [K,3], refined_p [K,3], refined_q [K,4], est)."""
    import jax
    import jax.numpy as jnp

    from plslam.models import packing, triangulate
    from plslam.models.state import layout, zero_state
    from plslam.parallel import consensus
    from plslam.utils import quat_np as qnp

    config = config or PLSlamConfig()
    cfg = config.solver
    lay = layout(cfg)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    # ---- live pass: ordinary sliding-window streaming ----
    ts, ps, qs, est = run_synthetic(seq, config, oracle_init=oracle_init,
                                    use_lines=False, frame_stride=frame_stride)
    # map published outputs back to sequence frame indices by timestamp
    frame_t = np.asarray(seq.frame_t)
    out_idx = np.searchsorted(frame_t, np.asarray(ts) - 1e-9)
    # keyframes: every kf_stride-th published frame, trimmed to FULL
    # partitions — consensus_solve chain-aligns partitions through exactly
    # one shared boundary frame, so the history must be P·window + 1 long
    # (partition_frames' ragged tail partition would break the chain)
    kf_sel = np.arange(0, len(ts), kf_stride)
    n_kf = len(kf_sel)
    if n_kf < cfg.window_size + 2:
        raise ValueError(f"only {n_kf} keyframes — need > window_size+1")
    n_kf = ((n_kf - 1) // cfg.window_size) * cfg.window_size + 1
    kf_sel = kf_sel[:n_kf]
    kf_frames = out_idx[kf_sel]
    live_p = np.asarray(ps)[kf_sel]
    live_q = np.asarray(qs)[kf_sel]
    live_t = np.asarray(ts)[kf_sel]
    # finite-difference velocity initialization from the live trajectory
    live_v = np.gradient(live_p, live_t, axis=0)

    # ---- partition + pack the full keyframe history ----
    parts = consensus.partition_frames(n_kf, cfg.window_size)
    nw = cfg.window_size + 1
    states, factors = [], []
    ba = np.asarray(est.ba[cfg.window_size])
    bg = np.asarray(est.bg[cfg.window_size])
    for pr in parts:
        frames = [int(kf_frames[i]) for i in pr]
        _, f = packing.factors_from_synthetic(seq, frames, cfg, lay, dtype=dtype,
                                              with_lines=False)
        st = zero_state(cfg, dtype)._replace(
            p=jnp.asarray(live_p[pr], dtype),
            q=jnp.asarray(live_q[pr], dtype),
            v=jnp.asarray(live_v[pr], dtype),
            ba=jnp.asarray(np.tile(ba, (nw, 1)), dtype),
            bg=jnp.asarray(np.tile(bg, (nw, 1)), dtype),
            p_bc=jnp.asarray(np.asarray(seq.p_bc), dtype),
            q_bc=jnp.asarray(np.asarray(seq.q_bc), dtype),
        )
        # re-triangulate landmark depths from the LIVE poses (no GT)
        q_wc = qnp.quat_mul(live_q[pr], np.asarray(seq.q_bc))
        p_wc = live_p[pr] + qnp.quat_rotate(live_q[pr], np.broadcast_to(
            np.asarray(seq.p_bc), live_p[pr].shape))
        inv_d, ok = triangulate.triangulate_points(
            jnp.asarray(p_wc, dtype), jnp.asarray(q_wc, dtype),
            f.pt_obs, f.pt_mask, f.pt_start)
        inv_d = jnp.where(ok & (inv_d > 0), inv_d, 0.2)
        st = st._replace(inv_depth=inv_d * f.pt_valid + 0.2 * (1 - f.pt_valid))
        states.append(st)
        factors.append(f)
    stack = lambda items: jax.tree.map(lambda *xs: jnp.stack(xs), *items)
    st_out = consensus.consensus_solve(stack(states), stack(factors), lay, cfg,
                                       rounds=rounds, num_iters=num_iters)
    ref_p, ref_q = consensus.stitch_trajectory(st_out, parts, n_kf)
    return live_t, live_p, ref_p, ref_q, est


def run_euroc_large_window(
    seq_path: str,
    config: PLSlamConfig | None = None,
    kf_stride: int = 3,
    rounds: int = 3,
    num_iters: int = 8,
    mesh_shape: tuple | None = None,
    max_frames: int | None = None,
):
    """Distributed large-window refinement FROM IMAGES (SURVEY.md §5.7 +
    §2.6 TP/SP end-to-end): stream the REAL image pipeline (PNG decode →
    CLAHE → frontends → estimator), record the frontends' tracks, then
    refine the full keyframe history by keyframe-partitioned consensus BA
    where every partition's landmark system is SHARDED over a
    ('kf_part','lmk') device mesh (`parallel.mesh2d`). Initialization is
    honest: poses from the live (drifted) trajectory, velocities by finite
    differences, biases from the estimator's final window, depths
    re-triangulated from live poses, observations from the real trackers —
    no ground truth and no pre-packed windows anywhere.

    mesh_shape (kf_part, lmk) defaults to using all available devices in a
    (P, L) grid with L = 4 if capacities divide, else (1, n_devices).
    Returns (kf_t, live_p [K,3], refined_p [K,3], refined_q [K,4], est)."""
    import jax
    import jax.numpy as jnp

    from plslam.models import packing, triangulate
    from plslam.models.state import layout, zero_state
    from plslam.parallel import consensus, mesh2d
    from plslam.utils import quat_np as qnp

    config = config or PLSlamConfig()
    cfg = config.solver
    lay = layout(cfg)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    # ---- live pass: the real image pipeline, tracks recorded ----
    tracks: dict = {}
    ts, ps, qs, est, _ = run_euroc(seq_path, config, loop_closure=False,
                                   max_frames=max_frames, record_tracks=tracks)
    ts = np.asarray(ts)
    have = np.asarray([float(t) in tracks for t in ts])
    ts, ps, qs = ts[have], np.asarray(ps)[have], np.asarray(qs)[have]

    # ---- mesh geometry: P partitions × L landmark shards ----
    kf_sel_all = np.arange(0, len(ts), kf_stride)
    n_dev = len(jax.devices())
    if mesh_shape is None:
        L = 4 if (n_dev >= 8 and lay.max_f % 4 == 0 and lay.max_l % 4 == 0) else 1
        n_parts_data = max((len(kf_sel_all) - 1) // cfg.window_size, 1)
        mesh_shape = (max(min(n_dev // L, n_parts_data), 1), L)
    n_part_mesh, L = mesh_shape
    assert lay.max_f % L == 0 and lay.max_l % L == 0, \
        "max_features/max_line_feats must divide the lmk mesh axis"

    kf_sel = np.arange(0, len(ts), kf_stride)
    n_kf = len(kf_sel)
    if n_kf < cfg.window_size + 2:
        raise ValueError(f"only {n_kf} keyframes — need > window_size+1")
    # the partition count must EQUAL the mesh row axis (each mesh row owns
    # exactly one partition in the SPMD solve); trim the history to fit
    n_parts = n_part_mesh
    n_kf = n_parts * cfg.window_size + 1
    if len(kf_sel) < n_kf:
        raise ValueError(f"need {n_kf} keyframes for a {n_part_mesh}-row mesh, "
                         f"have {len(kf_sel)} (lower kf_stride or mesh rows)")
    kf_sel = kf_sel[:n_kf]
    live_t = ts[kf_sel]
    live_p = np.asarray(ps)[kf_sel]
    live_q = np.asarray(qs)[kf_sel]
    live_v = np.gradient(live_p, live_t, axis=0)

    # ---- pack each partition from the recorded REAL tracks ----
    from plslam.io.euroc import EurocSequence

    seq = EurocSequence.load(seq_path)
    parts = consensus.partition_frames(n_kf, cfg.window_size)
    nw = cfg.window_size + 1
    ba = np.asarray(est.ba[cfg.window_size])
    bg = np.asarray(est.bg[cfg.window_size])
    noise = None
    states, factors = [], []
    for pr in parts:
        sel = [int(kf_sel[i]) for i in pr]
        kt = [float(ts[i]) for i in sel]
        kids = [tracks[t][0] for t in kt]
        kobs = [tracks[t][1] for t in kt]
        f = packing.factors_from_tracks(
            kt, kids, kobs, seq.imu_t, seq.imu_acc, seq.imu_gyr,
            cfg, lay, ba, bg, dtype=dtype, g_norm=config.imu.g_norm)
        st = zero_state(cfg, dtype)._replace(
            p=jnp.asarray(live_p[pr], dtype),
            q=jnp.asarray(live_q[pr], dtype),
            v=jnp.asarray(live_v[pr], dtype),
            ba=jnp.asarray(np.tile(ba, (nw, 1)), dtype),
            bg=jnp.asarray(np.tile(bg, (nw, 1)), dtype),
            p_bc=jnp.asarray(est.p_bc, dtype),
            q_bc=jnp.asarray(est.q_bc, dtype),
        )
        q_wc = qnp.quat_mul(live_q[pr], np.asarray(est.q_bc))
        p_wc = live_p[pr] + qnp.quat_rotate(live_q[pr], np.broadcast_to(
            np.asarray(est.p_bc), live_p[pr].shape))
        inv_d, ok = triangulate.triangulate_points(
            jnp.asarray(p_wc, dtype), jnp.asarray(q_wc, dtype),
            f.pt_obs, f.pt_mask, f.pt_start)
        inv_d = jnp.where(ok & (inv_d > 0), inv_d, 0.2)
        # rows that fail triangulation keep a default depth but stay valid —
        # the solver's robust loss + depth bounds handle them like streaming
        st = st._replace(inv_depth=inv_d * f.pt_valid + 0.2 * (1 - f.pt_valid))
        states.append(st)
        factors.append(f)

    stack = lambda items: jax.tree.map(lambda *xs: jnp.stack(xs), *items)
    mesh = mesh2d.make_mesh2d(n_part_mesh, L)
    st_out = mesh2d.consensus_distributed_solve(
        stack(states), stack(factors), lay, cfg, mesh,
        rounds=rounds, num_iters=num_iters)
    ref_p, ref_q = consensus.stitch_trajectory(st_out, parts, n_kf)
    return live_t, live_p, ref_p, ref_q, est


def _clahe(img, clip=3.0, tiles=8):
    """Contrast-limited adaptive histogram equalization
    (`cv::createCLAHE(3.0, 8x8)` equivalent; native C++ with numpy fallback)."""
    from plslam.io import native

    out = native.clahe(img, clip, tiles)
    if out is not None:
        return out
    h, w = img.shape
    th, tw = h // tiles, w // tiles
    out = np.empty_like(img)
    luts = np.empty((tiles, tiles, 256), np.float32)
    for i in range(tiles):
        for j in range(tiles):
            tile = img[i * th : (i + 1) * th, j * tw : (j + 1) * tw]
            hist, _ = np.histogram((tile * 255).astype(np.uint8), bins=256, range=(0, 256))
            excess = np.maximum(hist - clip * tile.size / 256, 0).sum()
            hist = np.minimum(hist, clip * tile.size / 256) + excess / 256
            cdf = np.cumsum(hist)
            luts[i, j] = (cdf / cdf[-1]).astype(np.float32)
    # bilinear interpolation between tile LUTs
    ys = np.clip((np.arange(h) - th / 2) / th, 0, tiles - 1.001)
    xs = np.clip((np.arange(w) - tw / 2) / tw, 0, tiles - 1.001)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    v = (img * 255).astype(np.uint8)
    l00 = luts[y0[:, None], x0[None, :], v]
    l01 = luts[y0[:, None], np.minimum(x0 + 1, tiles - 1)[None, :], v]
    l10 = luts[np.minimum(y0 + 1, tiles - 1)[:, None], x0[None, :], v]
    l11 = luts[np.minimum(y0 + 1, tiles - 1)[:, None], np.minimum(x0 + 1, tiles - 1)[None, :], v]
    return (l00 * (1 - fx) * (1 - fy) + l01 * fx * (1 - fy) + l10 * (1 - fx) * fy + l11 * fx * fy).astype(np.float32)


def run_synthetic(
    seq: SyntheticSequence,
    config: PLSlamConfig | None = None,
    oracle_init: bool = False,
    use_lines: bool = True,
    max_frames: int | None = None,
    frame_stride: int = 2,
    progress: bool = False,
    drop_frames: set | None = None,
    extrinsic_rot_override=None,
):
    """Feed a synthetic sequence through the estimator.

    frame_stride=2 turns the 20 Hz camera stream into the reference's 10 Hz
    processing rate (`FREQ` frequency control, SURVEY.md §2.1).
    extrinsic_rot_override: optional 3×3 R_bc the estimator STARTS from
    instead of the simulator truth (exercises estimate_extrinsic=1/2 — the
    reference's miscalibrated-rig scenario).
    Returns (ts, ps, qs, estimator)."""
    import dataclasses

    from plslam.config import ExtrinsicConfig
    from plslam.utils.geometry import quat_to_rot

    config = config or PLSlamConfig()
    # the estimator must use the simulator's body_T_cam, not the config default
    R_bc = np.array(quat_to_rot(seq.q_bc))
    if extrinsic_rot_override is not None:
        R_bc = np.asarray(extrinsic_rot_override, np.float64).reshape(3, 3)
    config = dataclasses.replace(
        config,
        extrinsic=ExtrinsicConfig(
            estimate_extrinsic=config.extrinsic.estimate_extrinsic,
            rot=tuple(R_bc.reshape(-1).tolist()),
            trans=tuple(np.array(seq.p_bc).tolist()),
        ),
    )
    est = Estimator(config)

    imu_t = np.asarray(seq.imu_t)
    frame_t = np.asarray(seq.frame_t)[::frame_stride]
    obs = np.asarray(seq.obs)[::frame_stride]
    obs_valid = np.asarray(seq.obs_valid)[::frame_stride]
    line_obs = np.asarray(seq.line_obs)[::frame_stride]
    line_obs_valid = np.asarray(seq.line_obs_valid)[::frame_stride]
    if max_frames is not None:
        frame_t = frame_t[:max_frames]

    gt_p = np.asarray(seq.gt_p)[::frame_stride]
    gt_q = np.asarray(seq.gt_q)[::frame_stride]
    gt_v = np.asarray(seq.gt_v)[::frame_stride]

    drop_frames = drop_frames or set()  # fault injection (SURVEY.md §5.3)
    ts_out, ps_out, qs_out = [], [], []
    feeder = ImuFeeder(imu_t, np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr))
    for k, t in enumerate(frame_t):
        if k in drop_frames:
            continue  # dropped camera frame; IMU keeps accumulating
        # feed IMU samples up to the interpolated boundary at t + td
        feeder.feed_until(est, t)

        vis = np.nonzero(obs_valid[k])[0]
        pt_ids = vis
        pt_obs = obs[k, vis]
        ln_ids = ln_segs = None
        if use_lines:
            lvis = np.nonzero(line_obs_valid[k])[0]
            ln_ids = lvis
            ln_segs = line_obs[k, lvis]
        oracle = (
            {"p": gt_p[k], "q": gt_q[k], "v": gt_v[k]} if oracle_init else None
        )
        m = est.process_frame(float(t), pt_ids, pt_obs, None, ln_ids, ln_segs, oracle_state=oracle)
        if progress and k % 20 == 0:
            print(f"[{k}/{len(frame_t)}] t={t:.2f} init={est.initialized} m={ {kk: m[kk] for kk in ('cost','n_pts','n_lines') if kk in m} }")
        if est.initialized:
            tt, p, q = est.latest_pose()
            ts_out.append(tt)
            ps_out.append(p)
            qs_out.append(q)
    return np.asarray(ts_out), np.asarray(ps_out), np.asarray(qs_out), est
