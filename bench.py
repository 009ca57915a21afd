"""Benchmark: full-system frontend + sliding-window BA throughput, one chip.

The BASELINE metric is "frontend+BA frames/s per chip" (BASELINE.json:2); the
reference ran its backend at 10 solves/s real-time (40 ms Ceres budget) with
10 Hz point AND line frontends on a desktop CPU. We time the real per-frame
work, chained like the streaming system (no independent-tick flattery):

  * point frontend (SURVEY.md §3.1): pyramid build + batched-matmul pyramidal
    LK on the PREVIOUS tick's features + rejectWithF (undistort + batched
    8-point RANSAC) + Shi-Tomasi grid detection + per-feature velocity, with
    detection feedback — dead tracks refill from fresh corners, and tick k's
    output features/pyramids are tick k+1's input,
  * line frontend (SURVEY.md §3.2): Scharr edge map + tiled-Hough segment
    detection on 2 octaves + cross-octave merge + LBD descriptors + matching
    against the PREVIOUS tick's descriptors (chained),
  * backend (SURVEY.md §3.3): 8-iteration LM/Schur window solve + FEJ
    marginalization per frame.

Frames are 8 consecutive rendered 752×480 views of the synthetic 3D world
(real inter-frame motion), cycled; all ticks are device-chained async
dispatches — the host never syncs inside the measurement loop.

Requires a GPU (there is no CPU fallback). Prints ONE JSON line; details,
with the device kind and the card's power limit, go to stderr.
vs_baseline = our frames/s ÷ 10 (the reference's real-time rate).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, ".smoke_data", "euroc_class_seed17")


def main():
    import jax
    import jax.numpy as jnp

    from plslam.utils.device import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"# device={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} nvidia-smi: {smi}", file=sys.stderr)
    enable_compile_cache()
    from plslam.io import native

    # the Python fallback decoder would time a different host pipeline
    err = native.build_error()
    if err is not None:
        sys.exit(f"bench.py: native IO library did not build:\n{err}")

    import plslam  # noqa: F401
    from plslam.config import SolverConfig
    from plslam.io import render, synthetic
    from plslam.models import frontend_lines as fl
    from plslam.models import frontend_points as fp
    from plslam.models import marginalization as marg
    from plslam.models import packing, solver
    from plslam.models.state import layout
    from plslam.ops.cameras import PinholeRadTan

    dtype = jnp.float32
    H, W = 480, 752
    N_IMGS = 8
    MAX_PTS = 150
    MAX_LINES = 64

    # ------------- 8 consecutive rendered frames (real camera motion) -------
    seq = synthetic.make_sequence(duration=1.0, n_points=500, n_lines=48, seed=7)
    cam = PinholeRadTan.create(460.0, 460.0, W / 2, H / 2)
    imgs = [
        jax.device_put(jnp.asarray(
            render.render_frame(seq, k, cam, H, W, blob_sigma=2.5, style="textured"),
            dtype), dev)
        for k in range(N_IMGS)
    ]

    # ------------------- point frontend tick (chained) ----------------------
    NLVL = fp.auto_levels((H, W))

    from plslam.ops.cameras import lift

    F_TH = jnp.asarray(1.0 / 460.0, dtype)  # F_THRESHOLD=1px at FOCAL=460
    base_key = jax.random.PRNGKey(42)

    def _pt_core(pyr_prev, pyr_new, uv, valid, norm_prev, k):
        out, status = fp.lk_track_fast(pyr_prev, pyr_new, uv, valid)
        ok = (status > 0) & valid
        # rejectWithF: undistort to normalized coords + 8-point RANSAC
        norm = lift(cam, out)
        inl = fp.fundamental_ransac(norm_prev, norm, ok, F_TH,
                                    key=jax.random.fold_in(base_key, k))
        ok = ok & inl
        det_uv, det_sc = fp.shi_tomasi_grid(pyr_new[0], out, ok.astype(dtype),
                                            cell=30, max_out=MAX_PTS)
        # detection feedback: dead slots refill from the freshest corners
        fill = jnp.clip(jnp.cumsum(~ok) - 1, 0, MAX_PTS - 1)
        uv2 = jnp.where(ok[:, None], out, det_uv[fill])
        valid2 = ok | (det_sc[fill] > 1e-5)
        norm2 = lift(cam, uv2)
        vel = (norm2 - norm_prev) * 10.0 * ok[:, None]  # per-feature velocity
        return tuple(pyr_new), uv2, valid2, norm2, vel

    @jax.jit
    def pt_tick(pyr_prev, img_new, uv, valid, norm_prev, k):
        return _pt_core(pyr_prev, fp.build_pyramid(img_new), uv, valid, norm_prev, k)

    # -------------------- line frontend tick (chained) ----------------------
    def _ln_core(img, oct1, prev_segs, prev_desc, prev_valid):
        segs_o, score_o, valid_o = [], [], []
        cur = img
        for o in range(2):
            mag, ang, edge = fl.edge_map(cur)
            s, sc, v = fl.detect_segments(mag, ang, edge, *cur.shape, max_out=MAX_LINES)
            segs_o.append(s * float(2 ** o))
            score_o.append(sc * float(2 ** o))
            valid_o.append(v)
            if o == 0:
                if oct1 is not None:
                    cur = oct1  # share the point pyramid's level-1 image
                else:
                    k5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], img.dtype) / 16.0
                    cur = fp._sep_conv(cur, k5)[::2, ::2]
        segs, score, valid = fl.merge_candidates(
            jnp.concatenate(segs_o), jnp.concatenate(score_o),
            jnp.concatenate(valid_o), max_out=MAX_LINES)
        gx, gy = fl._scharr(img)
        desc = fl.lbd_descriptors(gx, gy, segs, valid.astype(img.dtype))
        match = fl.match_lbd(prev_desc, prev_segs, prev_valid, desc, segs,
                             valid.astype(img.dtype))
        return segs, desc, valid.astype(img.dtype), match

    @jax.jit
    def ln_tick(img, prev_segs, prev_desc, prev_valid):
        return _ln_core(img, None, prev_segs, prev_desc, prev_valid)

    # ---------------- backend: window solve + marginalization ---------------
    cfg = SolverConfig(max_features=192, max_line_feats=64)
    lay = layout(cfg)
    bseq = synthetic.make_sequence(duration=6.0, n_points=420, n_lines=160, seed=3)
    frames = list(range(0, 55, 5))
    state64, f64v = packing.factors_from_synthetic(bseq, frames, cfg, lay)
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, t
    )
    state = jax.device_put(cast(state64), dev)
    f = jax.device_put(cast(f64v), dev)

    @jax.jit
    def be_tick(st, fac):
        st_out, stats = solver.optimize_window(st, fac, lay, cfg, num_iters=8)
        # the solve's carried final residuals feed marginalization's IRLS
        # weights — one residual-stack evaluation saved per frame
        prior = marg.marginalize_old(st_out, fac, lay, cfg, groups=stats.groups)
        return st_out, stats, prior

    # the deployment shape: ONE XLA program per frame (three separate tick
    # programs pay the per-dispatch overhead three times; the fused program
    # once)
    @jax.jit
    def full_tick(pyr_prev, img_new, uv, valid, norm_prev, k, ln_s, st, fac):
        pyr_new = fp.build_pyramid(img_new)
        pt_out = _pt_core(pyr_prev, pyr_new, uv, valid, norm_prev, k)
        # the line octave-1 image IS pyramid level 1 (same 5-tap binomial
        # blur + decimate) — computed once, used by both frontends
        ln_out = _ln_core(img_new, pyr_new[1], *ln_s)
        st_out, stats, prior = be_tick(st, fac)
        return pt_out[:4], ln_out[:3], (st_out.p, prior.r0, pt_out[4])

    # ------------------------------- warmup ---------------------------------
    uv0, sc0 = fp.shi_tomasi_grid(imgs[0], jnp.zeros((1, 2), dtype),
                                  jnp.zeros((1,), dtype), cell=30, max_out=MAX_PTS)
    pyr = fp.build_pyramid(imgs[0], levels=NLVL)
    pt_state = (tuple(pyr), uv0, sc0 > 1e-5, lift(cam, uv0))
    ln_state = ln_tick(imgs[0], jnp.zeros((MAX_LINES, 4), dtype),
                       jnp.zeros((MAX_LINES, fl.N_BANDS * 8), dtype),
                       jnp.zeros((MAX_LINES,), dtype))[:3]
    k0 = jnp.zeros((), jnp.int32)
    pt_state = pt_tick(pt_state[0], imgs[1], pt_state[1], pt_state[2], pt_state[3], k0)[:4]
    be_out = be_tick(state, f)
    jax.block_until_ready((pt_state, ln_state, be_out))

    # --------------------- streaming measurement loop -----------------------
    # every tick gets UNIQUE inputs (a per-iteration jitter baked on device):
    # with the 8 images cycling and `state, f` fixed, the chained states hit a
    # fixed point after warmup and identical (executable, buffers) pairs
    # repeat — any memoization between here and the chip would then fake the
    # throughput. The jitter is one fused elementwise op, measured with the
    # tick it feeds.
    @jax.jit
    def jitter_img(img, k):
        return img + 1e-4 * jnp.sin(k.astype(img.dtype))

    @jax.jit
    def jitter_state(st, k):
        return st._replace(p=st.p + 1e-7 * jnp.sin(k.astype(st.p.dtype)))

    def stream(n, do_pt=True, do_ln=True, do_be=True, fused=False):
        nonlocal pt_state, ln_state
        outs = []
        ks = [jax.device_put(jnp.asarray(i, jnp.int32), dev) for i in range(n)]
        t0 = time.time()
        for i in range(n):
            img = jitter_img(imgs[i % N_IMGS], ks[i])
            if fused:
                pt_state, ln_state, be_out = full_tick(
                    pt_state[0], img, pt_state[1], pt_state[2], pt_state[3],
                    ks[i], ln_state, jitter_state(state, ks[i]), f)
                outs.append(be_out[1])
                continue
            if do_pt:
                pt_state = pt_tick(pt_state[0], img, pt_state[1], pt_state[2],
                                   pt_state[3], ks[i])[:4]
                outs.append(pt_state[1])
            if do_ln:
                s, d, v, m = ln_tick(img, *ln_state)
                ln_state = (s, d, v)
                outs.append(m)
            if do_be:
                st_out, stats, prior = be_tick(jitter_state(state, ks[i]), f)
                outs.append(prior.r0)
        jax.block_until_ready(outs)
        return (time.time() - t0) / n

    # ------------- burst mode: B chained ticks in ONE XLA program -----------
    # `lax.scan` over full ticks — the offline/eval deployment shape (EuRoC
    # replay is offline). Per-frame work is IDENTICAL to the streaming tick
    # and stays chained (pt/ln state through the scan carry; the backend
    # input is perturbed by the PREVIOUS step's solution so XLA cannot hoist
    # the solve out of the loop); only the per-program dispatch amortizes.
    BURST = 16
    imgs_stack = jnp.stack(imgs + imgs)  # [16,H,W]

    def burst_step(carry, inp):
        pyr, uv, valid, norm, ln_s, fb = carry
        img, k = inp
        img = img + 1e-4 * jnp.sin(k.astype(img.dtype))
        pyr_new = fp.build_pyramid(img)
        pt_out = _pt_core(pyr, pyr_new, uv, valid, norm, k)
        ln_out = _ln_core(img, pyr_new[1], *ln_s)
        st_in = jitter_state(state, k)._replace(
            p=state.p + 1e-9 * fb)  # serial dependency on step k-1's solve
        st_out, stats, prior = be_tick(st_in, f)
        carry = (pt_out[0], pt_out[1], pt_out[2], pt_out[3], ln_out[:3], st_out.p)
        return carry, stats.cost

    @jax.jit
    def burst(carry0, ks):
        return jax.lax.scan(burst_step, carry0, (imgs_stack, ks))

    def stream_burst(n_bursts):
        nonlocal pt_state, ln_state
        carry = (*pt_state, ln_state, state.p)
        outs = []
        kss = [jax.device_put(jnp.arange(i * BURST, (i + 1) * BURST, dtype=jnp.int32), dev)
               for i in range(n_bursts)]
        t0 = time.time()
        for i in range(n_bursts):
            carry, costs = burst(carry, kss[i])
            outs.append(costs)
        jax.block_until_ready(outs)
        pt_state, ln_state = carry[:4], carry[4]
        return (time.time() - t0) / (n_bursts * BURST)

    # steady-state warmup before measuring (how many calls the GPU needs is
    # not measured; 38 warm calls of the fused tick are kept)
    stream(8)
    stream(30, fused=True)
    n_meas = 48
    t_all = stream(n_meas, fused=True)
    t_split = stream(24)
    stream_burst(4)
    t_burst = stream_burst(4)
    t_pt = stream(24, do_ln=False, do_be=False)
    t_ln = stream(24, do_pt=False, do_be=False)
    t_be = stream(24, do_pt=False, do_ln=False)

    fps = 1.0 / t_all
    st_out, stats, prior = be_tick(state, f)
    n_pts = int(np.asarray(jnp.sum(f.pt_valid)))
    n_lns = int(np.asarray(jnp.sum(f.ln_valid)))
    n_trk = int(np.asarray(jnp.sum(pt_state[2])))

    # ----------------- REAL pipeline (models/burst.py) ----------------------
    # the proxy above times the per-frame device WORK on a fixed pre-packed
    # window; this runs the PRODUCT — rendered PNGs → frontends →
    # device-resident feature tables → dynamic-marg solve → slide, scanned
    # 16 frames per dispatch — at REFERENCE capacity (max_cnt=150,
    # max_features=192, max_line_feats=64: the same shapes as the proxy)
    real = real_pipeline_bench()
    print(
        f"# device={dev.platform} FUSED full-system tick={t_all*1e3:.1f}ms → {fps:.1f} fps "
        f"(3-program split: {t_split*1e3:.1f}ms; {BURST}-frame on-device scan "
        f"burst: {t_burst*1e3:.1f}ms/frame → {1.0/t_burst:.1f} fps offline)\n"
        f"#   points={t_pt*1e3:.1f}ms ({n_trk}/{MAX_PTS} live, LK+RANSAC+detect+velocity 752x480)\n"
        f"#   lines={t_ln*1e3:.1f}ms (2-octave Hough + LBD + match, {MAX_LINES} cap)\n"
        f"#   backend={t_be*1e3:.1f}ms (11 kf, {n_pts} pts, {n_lns} lines, 8-iter LM + marg) "
        f"robust_cost {float(stats.cost_robust0):.2e}→{float(stats.cost_robust):.2e}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "frontend_plus_ba_fps",
        "value": round(fps, 2),
        "unit": "frames/s single chip (chained: LK+RANSAC+detect + 2-octave "
                "lines+LBD+match + 8-iter LM/Schur + marginalization, 752x480)",
        "vs_baseline": round(fps / 10.0, 2),
        **real,
    }))


def real_pipeline_bench():
    """Run the REAL pipeline on rendered 752×480 frames (run_euroc burst=16)
    at reference capacity and report burst-phase fps + accuracy — the product
    measurement next to the proxy tick above. Failures propagate."""
    import jax

    from plslam import runner
    from plslam.config import (
        CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
        SolverConfig, TrackerConfig,
    )
    from plslam.eval.metrics import ate_rmse
    from plslam.io import render

    # rendering is host work: keep its small JAX calls on the CPU device
    with jax.default_device(jax.devices("cpu")[0]):
        meta = render.write_euroc_class_dataset(DATA_DIR, seed=17, n_frames=160)
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=752, image_height=480, fx=460.0,
                            fy=460.0, cx=376.0, cy=240.0, k1=0, k2=0,
                            p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=150, min_dist=30, equalize=True,
                              min_score=2e-3),
        solver=SolverConfig(max_features=192, max_line_feats=64,
                            dtype="float32", focal_length=460.0),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)),
                                  tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False),
    )
    # pass 1 compiles; pass 2 measures
    runner.run_euroc(DATA_DIR, cfg, use_lines=True, burst=16)
    t0 = time.time()
    ts_b, ps_b, _, est_b, _ = runner.run_euroc(DATA_DIR, cfg, use_lines=True,
                                               burst=16)
    wall = time.time() - t0
    n_pub = len(est_b.metrics)
    n_burst = sum(1 for m in est_b.metrics if m.get("burst"))
    ate = ate_rmse(ts_b, ps_b, meta["gt_t"], meta["gt_p"], align="yaw")
    fps_pub = n_pub / wall
    print(f"# REAL pipeline (burst=16, ref capacity 150/192/64): "
          f"{wall:.2f}s wall for {n_pub} published ({n_burst} in chunks) "
          f"→ {fps_pub:.1f} published-fps, ATE(yaw) {float(ate):.3f} m",
          file=sys.stderr)
    return {
        "real_pipeline_published_fps": round(fps_pub, 2),
        "real_pipeline_burst_frames": n_burst,
        "real_pipeline_ate_m": round(float(ate), 4),
        "real_pipeline_wall_s": round(wall, 2),
    }


if __name__ == "__main__":
    main()
