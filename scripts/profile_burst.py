"""Attribute the real-pipeline burst's device time per published frame
(VERDICT r4 weak #2: the 14 ms real-chunk vs 9.0 ms bench-burst gap).

Two measurements in ONE process on the GPU:

  1. standalone component programs at DEPLOYMENT shapes (max_cnt=100,
     96 pts / 24 lines, stride 2): full point tick, light point tick
     (tracked-only frames — pyramid+LK only), line tick, dynamic-marg
     backend tick, and the chunk's vmapped preintegration pass. Their sum
     is the expected scan step cost; the remainder is table ops + slides +
     scan plumbing.
  2. the REAL chunk: run_euroc(burst=16) on the cached 12-s dataset with
     per-chunk decode/pack/scan+pull prints captured and averaged.

Timing rules: ~30 warmup calls per program, unique inputs
per tick (on-device jitter), medians over 32+ calls.

Run: timeout 3600 python scripts/profile_burst.py
"""
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = "/tmp/plslam_fps_ds_v2"
H, W, F = 480, 752, 460.0


def _time_calls(fn, args_fn, n_warm=30, n_meas=40):
    import jax

    n_warm = int(os.environ.get("PROFILE_WARM", n_warm))
    n_meas = int(os.environ.get("PROFILE_MEAS", n_meas))

    outs = [fn(*args_fn(i)) for i in range(n_warm)]
    jax.block_until_ready(outs)
    outs = []
    t0 = time.perf_counter()
    for i in range(n_meas):
        outs.append(fn(*args_fn(n_warm + i)))
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / n_meas * 1e3


def component_times():
    import jax
    import jax.numpy as jnp

    from plslam.config import SolverConfig
    from plslam.io import render, synthetic
    from plslam.models import packing
    from plslam.models.estimator import IMU_PAD, backend_tick
    from plslam.models.frontend_lines import _ln_program
    from plslam.models.frontend_points import _pt_programs, build_pyramid
    from plslam.models.state import layout
    from plslam.ops import imu as imu_ops
    from plslam.ops.cameras import PinholeRadTan

    dev = jax.devices()[0]
    dtype = jnp.float32
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    seq = synthetic.make_sequence(duration=1.0, n_points=400, n_lines=40, seed=7)
    imgs = [jax.device_put(jnp.asarray(
        render.render_frame(seq, kk, cam, H, W, blob_sigma=3.0, style="textured"),
        dtype), dev) for kk in range(4)]

    @jax.jit
    def jit_img(img, k):
        return img + 1e-4 * jnp.sin(k.astype(img.dtype))

    ks = [jax.device_put(jnp.asarray(i, jnp.int32), dev) for i in range(100)]

    # ---- point ticks at deployment statics (min_dist=30, max_cnt=100) ----
    progs = _pt_programs(30, 100, False, False, False, dtype)
    pt_full, _, _, _, pt_light = progs[0], progs[1], progs[2], progs[3], progs[4]
    det_prog = progs[1]
    mask0 = jnp.zeros((1, 1), dtype)
    pyr0, st0, _ = det_prog(cam, imgs[0], jnp.asarray(2e-3, dtype), mask0)
    f_th = jnp.asarray(1.0 / F, dtype)
    msc = jnp.asarray(2e-3, dtype)
    key = jax.random.PRNGKey(0)
    state = {"pyr": pyr0, "st": st0}

    def pt_full_call(i):
        img = jit_img(imgs[i % 4], ks[i % 100])
        out = pt_full(cam, state["pyr"], img, state["st"], f_th,
                      jax.random.fold_in(key, i), jnp.asarray(0.05, dtype),
                      msc, mask0)
        state["pyr"], state["st"] = out[0], out[1]
        return (out[2],)

    t_pt_full = _time_calls(lambda b: b, pt_full_call)

    def pt_light_call(i):
        img = jit_img(imgs[i % 4], ks[i % 100])
        out = pt_light(cam, state["pyr"], img, state["st"], mask0)
        state["pyr"], state["st"] = out[0], out[1]
        return (out[1][0],)

    t_pt_light = _time_calls(lambda b: b, pt_light_call)

    # ---- line tick at deployment statics (24 lines, 2 octaves, float) ----
    lprogs = _ln_program(24, 2, False, False, dtype)
    ln_jit = jax.jit(lprogs[1], static_argnums=(3,))
    import numpy as np

    lst = {"fe": (jnp.zeros((24, 4), dtype), jnp.zeros((24, 72), dtype),
                  jnp.zeros((24,), dtype), jnp.full((24,), -1, jnp.int32),
                  jnp.zeros((), jnp.int32))}

    def ln_call(i):
        img = jit_img(imgs[i % 4], ks[i % 100])
        pyr1 = build_pyramid(img, levels=2)[1]
        fe, out = ln_jit(cam, img, pyr1, True, *lst["fe"])
        lst["fe"] = fe
        return (out,)

    t_ln = _time_calls(lambda b: b, ln_call)

    # ---- dynamic-marg backend tick at deployment shapes (96/24) ----
    cfg = SolverConfig(max_features=96, max_line_feats=24)
    lay = layout(cfg)
    bseq = synthetic.make_sequence(duration=6.0, n_points=300, n_lines=80, seed=3)
    st64, f64 = packing.factors_from_synthetic(bseq, list(range(0, 55, 5)), cfg, lay)
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "dtype") and a.dtype == jnp.float64
        else a, t)
    stw = jax.device_put(cast(st64), dev)
    fac = jax.device_put(cast(f64), dev)

    @jax.jit
    def be_dyn(stx, fx, kf):
        solvable = fx.pt_valid
        tri_need = jnp.zeros_like(fx.pt_valid)
        fb4 = jnp.zeros_like(fx.pt_valid)
        lneed = jnp.zeros_like(fx.ln_valid)
        return backend_tick(stx, fx, solvable, tri_need, fb4, lneed,
                            fx.ln_valid, lay, cfg, False, False,
                            cfg.max_num_iterations, "dynamic",
                            marg_old_flag=kf)

    @jax.jit
    def jst(stx, k):
        return stx._replace(p=stx.p + 1e-7 * jnp.sin(k.astype(stx.p.dtype)))

    def be_call(i):
        return (be_dyn(jst(stw, ks[i % 100]), fac,
                       jnp.asarray((i % 3 != 0) * 1.0, dtype))[2].r0,)

    t_be = _time_calls(lambda b: b, be_call)

    # ---- chunk preintegration: vmapped 16 × IMU_PAD-step associative ----
    B = 16
    acc = jnp.zeros((B, IMU_PAD + 1, 3), dtype)
    gyr = jnp.zeros((B, IMU_PAD + 1, 3), dtype)
    dts = jnp.full((B, IMU_PAD), 0.005, dtype)
    noise = imu_ops.ImuNoise.euroc(dtype)

    @jax.jit
    def pre_chunk(a, g, d, k):
        a = a + 1e-6 * jnp.sin(k.astype(dtype))
        pres = jax.vmap(lambda aa, gg, dd: imu_ops.preintegrate(
            aa, gg, dd, jnp.zeros(3, dtype), jnp.zeros(3, dtype), noise))(a, g, d)
        return pres.alpha

    t_pre = _time_calls(lambda b: b, lambda i: (pre_chunk(acc, gyr, dts, ks[i % 100]),))

    return dict(pt_full_ms=t_pt_full, pt_light_ms=t_pt_light, ln_ms=t_ln,
                be_dynamic_ms=t_be, pre_chunk_ms=t_pre)


def real_chunk_split():
    import numpy as np

    from plslam import runner
    from plslam.config import (
        CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig,
        TrackerConfig,
    )

    meta = np.load(os.path.join(CACHE, "meta.npz"))
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F,
                            cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True,
                              min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype="float32",
                            focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)),
                                  tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False),
    )
    runner.run_euroc(CACHE, cfg, use_lines=True, burst=16)  # compile pass
    buf = io.StringIO()
    t0 = time.time()
    with redirect_stdout(buf):
        ts, ps, _, est, _ = runner.run_euroc(CACHE, cfg, use_lines=True,
                                             burst=16, progress=True)
    wall = time.time() - t0
    import re

    decs, packs, scans = [], [], []
    for m in re.finditer(r"decode-wait=([\d.]+)s pack\+h2d=([\d.]+)s "
                         r"scan\+pull=([\d.]+)s", buf.getvalue()):
        decs.append(float(m.group(1)))
        packs.append(float(m.group(2)))
        scans.append(float(m.group(3)))
    n_burst = sum(1 for m in est.metrics if m.get("burst"))
    return dict(
        chunks=len(scans),
        decode_wait_s=round(float(np.mean(decs)), 3) if decs else None,
        pack_h2d_s=round(float(np.mean(packs)), 3) if packs else None,
        scan_pull_s=round(float(np.mean(scans)), 3) if scans else None,
        scan_ms_per_frame=round(float(np.mean(scans)) / 16 * 1e3, 2) if scans else None,
        burst_frames=n_burst, published=len(est.metrics),
        wall_s=round(wall, 2),
        published_fps=round(len(est.metrics) / wall, 2),
    )


def ablation_no_solve():
    """Re-run the real chunk with backend_tick stubbed to identity (state
    passes through; empty prior/stats of the right pytree shapes): the
    remaining scan time is frontends + preintegration + table ops + slides +
    plumbing + the chunk readback; full − this = the in-scan solve+marg."""
    import jax.numpy as jnp

    from plslam.models import burst as burst_mod
    from plslam.models import marginalization as marg
    from plslam.models.solver import SolveStats

    orig = burst_mod.backend_tick

    def stub(st, f, solvable, tri_need, fb4, lneed, ln_active2,
             lay, cfg, ee, etd, iters, marg_mode, marg_old_flag=None):
        dtype = st.p.dtype
        z = jnp.zeros((), dtype)
        prior = marg.Prior(
            J=jnp.zeros((lay.dim_cam, lay.dim_cam), dtype),
            r0=jnp.zeros((lay.dim_cam,), dtype), valid=jnp.ones((), dtype),
            p=st.p, q=st.q, v=st.v, ba=st.ba, bg=st.bg,
            p_bc=st.p_bc, q_bc=st.q_bc, td=st.td)
        stats = SolveStats(cost0=z, cost=z, lam=z, accepted=z,
                           cost_robust0=z, cost_robust=z, groups=())
        aux = dict(commit=jnp.zeros_like(solvable),
                   lcommit=jnp.zeros_like(lneed),
                   pt_valid=solvable, ln_solved=ln_active2,
                   pt_err=jnp.zeros_like(solvable),
                   ln_err=jnp.zeros_like(lneed),
                   p_w=jnp.zeros((lay.max_f, 3), dtype))
        return st, stats, prior, aux

    burst_mod.backend_tick = stub
    burst_mod._burst_program.cache_clear()
    try:
        out = real_chunk_split()
    finally:
        burst_mod.backend_tick = orig
        burst_mod._burst_program.cache_clear()
    return out


def ablation_no_tables():
    """Solve stubbed AND device-table ops stubbed to identity: what remains
    is frontends + preint + window-state slides/selects + scan plumbing +
    readback. no_solve − this = the table ops' in-scan cost."""
    import jax.numpy as jnp

    from plslam.models import burst as burst_mod
    from plslam.models import device_table as dtab

    names = ["pt_add_frame", "ln_add_frame", "pt_parallax_keyframe",
             "_pt_clear_where", "_ln_clear_where", "pt_slide_old",
             "ln_slide_old", "pt_slide_new", "ln_slide_new"]
    orig = {n: getattr(dtab, n) for n in names}
    # kf must stay DATA-DEPENDENT (a constant would let XLA prune the whole
    # second-new branch of every carry select, overstating the table cost)
    dtab.pt_add_frame = lambda ptab, W, ids, norm, vel, valid: ptab
    dtab.ln_add_frame = lambda ltab, W, ids, obs, valid: ltab
    dtab.pt_parallax_keyframe = (
        lambda ptab, W, mp: jnp.sum(ptab.obs) < jnp.asarray(1e30, ptab.obs.dtype))
    dtab._pt_clear_where = lambda ptab, drop: ptab
    dtab._ln_clear_where = lambda ltab, drop: ltab
    dtab.pt_slide_old = lambda ptab, *a: ptab
    dtab.ln_slide_old = lambda ltab: ltab
    dtab.pt_slide_new = lambda ptab: ptab
    dtab.ln_slide_new = lambda ltab: ltab
    burst_mod._burst_program.cache_clear()
    try:
        out = ablation_no_solve()
    finally:
        for n, f in orig.items():
            setattr(dtab, n, f)
        burst_mod._burst_program.cache_clear()
    return out


def ablation_no_frontends():
    """Stub the UN-JITTED tick bodies the burst scan composes (indices [2]/[3]
    of _pt_programs, [1] of _ln_program) with passthroughs that fabricate the
    bundles from carried state — the streaming prefix keeps the real JITTED
    programs ([0]/[1]/[4]), so init/handoff semantics are untouched and the
    burst stays engaged (same ids every frame → parallax 0 → all SECOND_NEW).
    full − this = the in-scan frontend cost (2 pyramids + LK×2 + RANSAC +
    detect + Hough/LBD/match)."""
    import jax.numpy as jnp

    from plslam.models import burst as burst_mod
    from plslam.models import frontend_lines as flm
    from plslam.models import frontend_points as fpm
    from plslam.ops.cameras import lift

    orig_pt = fpm._pt_programs
    orig_ln = flm._ln_program

    def patched_pt(*a):
        real = orig_pt(*a)

        def fake_tick(cam, pyr_prev, img_new, state, f_thresh, key, dt,
                      min_score, fov_mask):
            uv, valid, norm, ids, cnt, next_id = state
            m = jnp.sum(img_new[::64, ::64]).astype(norm.dtype) * 1e-12
            norm = norm + m  # data dependence on the image upload
            bf = jnp.concatenate([
                uv, norm, jnp.zeros_like(uv),
                valid.astype(norm.dtype)[:, None],
                cnt.astype(norm.dtype)[:, None]], axis=1)
            return pyr_prev, (uv, valid, norm, ids, cnt, next_id), (bf, ids)

        def fake_light(cam, pyr_prev, img_new, state, fov_mask):
            uv, valid, norm, ids, cnt, next_id = state
            m = jnp.sum(img_new[::64, ::64]).astype(norm.dtype) * 1e-12
            return pyr_prev, (uv, valid, norm + m, ids, cnt, next_id)

        return (real[0], real[1], fake_tick, fake_light, real[4])

    def patched_ln(*a):
        real = orig_ln(*a)

        def fake_tick(cam, img, oct1, have_oct1, segs, desc, valid_f, ids,
                      next_id):
            m = jnp.sum(img[::64, ::64]).astype(segs.dtype) * 1e-12
            segs = segs + m
            lb = jnp.concatenate([lift(cam, segs[:, 0:2]),
                                  lift(cam, segs[:, 2:4]),
                                  valid_f[:, None]], axis=1)
            return (segs, desc, valid_f, ids, next_id), (lb, ids)

        return (real[0], fake_tick)

    fpm._pt_programs = patched_pt
    flm._ln_program = patched_ln
    burst_mod._burst_program.cache_clear()
    try:
        out = real_chunk_split()
    finally:
        fpm._pt_programs = orig_pt
        flm._ln_program = orig_ln
        burst_mod._burst_program.cache_clear()
    return out


def main():
    if "--full-only" in sys.argv:
        print(json.dumps(real_chunk_split()))
        return
    if "--ablate-frontends" in sys.argv:
        abl = ablation_no_frontends()
        print("# no_frontends:", json.dumps(abl))
        return
    if "--ablate-tables" in sys.argv:
        abl2 = ablation_no_tables()
        print("# no_solve_no_tables:", json.dumps(abl2))
        return
    if "--ablate-only" in sys.argv:
        real = real_chunk_split()
        print("# full:", json.dumps(real))
        abl = ablation_no_solve()
        print("# no_solve:", json.dumps(abl))
        if real.get("scan_ms_per_frame") and abl.get("scan_ms_per_frame"):
            print(json.dumps({
                "full_ms_per_frame": real["scan_ms_per_frame"],
                "no_solve_ms_per_frame": abl["scan_ms_per_frame"],
                "solve_marg_in_scan_ms": round(
                    real["scan_ms_per_frame"] - abl["scan_ms_per_frame"], 2),
            }))
        return
    comp = component_times()
    print("# standalone component programs (deployment shapes, median-of-40):")
    for k, v in comp.items():
        print(f"#   {k:16s} {v:7.2f}")
    stride = 2
    step = (comp["pt_full_ms"] + (stride - 1) * comp["pt_light_ms"]
            + comp["ln_ms"] + comp["be_dynamic_ms"] + comp["pre_chunk_ms"] / 16)
    print(f"# implied scan step (stride={stride}): {step:.2f} ms/published frame "
          f"(+ table ops/slides/plumbing)")
    if os.environ.get("PROFILE_COMPONENTS_ONLY"):
        print(json.dumps({k: round(v, 2) for k, v in comp.items()}))
        return
    real = real_chunk_split()
    print(json.dumps({**{k: round(v, 2) for k, v in comp.items()},
                      "implied_step_ms": round(step, 2), **real}))


if __name__ == "__main__":
    main()
