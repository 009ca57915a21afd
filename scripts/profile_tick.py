"""Per-stage timing of the full-system tick on the GPU.

Methodology: measure AFTER ~25 warmup calls, UNIQUE inputs per call
(on-device jitter), trust slopes over iteration counts rather than single
sub-millisecond host timings.

Usage: timeout 900 python scripts/profile_tick.py
"""
import sys
import time

import numpy as np


def timed(fn, args_fn, n=40, warm=30):
    outs = []
    for i in range(warm):
        outs.append(fn(*args_fn(i)))
    import jax
    jax.block_until_ready(outs)
    outs = []
    t0 = time.time()
    for i in range(n):
        outs.append(fn(*args_fn(warm + i)))
    jax.block_until_ready(outs)
    return (time.time() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    import plslam  # noqa: F401
    from plslam.config import SolverConfig
    from plslam.io import render, synthetic
    from plslam.models import frontend_lines as fl
    from plslam.models import frontend_points as fp
    from plslam.models import marginalization as marg
    from plslam.models import packing, solver
    from plslam.models.state import layout
    from plslam.ops.cameras import PinholeRadTan

    dev = jax.devices()[0]
    dtype = jnp.float32
    H, W = 480, 752
    seq = synthetic.make_sequence(duration=1.0, n_points=500, n_lines=48, seed=7)
    cam = PinholeRadTan.create(460.0, 460.0, W / 2, H / 2)
    img = jax.device_put(jnp.asarray(
        render.render_frame(seq, 0, cam, H, W, blob_sigma=2.5, style="textured"),
        dtype), dev)

    @jax.jit
    def jit_img(k):
        return img + 1e-4 * jnp.sin(k.astype(img.dtype))

    ks = [jax.device_put(jnp.asarray(i, jnp.int32), dev) for i in range(200)]

    # ---------------- backend scaling in num_iters ----------------
    cfg = SolverConfig(max_features=192, max_line_feats=64)
    lay = layout(cfg)
    bseq = synthetic.make_sequence(duration=6.0, n_points=420, n_lines=160, seed=3)
    state64, f64v = packing.factors_from_synthetic(bseq, list(range(0, 55, 5)), cfg, lay)
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, t)
    state = jax.device_put(cast(state64), dev)
    f = jax.device_put(cast(f64v), dev)

    @jax.jit
    def jit_state(k):
        return state._replace(p=state.p + 1e-7 * jnp.sin(k.astype(state.p.dtype)))

    for ni in (0, 1, 2, 4, 8):
        @jax.jit
        def solve_only(st, fac, ni=ni):
            st2, stats = solver.optimize_window(st, fac, lay, cfg, num_iters=ni)
            return st2.p, stats.cost
        t = timed(solve_only, lambda i: (jit_state(ks[i % 200]), f))
        print(f"solve num_iters={ni}: {t*1e3:.2f} ms", file=sys.stderr)

    @jax.jit
    def marg_only(st, fac):
        pr = marg.marginalize_old(st, fac, lay, cfg)
        return pr.r0
    t = timed(marg_only, lambda i: (jit_state(ks[i % 200]), f))
    print(f"marginalize_old: {t*1e3:.2f} ms", file=sys.stderr)

    # ---------------- line frontend stages ----------------
    @jax.jit
    def ln_edge(k):
        m, a, e = fl.edge_map(jit_img(k))
        return m[0, 0] + a[0, 0]
    t = timed(ln_edge, lambda i: (ks[i % 200],))
    print(f"lines edge_map(o0): {t*1e3:.2f} ms", file=sys.stderr)

    @jax.jit
    def ln_detect(k):
        im = jit_img(k)
        m, a, e = fl.edge_map(im)
        s, sc, v = fl.detect_segments(m, a, e, H, W, max_out=64)
        return s[0, 0]
    t = timed(ln_detect, lambda i: (ks[i % 200],))
    print(f"lines edge+detect(o0): {t*1e3:.2f} ms", file=sys.stderr)

    @jax.jit
    def ln_full(k):
        im = jit_img(k)
        segs_o, score_o, valid_o = [], [], []
        cur = im
        for o in range(2):
            m, a, e = fl.edge_map(cur)
            s, sc, v = fl.detect_segments(m, a, e, *cur.shape, max_out=64)
            segs_o.append(s * float(2 ** o))
            score_o.append(sc * float(2 ** o))
            valid_o.append(v)
            if o == 0:
                k5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], im.dtype) / 16.0
                cur = fp._sep_conv(cur, k5)[::2, ::2]
        segs, score, valid = fl.merge_candidates(
            jnp.concatenate(segs_o), jnp.concatenate(score_o),
            jnp.concatenate(valid_o), max_out=64)
        gx, gy = fl._scharr(im)
        desc = fl.lbd_descriptors(gx, gy, segs, valid.astype(im.dtype))
        return desc[0, 0]
    t = timed(ln_full, lambda i: (ks[i % 200],))
    print(f"lines full (2-oct detect+merge+LBD): {t*1e3:.2f} ms", file=sys.stderr)

    # ---------------- point frontend ----------------
    NLVL = fp.auto_levels((H, W))
    uv0, sc0 = fp.shi_tomasi_grid(img, jnp.zeros((1, 2), dtype),
                                  jnp.zeros((1,), dtype), cell=30, max_out=150)
    pyr0 = tuple(fp.build_pyramid(img, levels=NLVL))

    @jax.jit
    def pt_pyr(k):
        return fp.build_pyramid(jit_img(k))[0][0, 0]
    t = timed(pt_pyr, lambda i: (ks[i % 200],))
    print(f"points build_pyramid: {t*1e3:.2f} ms", file=sys.stderr)

    @jax.jit
    def pt_lk(k):
        out, st = fp.lk_track_fast(pyr0, fp.build_pyramid(jit_img(k)), uv0, sc0 > 1e-5)
        return out[0, 0]
    t = timed(pt_lk, lambda i: (ks[i % 200],))
    print(f"points pyramid+LK: {t*1e3:.2f} ms", file=sys.stderr)

    @jax.jit
    def pt_detect(k):
        duv, dsc = fp.shi_tomasi_grid(jit_img(k), uv0, (sc0 > 1e-5).astype(dtype),
                                      cell=30, max_out=150)
        return duv[0, 0]
    t = timed(pt_detect, lambda i: (ks[i % 200],))
    print(f"points shi_tomasi_grid: {t*1e3:.2f} ms", file=sys.stderr)

    from plslam.ops.cameras import lift

    @jax.jit
    def pt_ransac(k):
        norm = lift(cam, uv0 + 1e-4 * jnp.sin(k.astype(dtype)))
        inl = fp.fundamental_ransac(norm, norm + 1e-3, sc0 > 1e-5,
                                    jnp.asarray(1.0 / 460.0, dtype),
                                    key=jax.random.PRNGKey(0))
        return inl[0]
    t = timed(pt_ransac, lambda i: (ks[i % 200],))
    print(f"points lift+RANSAC: {t*1e3:.2f} ms", file=sys.stderr)

    print("done", file=sys.stderr)


if __name__ == "__main__":
    main()
