"""Accuracy table over diverse rendered EuRoC-style sequences.

Runs the full image pipeline (PNG → native decode → CLAHE → point[+line]
frontends → initialization → estimator [→ loop closure]) on several
trajectory/noise configurations at EuRoC resolution and prints an
ATE/RPE/scale table — the in-sandbox stand-in for the 11-sequence EuRoC
parity target while the dataset is absent (BASELINE.md; real-data hooks:
`plslam/io/euroc.py`).

Platforms (CPU tests cannot catch accelerator numerics such as TF32
matmuls — the deployment configuration must be measured on the GPU):

  CPU reference:   python scripts/accuracy_table.py --platform cpu
                   (f64 solver by default; --dtype float32 for the f32 ref)
  GPU:             python scripts/accuracy_table.py --platform gpu --burst 16
                   (deployment f32 + offline burst mode)

Rendering always happens in a child process held to the CPU
(JAX_PLATFORMS=cpu), so it never opens the GPU. `--cases a,b` selects rows;
`--seeds N` repeats each selected row over N seeds (seed-spread evidence for
the GPU-vs-CPU gap).
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, F = 480, 752, 460.0
CACHE_ROOT = "/tmp/plslam_acc_ds"

CASES = [
    # name, duration, trajectory params, sequence kwargs, loop closure, lines
    # wiggle_amp = EuRoC-style initialization-excitation preamble (every EuRoC
    # sequence starts with the pilot exciting the IMU; monocular VIO scale /
    # gravity need acceleration variation at init — see TrajectoryParams)
    ("gentle-arc", 8.0, dict(omega=0.3, z_omega=0.6, wiggle_amp=0.15), dict(), False, True),
    ("fast-circle", 8.0, dict(omega=0.5, z_omega=0.8, wiggle_amp=0.15), dict(), False, True),
    # excite_amp: persistent dynamic excitation (EuRoC flights are excited
    # throughout) — on a constant circle, body-frame centripetal acceleration
    # is constant and indistinguishable from accel bias, so scale/bias are
    # UNOBSERVABLE there and the residual bias drifts the scale (~1.11
    # measured); 10 cm of persistent wobble restores observability
    ("imu-noise", 10.0, dict(omega=0.4, z_omega=0.7, wiggle_amp=0.15, excite_amp=0.1),
     dict(acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002), False, True),
    ("loop-revisit", 14.0, dict(omega=0.5, z_omega=0.8, wiggle_amp=0.15),
     dict(acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002), True, False),
    # FULL-FEATURE row (VERDICT r3 item 4): the configuration the EuRoC
    # parity run will actually use — lines + loop closure + online td
    # estimation + in-solver extrinsic refinement (starting from a 1°/1 cm
    # miscalibration), EuRoC-class IMU noise, 60 s (≈5 revisits)
    ("full-feature-60s", 60.0,
     dict(omega=0.5, z_omega=0.8, wiggle_amp=0.15, excite_amp=0.1),
     dict(acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002), True, True,
     dict(estimate_td=True, estimate_extrinsic=1, ext_pert_deg=1.0)),
]


def _cache_dir(name, dur, seed):
    return os.path.join(CACHE_ROOT, f"{name}_{seed}")


def render_case(name, dur, tp, skw, loop, lines, extras=None, seed=17):
    """CPU phase: render the case's dataset into the cache (idempotent)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from plslam.io import render, synthetic
    from plslam.ops.cameras import PinholeRadTan
    from plslam.utils.geometry import quat_to_rot

    out = _cache_dir(name, dur, seed)
    if os.path.exists(os.path.join(out, "meta.npz")):
        return out
    params = synthetic.TrajectoryParams(**tp)
    seq = synthetic.make_sequence(duration=dur, n_points=500, n_lines=40,
                                  seed=seed, params=params, **skw)
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    os.makedirs(out, exist_ok=True)
    render.write_euroc_dataset(seq, out, cam, H, W, max_frames=int(dur * 20),
                               blob_sigma=3.0, style="textured")
    np.savez(os.path.join(out, "meta.npz"),
             R_bc=np.array(quat_to_rot(seq.q_bc)), p_bc=np.array(seq.p_bc),
             gt_t=np.asarray(seq.frame_t), gt_p=np.asarray(seq.gt_p),
             gt_q=np.asarray(seq.gt_q))
    print(f"rendered {name} seed={seed} -> {out}", file=sys.stderr)
    return out


def _ensure_rendered(case, seed):
    """Render in a child process held to the CPU (a second process on the
    GPU would fail for want of memory)."""
    name, dur = case[0], case[1]
    out = _cache_dir(name, dur, seed)
    if os.path.exists(os.path.join(out, "meta.npz")):
        return out
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--render-one",
         name, str(seed)],
        check=True, env=env, timeout=1800)
    return out


def run_case(case, seed, dtype, burst):
    name, dur, tp, skw, loop, lines = case[:6]
    extras = case[6] if len(case) > 6 else {}
    import numpy as np

    from plslam.config import (
        CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig,
        TemporalConfig, TrackerConfig,
    )
    from plslam.eval.metrics import associate, ate_rmse, rpe, umeyama_alignment
    from plslam.runner import run_euroc

    path = _ensure_rendered(case, seed)
    meta = np.load(os.path.join(path, "meta.npz"))
    R_bc = np.asarray(meta["R_bc"])
    p_bc = np.asarray(meta["p_bc"])
    if extras.get("ext_pert_deg"):
        a = np.radians(extras["ext_pert_deg"])
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        R_bc = R_bc @ Rz
        p_bc = p_bc + np.array([0.008, -0.005, 0.006])
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F,
                            cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype=dtype,
                            focal_length=F),
        extrinsic=ExtrinsicConfig(extras.get("estimate_extrinsic", 0),
                                  tuple(R_bc.reshape(-1)), tuple(p_bc)),
        temporal=TemporalConfig(estimate_td=extras.get("estimate_td", False)),
        loop=LoopConfig(loop_closure=loop, min_loop_gap=40, max_keyframes=512),
    )
    ts, ps, qs, est, pg = run_euroc(path, cfg, use_lines=lines, burst=burst)
    gt_t = np.asarray(meta["gt_t"])
    gt_p = np.asarray(meta["gt_p"])
    ate = ate_rmse(ts, ps, gt_t, gt_p, align="yaw")
    rpe_t, rpe_r = rpe(ts, np.asarray(ps), gt_t, gt_p, est_q=np.asarray(qs),
                       gt_q=np.asarray(meta["gt_q"]), delta=1.0)
    # true metric scale via Umeyama sim3: s maps est→gt, so est/gt scale = 1/s
    # (a path-length ratio would conflate jitter with scale — noise always
    # inflates path length)
    pa, ga = associate(ts, np.asarray(ps), gt_t, gt_p)
    s_ug, _, _ = umeyama_alignment(pa, ga, with_scale=True)
    loops = pg.loop_count if pg is not None else 0
    return dict(name=name, seed=seed, frames=len(ts), ate=float(ate),
                rpe_t=float(rpe_t), rpe_r=float(rpe_r),
                scale=float(1.0 / s_ug), loops=int(loops))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--dtype", default=None,
                    help="solver dtype; default f64 on cpu, f32 on gpu")
    ap.add_argument("--burst", type=int, default=0,
                    help="burst chunk size (0 = streaming)")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="run each case over N seeds (17, 18, …)")
    ap.add_argument("--render-one", nargs=2, metavar=("NAME", "SEED"),
                    help="internal: render one case's dataset (CPU phase)")
    args = ap.parse_args()

    if args.render_one:
        name, seed = args.render_one[0], int(args.render_one[1])
        case = next(c for c in CASES if c[0] == name)
        render_case(*case, seed=seed)
        return

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if (args.dtype or "float64") == "float64":
            jax.config.update("jax_enable_x64", True)
    else:
        import jax

        if jax.devices()[0].platform != "gpu":
            sys.exit(f"--platform gpu: JAX's first device is {jax.devices()[0].platform!r}")
    dtype = args.dtype or ("float32" if args.platform == "gpu" else "float64")
    sel = [c for c in CASES
           if not args.cases or c[0] in args.cases.split(",")]
    seeds = [17 + i for i in range(args.seeds)]

    print(f"# platform={args.platform} dtype={dtype} burst={args.burst}")
    print("| case | seed | frames | ATE yaw [m] | RPE-1s [m] | RPE-1s [deg] | scale | loops |")
    print("|---|---|---|---|---|---|---|---|")
    rows = []
    for case in sel:
        for seed in seeds:
            r = run_case(case, seed, dtype, args.burst)
            rows.append(r)
            print(f"| {r['name']} | {r['seed']} | {r['frames']} | {r['ate']:.3f} "
                  f"| {r['rpe_t']:.3f} | {r['rpe_r']:.2f} | {r['scale']:.3f} "
                  f"| {r['loops']} |", flush=True)
    print(json.dumps({"platform": args.platform, "dtype": dtype,
                      "burst": args.burst, "rows": rows}))


if __name__ == "__main__":
    main()
