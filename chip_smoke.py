"""Bring-up check: plslam's main path on one NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --multichip  # four GPUs: the distributed window solves only

Phases (one GPU):
  a. device      — JAX must find a GPU (no CPU fallback); prints its kind and
                   `nvidia-smi` name and power limit;
  b. native      — builds native/libplslam_io.so (PNG decode + CLAHE) and says
                   which decoder is in use;
  c. data        — renders the EuRoC-class sequence (752×480 @ 20 Hz, 200 Hz
                   IMU, 160 frames, seed 17) on the CPU device into
                   `.smoke_data/` (kept between runs);
  d. layers      — each device program against the CPU backend of this same
                   process on identical inputs at real widths: the point tick,
                   the line tick's matching (float and binary descriptors),
                   the keyframe BRIEF Hamming matrix, the backend program
                   and loop closure's pose-graph solve at 2048 keyframes;
  e. end to end  — `runner.run_euroc` at reference capacity (150 corners,
                   192 point / 64 line slots, 11-frame window, float32,
                   lines and loop closure on, CLAHE on), streaming and in
                   16-frame bursts; poses finite, yaw-aligned ATE ≤ 0.35 m.

Every check raises on failure; a failed phase prints its traceback and the
script exits 1 without a result line. The last line of a passing run is
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import plslam  # noqa: E402,F401  (fails fast outside a checkout of the repo)

DATA_DIR = os.path.join(ROOT, ".smoke_data", "euroc_class_seed17")
SEED = 17
# reference capacity
N_FRAMES = 160
MAX_CNT = 150
MAX_FEATURES = 192
MAX_LINE_FEATS = 64
MAX_LINES = 64
BURST = 16
ATE_MAX_M = 0.35  # README's EuRoC-class band; the reference's published range


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ a. device
def phase_device(n_devices: int):
    devs = jax.devices()
    d = devs[0]
    log(f"# device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    check(d.platform == "gpu", f"no GPU: JAX's first device is {d.platform!r}")
    check(len(devs) >= n_devices, f"need {n_devices} GPUs, JAX found {len(devs)}")
    # a child that does not import JAX reads the card's name and power limit
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in out.strip().splitlines():
        log(f"# nvidia-smi: {line.strip()}")
    return devs


# ------------------------------------------------------------ b. native
def phase_native():
    from plslam.io import native

    err = native.build_error()
    if err is None:
        log(f"# decoder: native C++ ({native.LIB_PATH})")
    else:
        log(f"# decoder: Python fallback — native build failed:\n{err}")
    check(err is None, "native IO library did not build")


# ------------------------------------------------------------ c. data
def phase_data(cpu):
    from plslam.io import render

    t0 = time.perf_counter()
    with jax.default_device(cpu):
        meta = render.write_euroc_class_dataset(DATA_DIR, seed=SEED,
                                                n_frames=N_FRAMES)
    n = len(os.listdir(os.path.join(DATA_DIR, "mav0", "cam0", "data")))
    h, w = render.EUROC_CLASS_SHAPE
    log(f"# data: {n} frames {w}x{h} in {DATA_DIR} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(n == N_FRAMES and int(meta["seed"]) == SEED,
          f"{DATA_DIR} holds {n} frames of seed {int(meta['seed'])}, "
          f"not {N_FRAMES} of seed {SEED}")
    return meta


def smoke_config(meta):
    from plslam.config import (CameraConfig, ExtrinsicConfig, PLSlamConfig,
                               SolverConfig, TrackerConfig)
    from plslam.io.render import EUROC_CLASS_INTRINSICS, EUROC_CLASS_SHAPE

    fx, fy, cx, cy = EUROC_CLASS_INTRINSICS
    h, w = EUROC_CLASS_SHAPE
    return PLSlamConfig(
        camera=CameraConfig(image_width=w, image_height=h,
                            fx=fx, fy=fy, cx=cx, cy=cy, k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=MAX_CNT, min_dist=30, equalize=True,
                              min_score=2e-3, max_lines=MAX_LINES),
        solver=SolverConfig(max_features=MAX_FEATURES,
                            max_line_feats=MAX_LINE_FEATS, dtype="float32",
                            focal_length=fx),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)),
                                  tuple(meta["p_bc"])),
    )


def _frames(cfg):
    """Frames 0 and 1 as `run_euroc` feeds them: decode → CLAHE → uint8."""
    from plslam.io.euroc import EurocSequence
    from plslam.models.frontend_points import to_u8
    from plslam.runner import _clahe

    seq = EurocSequence.load(DATA_DIR)
    return [to_u8(_clahe(seq.image(k)) if cfg.tracker.equalize else seq.image(k))
            for k in (0, 1)]


# ------------------------------------------------------------ d. layers
def check_point_tick(cfg, gpu, cpu):
    """Fused point tick (pyramid + LK + RANSAC + detection + refill) on frame
    1, from the CPU's frame-0 detection, on both backends with one PRNG key.
    Precision: the frontend default — TF32 matmuls on the GPU. Tolerances:
    tracked uv median |Δ| ≤ 0.05 px; status equal on ≥ 95 % of live slots."""
    from plslam.models import frontend_points as fp
    from plslam.ops.cameras import make_camera

    img0, img1 = _frames(cfg)
    tc = cfg.tracker
    prog, det_prog, _, _, _ = fp._pt_programs(tc.min_dist, tc.max_cnt, False,
                                              False, jnp.float32)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    with jax.default_device(cpu):
        cam = make_camera(cfg.camera)
        mask = jnp.zeros((1, 1), jnp.float32)
        pyr0, st0, _ = det_prog(cam, jnp.asarray(img0), f32(tc.min_score), mask)
        args = (cam, pyr0, jnp.asarray(img1), st0,
                f32(tc.f_threshold / cfg.camera.fx),
                jax.random.fold_in(jax.random.PRNGKey(7), 1), f32(0.05),
                f32(tc.min_score), mask)
    out = {}
    for name, dev in (("cpu", cpu), ("gpu", gpu)):
        _, st1, _ = prog(*jax.device_put(args, dev))
        uv, _, _, _, cnt, _ = (np.asarray(a) for a in st1)
        out[name] = (uv, cnt >= 2)  # tracked from frame 0 (refills restart at 1)
    live = np.asarray(st0[1])
    (uv_c, ok_c), (uv_g, ok_g) = out["cpu"], out["gpu"]
    agree = float(np.mean(ok_c[live] == ok_g[live]))
    both = ok_c & ok_g
    med = float(np.median(np.linalg.norm(uv_c[both] - uv_g[both], axis=1)))
    log(f"# point tick: {int(live.sum())} live slots, tracked cpu={int(ok_c.sum())} "
        f"gpu={int(ok_g.sum())}, status agree {agree:.4f} (≥ 0.95), "
        f"tracked uv median |Δ| {med:.5f} px (≤ 0.05)")
    check(both.sum() >= 0.5 * live.sum(), "fewer than half the live slots tracked")
    check(agree >= 0.95, f"point status agreement {agree:.4f} < 0.95")
    check(med <= 0.05, f"tracked uv median difference {med:.5f} px > 0.05")


def check_line_tick(cfg, gpu, cpu):
    """Line tick (2-octave Hough + merge + LBD) on frames 0 and 1, in both
    descriptor modes. The full tick runs on both backends from the CPU's
    frame-0 state (segment and id agreement printed as information). The
    matcher is then held to identical inputs — the CPU's descriptors:
      float  — cosine matmul at the frontend default (TF32 on the GPU);
               matches equal on ≥ 95 % of valid frame-0 lines;
      binary — the Hamming matrix is integer xor + popcount: exactly equal,
               and so are the matches.
    The keyframe database's BRIEF Hamming matrix (256 × 256 keypoints of
    frames 0 and 1) must be exactly equal too."""
    from plslam.models import frontend_lines as fl
    from plslam.models import keyframe_db as kdb
    from plslam.ops.cameras import make_camera

    u8 = _frames(cfg)
    L = cfg.tracker.max_lines
    with jax.default_device(cpu):
        cam = make_camera(cfg.camera)
        img0, img1 = (jnp.asarray(i, jnp.float32) / 255.0 for i in u8)
        dummy_oct1 = jnp.zeros((2, 2), jnp.float32)
    for binary in (False, True):
        prog, _ = fl._ln_program(L, 2, binary, jnp.float32)
        with jax.default_device(cpu):
            desc0 = (jnp.zeros((L, 8), jnp.uint32) if binary
                     else jnp.zeros((L, fl.N_BANDS * 8), jnp.float32))
            empty = (jnp.zeros((L, 4), jnp.float32), desc0,
                     jnp.zeros((L,), jnp.float32), jnp.full((L,), -1, jnp.int32),
                     jnp.zeros((), jnp.int32))
            s0, _ = prog(cam, img0, dummy_oct1, False, *empty)
        outs = {}
        for name, dev in (("cpu", cpu), ("gpu", gpu)):
            a = jax.device_put((cam, img1, dummy_oct1, s0), dev)
            outs[name], _ = prog(a[0], a[1], a[2], False, *a[3])
        sc, sg = ([np.asarray(x) for x in outs[k]] for k in ("cpu", "gpu"))
        vc, vg = sc[2] > 0, sg[2] > 0
        d = np.linalg.norm(sc[0][vc][:, None, :] - sg[0][vg][None, :, :], axis=-1)
        seg_hit = float(np.mean(d.min(axis=1) < 1.0)) if vc.any() and vg.any() else 0.0
        carried = lambda s: set(s[3][(s[3] >= 0) & (s[3] < int(np.asarray(s0[4])))])
        ic, ig = carried(sc), carried(sg)
        jacc = len(ic & ig) / max(len(ic | ig), 1)
        mode = "binary" if binary else "float"
        log(f"# line tick ({mode}): segments cpu={int(vc.sum())} gpu={int(vg.sum())}, "
            f"cpu segments with a gpu twin < 1 px {seg_hit:.3f}, tracked ids "
            f"cpu={len(ic)} gpu={len(ig)} jaccard {jacc:.3f} (information)")
        check(vg.sum() > 0, f"GPU line tick ({mode}) found no segments")

        # matcher on identical inputs (the CPU's frame-0 → frame-1 descriptors)
        m_in = (s0[1], s0[0], s0[2], outs["cpu"][1], outs["cpu"][0], outs["cpu"][2])
        match = fl.match_lbd_binary if binary else fl.match_lbd
        mc, mg = (np.asarray(match(*jax.device_put(m_in, dev))) for dev in (cpu, gpu))
        v0 = np.asarray(s0[2]) > 0
        agree = float(np.mean(mc[v0] == mg[v0]))
        n_m = int((mc[v0] >= 0).sum())
        if binary:
            hc, hg = (np.asarray(fl._hamming_dist(*jax.device_put((m_in[0], m_in[3]), dev)))
                      for dev in (cpu, gpu))
            log(f"# line match (binary): {n_m} matches, agree {agree:.4f} (== 1), "
                f"Hamming {hc.shape} exactly equal: {bool(np.array_equal(hc, hg))}")
            check(np.array_equal(hc, hg), "line Hamming matrix differs between backends")
            check(agree == 1.0, f"binary line matches differ ({agree:.4f})")
        else:
            log(f"# line match (float, TF32 on GPU): {n_m} matches, "
                f"agree {agree:.4f} (≥ 0.95)")
            check(agree >= 0.95, f"float line match agreement {agree:.4f} < 0.95")

    with jax.default_device(cpu):
        descs = []
        for img in (img0, img1):
            uv, sc = kdb.shi_tomasi_grid(img, jnp.zeros((1, 2), jnp.float32),
                                         jnp.zeros((1,), jnp.float32), cell=16,
                                         max_out=kdb.MAX_KP)
            descs.append(kdb.brief_descriptors(img, uv, (sc > 1e-5).astype(jnp.float32))[0])
    hc, hg = (np.asarray(kdb.hamming_matrix(*jax.device_put(tuple(descs), dev)))
              for dev in (cpu, gpu))
    log(f"# keyframe BRIEF Hamming {hc.shape}: exactly equal: {bool(np.array_equal(hc, hg))}")
    check(np.array_equal(hc, hg), "keyframe Hamming matrix differs between backends")


def check_backend(gpu, cpu):
    """`__graft_entry__.entry()` — triangulation + 8-iteration LM/Schur +
    FEJ marginalization at 192/64 slots, 0.5 px observation noise — on both
    backends. Precision: 'highest' (true f32, the estimator's setting).
    Tolerances: final cost relative |Δ| ≤ 1e-3; window positions |Δ| ≤ 1 mm.
    The same difference at PLSLAM_MATMUL_PRECISION=default (TF32) is printed
    as a finding only."""
    import __graft_entry__ as ge

    with jax.default_device(cpu):
        fn, args = ge.entry()
    nw = args[0].p.shape[0]

    def run(dev):
        b = np.asarray(jax.jit(fn)(*jax.device_put(args, dev)))
        return b[-4], b[: nw * 3].reshape(nw, 3)  # stats.cost, st_out.p

    cost_c, p_c = run(cpu)
    cost_g, p_g = run(gpu)
    rel = abs(cost_g - cost_c) / max(abs(cost_c), 1e-30)
    dp = float(np.max(np.abs(p_g - p_c)))
    log(f"# backend ('highest'): cost cpu={cost_c:.6e} gpu={cost_g:.6e} "
        f"rel |Δ| {rel:.3e} (≤ 1e-3), positions max |Δ| {dp * 1e3:.4f} mm (≤ 1)")
    compiled = jax.jit(fn).lower(*jax.device_put(args, gpu)).compile()
    log(f"# backend memory_analysis: {compiled.memory_analysis()}")
    check(np.isfinite(cost_g) and np.isfinite(p_g).all(), "non-finite backend output")
    check(rel <= 1e-3, f"backend cost relative difference {rel:.3e} > 1e-3")
    check(dp <= 1e-3, f"backend positions differ by {dp * 1e3:.4f} mm > 1 mm")

    # the precision level is read when the program is traced: fresh traces
    old = os.environ.get("PLSLAM_MATMUL_PRECISION")
    os.environ["PLSLAM_MATMUL_PRECISION"] = "default"
    jax.clear_caches()
    try:
        cost_d, p_d = run(gpu)
    finally:
        if old is None:
            os.environ.pop("PLSLAM_MATMUL_PRECISION")
        else:
            os.environ["PLSLAM_MATMUL_PRECISION"] = old
        jax.clear_caches()
    log(f"# backend ('default', finding only): cost gpu={cost_d:.6e} rel |Δ| vs cpu "
        f"{abs(cost_d - cost_c) / max(abs(cost_c), 1e-30):.3e}, positions max |Δ| "
        f"{float(np.max(np.abs(p_d - p_c))) * 1e3:.4f} mm")


def drifting_circuit(n: int, yaw_drift: float = 0.2):
    """A closed 3 m circuit of `n` keyframes as the VIO sees it (yaw drifting
    linearly to `yaw_drift` rad, positions integrated through that drift),
    with its ground truth: (gt_p, gt_yaw, vio_p, vio_yaw)."""
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    gt_p = np.stack([3.0 * np.cos(t), 3.0 * np.sin(t), 0.2 * np.sin(2.0 * t)], axis=1)
    gt_yaw = t + np.pi / 2.0
    drift = np.linspace(0.0, yaw_drift, n)
    dp = np.diff(gt_p, axis=0)
    c, s = np.cos(drift[:-1]), np.sin(drift[:-1])
    step = np.stack([c * dp[:, 0] - s * dp[:, 1], s * dp[:, 0] + c * dp[:, 1], dp[:, 2]], axis=1)
    vio_p = gt_p[0] + np.concatenate([np.zeros((1, 3)), np.cumsum(step, axis=0)])
    return gt_p, gt_yaw, vio_p, gt_yaw + drift


def check_pose_graph(gpu, cpu, n_kf: int = 2000):
    """Loop closure's 4-DoF pose-graph solve, `PoseGraph.optimize`, at the
    default 2048-keyframe capacity: an `n_kf`-keyframe circuit whose VIO
    drifts 0.2 rad in yaw, closed by one ground-truth loop edge, solved from
    identical graphs on both backends. At this capacity it is the dense
    path: (4·2048)² normal equations and a Cholesky, f32 at 'highest'.
    Tolerances: optimized positions max |Δ| GPU vs CPU ≤ 1 cm; the GPU's
    last keyframe ends within 0.35× its pre-closure error of ground truth."""
    from plslam.config import LoopConfig
    from plslam.models import pose_graph as pgm
    from plslam.utils import quat_np as qnp

    gt_p, gt_yaw, vio_p, vio_yaw = drifting_circuit(n_kf)
    R0 = pgm._rot_ypr_np(gt_yaw[0])
    loop = dict(i=0, j=n_kf - 1, t=R0.T @ (gt_p[-1] - gt_p[0]),
                yaw=gt_yaw[-1] - gt_yaw[0], w=2.0, loop=1)
    out = {}
    for name, dev in (("cpu", cpu), ("gpu", gpu)):
        g = pgm.PoseGraph(LoopConfig())
        for k in range(n_kf):
            g.add_keyframe(float(k), vio_p[k], qnp.rot_to_quat(pgm._rot_ypr_np(vio_yaw[k])))
        g.edges.append(dict(loop))
        t0 = time.perf_counter()
        with jax.default_device(dev):
            g.optimize(iters=15)
        out[name] = (g.opt_p[:n_kf].copy(), time.perf_counter() - t0)
    (p_c, t_c), (p_g, t_g) = out["cpu"], out["gpu"]
    dp_cm = float(np.max(np.abs(p_g - p_c))) * 100
    err0 = float(np.linalg.norm(vio_p[-1] - gt_p[-1]))
    err_g = float(np.linalg.norm(p_g[-1] - gt_p[-1]))
    log(f"# pose graph ({n_kf} keyframes, capacity {LoopConfig().max_keyframes}): "
        f"positions max |Δ| {dp_cm:.4f} cm (≤ 1), last keyframe error "
        f"{err0:.4f} → {err_g:.4f} m (≤ 0.35×), first call cpu {t_c:.2f} s "
        f"gpu {t_g:.2f} s (compile included)")
    check(np.isfinite(p_g).all(), "non-finite pose-graph positions on the GPU")
    check(dp_cm <= 1.0, f"pose-graph positions differ by {dp_cm:.4f} cm > 1 cm")
    check(err_g < 0.35 * err0, f"the GPU solve did not close the loop ({err0:.4f} → {err_g:.4f} m)")


# ------------------------------------------------------------ e. end to end
_COMPILE_S = [0.0]


def _on_event(name, secs, **_):
    if name.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += secs


def run_pass(cfg, meta, burst: int, gpu, tag: str):
    from plslam import runner
    from plslam.eval.metrics import ate_rmse

    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    ts, ps, _, est, pg = runner.run_euroc(DATA_DIR, cfg, use_lines=True, burst=burst)
    wall = time.perf_counter() - t0
    compile_s = _COMPILE_S[0] - c0
    n_pub = len(est.metrics)
    n_burst = sum(1 for m in est.metrics if m.get("burst"))
    ps = np.asarray(ps)
    check(len(ts) >= 3, f"{tag}: only {len(ts)} poses published")
    check(np.isfinite(ps).all(), f"{tag}: non-finite published pose")
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    peak = (gpu.memory_stats() or {}).get("peak_bytes_in_use", -1)
    log(f"# e2e {tag}: {len(ts)} poses of {n_pub} published ({n_burst} in bursts), "
        f"loops {pg.loop_count if pg is not None else 0}, ATE(yaw) {ate:.4f} m "
        f"(≤ {ATE_MAX_M}), wall {wall:.2f} s, compile {compile_s:.2f} s, "
        f"{n_pub / wall:.2f} published frames/s, peak_bytes_in_use {peak}")
    check(ate <= ATE_MAX_M, f"{tag}: ATE {ate:.4f} m > {ATE_MAX_M} m")
    if burst:
        check(n_burst > 0, f"{tag}: no frame ran in a burst chunk")


def phase_e2e(cfg, meta, gpu):
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    # cold pass (compiles), then warm
    for burst in (0, BURST):
        for run in ("cold", "warm"):
            run_pass(cfg, meta, burst, gpu, f"burst={burst} {run}")


# ------------------------------------------------------------ f. multichip
def phase_multichip(devs):
    """Large-window refinement across 4 devices, each against the single
    -device `solver.optimize_window` on the same perturbed 192/64 window
    (0.5 px observation noise), at
    'highest' precision: window positions |Δ| ≤ 1 mm, cost relative
    |Δ| ≤ 1e-3."""
    import __graft_entry__ as ge
    from plslam.config import SolverConfig
    from plslam.models import solver
    from plslam.models.state import layout, retract
    from plslam.parallel import distributed_ba as dba, dp, mesh2d

    cfg = SolverConfig(max_features=MAX_FEATURES, max_line_feats=MAX_LINE_FEATS)
    lay = layout(cfg)
    n = 4
    state, f = ge._make_window(cfg, lay, jnp.float32, n_points=420, n_lines=160,
                               pix_noise=0.5)
    rng = np.random.default_rng(SEED)
    delta = np.zeros(lay.dim, np.float32)
    delta[6: lay.nw * 6] = rng.standard_normal((lay.nw - 1) * 6) * 0.005
    state = retract(state, jnp.asarray(delta), lay)
    iters = 8
    st_ref, stats = solver.optimize_window(state, f, lay, cfg, num_iters=iters)
    p_ref, c_ref = np.asarray(st_ref.p), float(stats.cost)

    def compare(tag, p, c):
        dp_mm = float(np.max(np.abs(np.asarray(p) - p_ref))) * 1e3
        rel = abs(float(c) - c_ref) / max(abs(c_ref), 1e-30)
        log(f"# multichip {tag}: positions max |Δ| {dp_mm:.4f} mm (≤ 1), "
            f"cost rel |Δ| {rel:.3e} (≤ 1e-3)")
        check(np.isfinite(np.asarray(p)).all(), f"{tag}: non-finite positions")
        check(dp_mm <= 1.0 and rel <= 1e-3, f"{tag}: differs from the single-device solve")

    st_d, cost_d = dba.distributed_optimize_window(state, f, lay, cfg,
                                                   dba.make_mesh(n), num_iters=iters)
    compare(f"distributed_ba 'lmk'={n}", st_d.p, cost_d)

    stack = lambda t, k: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (k, *a.shape)), t)
    st_2d, costs = mesh2d.partitioned_distributed_solve(
        stack(state, 2), stack(f, 2), lay, cfg, mesh2d.make_mesh2d(2, 2), num_iters=iters)
    for k in range(2):
        compare(f"mesh2d (2,2) partition {k}", st_2d.p[k], costs[k])

    st_b, cost_b = dp.batched_optimize_windows(stack(state, n), stack(f, n), lay, cfg,
                                               num_iters=iters, mesh=dba.make_mesh(n))
    for k in range(n):
        compare(f"dp batch {k}", st_b.p[k], cost_b[k])


# ------------------------------------------------------------ driver
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-GPU distributed window solves")
    args = ap.parse_args(argv)
    n_dev = 4 if args.multichip else 1
    t_start = time.perf_counter()
    try:
        devs = phase_device(n_dev)
    except Exception:
        traceback.print_exc()
        return 1
    from plslam.utils.device import enable_compile_cache

    log(f"# compile cache: {enable_compile_cache()}")
    gpu, cpu = devs[0], jax.devices("cpu")[0]
    failed = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            log(f"# [{name}] FAILED after {time.perf_counter() - t0:.1f} s")
            return None
        log(f"# [{name}] ok ({time.perf_counter() - t0:.1f} s)")
        return out

    if args.multichip:
        phase("multichip", phase_multichip, devs)
    else:
        phase("native", phase_native)
        meta = phase("data", phase_data, cpu)
        if meta is not None:
            cfg = smoke_config(meta)
            phase("point tick", check_point_tick, cfg, gpu, cpu)
            phase("line tick", check_line_tick, cfg, gpu, cpu)
            phase("backend", check_backend, gpu, cpu)
            phase("pose graph", check_pose_graph, gpu, cpu)
            phase("end to end", phase_e2e, cfg, meta, gpu)
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    if failed:
        log(f"# FAILED: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {"platform": gpu.platform,
                                             "kind": gpu.device_kind,
                                             "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
