import jax.numpy as jnp
import numpy as np
import pytest

from plslam.config import LoopConfig
from plslam.models import keyframe_db as kdb
from plslam.models import pose_graph as pg
from plslam.utils.geometry import rot_to_quat, ypr_to_rot


def make_drifting_loop(n=40, yaw_drift_total=0.15, pos_drift_total=0.5):
    """GT: square-ish loop. VIO: same with accumulated yaw+position drift."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt_p = np.stack([3 * np.cos(t), 3 * np.sin(t), 0.2 * np.sin(2 * t)], axis=1)
    gt_yaw = t + np.pi / 2
    drift_yaw = np.linspace(0, yaw_drift_total, n)
    vio_p = np.zeros_like(gt_p)
    vio_yaw = gt_yaw + drift_yaw
    # integrate drifted odometry: each step rotated by accumulated yaw drift
    vio_p[0] = gt_p[0]
    for k in range(1, n):
        dp = gt_p[k] - gt_p[k - 1]
        Rz = np.asarray(ypr_to_rot(jnp.asarray([drift_yaw[k - 1], 0.0, 0.0])))
        vio_p[k] = vio_p[k - 1] + Rz @ dp
    return gt_p, gt_yaw, vio_p, vio_yaw


def test_optimize_4dof_closes_loop():
    n = 40
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n)
    g = pg.PoseGraph(LoopConfig(max_keyframes=64))
    for k in range(n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    # inject the loop edge (kf n-1 → kf 0 GT relative pose, as findConnection would)
    Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[0], 0.0, 0.0])))
    rel_t = Ri.T @ (gt_p[n - 1] - gt_p[0])
    rel_yaw = gt_yaw[n - 1] - gt_yaw[0]
    g.edges.append(dict(i=0, j=n - 1, t=rel_t, yaw=rel_yaw, w=2.0, loop=1))

    err_before = np.linalg.norm(vio_p[n - 1] - gt_p[n - 1])
    g.optimize(iters=25)
    err_after = np.linalg.norm(g.opt_p[n - 1] - gt_p[n - 1])
    assert err_after < err_before * 0.35, (err_before, err_after)
    # drift correction maps live VIO poses near GT
    p_corr, q_corr = g.correct(vio_p[n - 1], np.array([1.0, 0, 0, 0]))
    assert np.linalg.norm(p_corr - gt_p[n - 1]) < err_before * 0.5


def test_two_loops_sequential_edges_stay_vio_pure():
    """Sequential edges added AFTER a PGO correction must be measured from
    VIO poses only (SURVEY.md §A.7): a second loop after the first correction
    closes just as well, and post-correction sequential-edge measurements
    match GT relative poses to the same per-step-drift tolerance as
    pre-correction ones (regression for opt/vio frame mixing)."""
    n = 80
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n, yaw_drift_total=0.2)
    g = pg.PoseGraph(LoopConfig(max_keyframes=128))
    n1 = n // 2

    def gt_edge(i, j):
        Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[i], 0.0, 0.0])))
        return dict(i=i, j=j, t=Ri.T @ (gt_p[j] - gt_p[i]),
                    yaw=gt_yaw[j] - gt_yaw[i], w=2.0, loop=1)

    for k in range(n1):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    g.edges.append(gt_edge(0, n1 - 1))
    g.optimize(iters=25)
    assert abs(g.yaw_drift) > 0.01  # the first correction actually moved yaw

    # keep adding keyframes after the correction; their sequential edges must
    # NOT encode the applied yaw drift as a measurement
    n_edges_before = len(g.edges)
    for k in range(n1, n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    per_step_drift = 0.2 / (n - 1)  # incremental VIO yaw drift per step
    for e in g.edges[n_edges_before:]:
        if e["loop"]:
            continue
        i, j = e["i"], e["j"]
        gt_rel_yaw = gt_yaw[j] - gt_yaw[i]
        # measurement error bounded by the VIO's own per-step drift — NOT by
        # the ~0.1 rad first correction (which frame mixing would inject)
        assert abs(e["yaw"] - gt_rel_yaw) < per_step_drift * (j - i) + 1e-9, (i, j)
        Ri_gt = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[i], 0.0, 0.0])))
        gt_rel_t = Ri_gt.T @ (gt_p[j] - gt_p[i])
        assert np.linalg.norm(e["t"] - gt_rel_t) < 0.05, (i, j)

    # second loop closes on top of the first correction
    g.edges.append(gt_edge(5, n - 1))
    g.optimize(iters=25)
    err_after = np.linalg.norm(g.opt_p[n - 1] - gt_p[n - 1])
    assert err_after < 0.1, err_after
    # the whole optimized path is near GT (both halves, not just the ends)
    errs = np.linalg.norm(g.opt_p[:n] - gt_p[:n], axis=1)
    assert errs.max() < 0.25, errs.max()


def test_save_load_roundtrip(tmp_path):
    n = 10
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n)
    g = pg.PoseGraph(LoopConfig(max_keyframes=64))
    for k in range(n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    path = str(tmp_path / "pg.npz")
    g.save(path)
    g2 = pg.PoseGraph(LoopConfig(max_keyframes=64))
    g2.load(path)
    assert g2.n == g.n
    np.testing.assert_allclose(g2.vio_p[: g.n], g.vio_p[: g.n])
    assert len(g2.edges) == len(g.edges)


def _texture(rng, h=240, w=320):
    from test_frontend import smooth_texture

    return smooth_texture(rng, h, w)


def test_brief_descriptors_discriminative():
    rng = np.random.default_rng(1)
    img = _texture(rng)
    img_j = jnp.asarray(img)
    uv, valid, desc, gdesc = kdb.extract_keyframe_features(img_j)
    # same keypoints, same image → distance 0; different keypoints → large
    d = np.asarray(kdb.hamming_matrix(jnp.asarray(desc), jnp.asarray(desc)))
    n = valid.sum()
    assert (np.diag(d)[: n] == 0).all()
    off = d[np.triu_indices(int(n), k=1)]
    assert np.median(off) > 60  # random pairs ~128


def test_global_descriptor_place_recognition():
    rng = np.random.default_rng(2)
    imgs = [_texture(np.random.default_rng(s)) for s in range(6)]
    descs = []
    for im in imgs:
        *_, g = kdb.extract_keyframe_features(jnp.asarray(im))
        descs.append(g)
    # a slightly shifted revisit of scene 0 should match scene 0 best
    from test_frontend import shift_image

    revisit = shift_image(imgs[0], 2.0, 1.0)
    *_, g_re = kdb.extract_keyframe_features(jnp.asarray(revisit))
    sims = np.asarray([g @ g_re for g in descs])
    assert sims.argmax() == 0
    assert sims[0] > 0.5


def test_pnp_ransac_with_outliers():
    rng = np.random.default_rng(4)
    n = 40
    pts_w = rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]
    R_gt = np.asarray(ypr_to_rot(jnp.asarray([0.3, 0.1, -0.05])))
    t_gt = np.array([0.5, -0.2, 0.3])
    pc = pts_w @ R_gt.T + t_gt
    obs = pc[:, :2] / pc[:, 2:3]
    bad = rng.choice(n, 8, replace=False)
    obs[bad] += rng.uniform(0.05, 0.15, (8, 2)) * rng.choice([-1, 1], (8, 2))
    out = kdb.pnp_ransac(pts_w, obs, min_inliers=12)
    assert out is not None
    R, t, inl = out
    assert np.abs(R - R_gt).max() < 1e-2
    assert np.linalg.norm(t - t_gt) < 0.02
    assert inl[bad].sum() <= 2


@pytest.mark.slow
def test_relocalize_against_saved_map(tmp_path):
    """Session A maps a scene from rendered imagery and saves the pose graph;
    session B (whose world frame is drifted/rotated) loads it, revisits the
    place, confirms an appearance loop INTO THE LOADED MAP (BRIEF + PnP — no
    GT edge injection) and `fast_relocalization` snaps its drift so corrected
    poses land in the map frame (`load_previous_pose_graph` +
    `fast_relocalization`, SURVEY.md §5.4)."""
    import jax.numpy as jnp

    from plslam.io import render, synthetic
    from plslam.ops.cameras import PinholeRadTan, normalized_to_pixel
    from plslam.runner import _clahe
    from plslam.utils.geometry import quat_mul, quat_to_rot

    H, W = 240, 376
    params = synthetic.TrajectoryParams(omega=0.5, z_omega=0.8)
    seq = synthetic.make_sequence(duration=14.0, n_points=500, n_lines=0, seed=23,
                                  params=params)
    cam = PinholeRadTan.create(160.0, 160.0, W / 2, H / 2)
    lms = np.asarray(seq.landmarks)

    def kf_inputs(k):
        """Rendered image + GT window points (uv px, ids, world 3D) + body pose."""
        img = _clahe(render.render_frame(seq, k, cam, H, W, blob_sigma=3.0,
                                         style="textured"))
        vis = np.nonzero(np.asarray(seq.obs_valid[k]))[0]
        uv = np.asarray(normalized_to_pixel(cam, jnp.asarray(seq.obs[k])[vis]), np.float64)
        inb = (uv[:, 0] > 18) & (uv[:, 0] < W - 18) & (uv[:, 1] > 18) & (uv[:, 1] < H - 18)
        return img, uv[inb], vis[inb], lms[vis[inb]]

    cfg = LoopConfig(loop_closure=True, min_loop_gap=40, max_keyframes=128,
                     fast_relocalization=True)

    # ---- session A: map frames around the start of the circle, save ----
    R_bc = np.asarray(quat_to_rot(seq.q_bc))
    p_bc = np.asarray(seq.p_bc)
    gA = pg.PoseGraph(cfg, focal=160.0, R_bc=R_bc, p_bc=p_bc)
    for k in range(0, 36, 6):
        img, uv, ids, pts3d = kf_inputs(k)
        gA.add_keyframe(float(np.asarray(seq.frame_t[k])), np.asarray(seq.gt_p[k]),
                        np.asarray(seq.gt_q[k]), img=img, cam=cam,
                        win_uv=uv, win_pts3d=pts3d, win_ids=ids)
    path = str(tmp_path / "map.npz")
    gA.save(path)

    # ---- session B: drifted world frame, revisit after one circle period ----
    dyaw = np.deg2rad(4.0)
    Rz = np.asarray(ypr_to_rot(jnp.asarray([dyaw, 0.0, 0.0])))
    q_z = np.asarray(rot_to_quat(jnp.asarray(Rz)))
    t_d = np.array([0.35, -0.2, 0.1])
    gB = pg.PoseGraph(cfg, focal=160.0, R_bc=R_bc, p_bc=p_bc)
    gB.load(path)
    assert gB.base_n == gA.n

    j = 10 + int(2 * np.pi / 0.5 * 20)  # one period later ≈ revisit of frame 10
    img, uv, ids, pts3d = kf_inputs(j)
    p_B = Rz @ np.asarray(seq.gt_p[j]) + t_d  # session-B (drifted) VIO pose
    q_B = np.asarray(quat_mul(jnp.asarray(q_z), jnp.asarray(np.asarray(seq.gt_q[j]))))
    pts3d_B = pts3d @ Rz.T + t_d  # window landmarks in the drifted world
    loop = gB.add_keyframe(float(np.asarray(seq.frame_t[j])), p_B, q_B, img=img,
                           cam=cam, win_uv=uv, win_pts3d=pts3d_B, win_ids=ids)
    assert loop is not None, gB.stats
    assert loop["i"] < gB.base_n  # the edge lands in the LOADED map

    gB.fast_relocalize(loop)
    p_corr, q_corr = gB.correct(p_B, q_B)
    err = np.linalg.norm(p_corr - np.asarray(seq.gt_p[j]))
    assert err < 0.15, (err, gB.stats)


def _pgo_arrays(g, K):
    """Pack a PoseGraph's nodes+edges into the optimize_4dof* array form."""
    E = len(g.edges)
    e_i = np.array([e["i"] for e in g.edges], np.int32)
    e_j = np.array([e["j"] for e in g.edges], np.int32)
    e_t = np.stack([e["t"] for e in g.edges])
    e_yaw = np.array([e["yaw"] for e in g.edges])
    e_w = np.array([e["w"] for e in g.edges])
    e_loop = np.array([float(e["loop"]) for e in g.edges])
    e_valid = np.ones(E)
    node_valid = np.zeros(K)
    node_valid[: g.n] = 1.0
    return (jnp.asarray(g.opt_p[:K]), jnp.asarray(g.opt_yaw[:K]),
            jnp.asarray(g.pitch[:K]), jnp.asarray(g.roll[:K]), jnp.asarray(node_valid),
            jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(e_t), jnp.asarray(e_yaw),
            jnp.asarray(e_w), jnp.asarray(e_valid), jnp.asarray(e_loop))


def test_pcg_matches_dense_pgo():
    """The matrix-free PCG 4-DoF PGO (large-capacity path) must agree with the
    dense-Hessian solve on the same graph."""
    n = 120
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n)
    g = pg.PoseGraph(LoopConfig(max_keyframes=128))
    for k in range(n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[0], 0.0, 0.0])))
    g.edges.append(dict(i=0, j=n - 1, t=Ri.T @ (gt_p[n - 1] - gt_p[0]),
                        yaw=gt_yaw[n - 1] - gt_yaw[0], w=2.0, loop=1))
    args = _pgo_arrays(g, 128)
    xyz_d, yaw_d, _ = pg.optimize_4dof(*args, iters=15)
    xyz_p, yaw_p, _ = pg.optimize_4dof_pcg(*args, iters=15, cg_iters=128)
    np.testing.assert_allclose(np.asarray(xyz_p)[:n], np.asarray(xyz_d)[:n], atol=2e-3)
    np.testing.assert_allclose(np.asarray(yaw_p)[:n], np.asarray(yaw_d)[:n], atol=2e-3)


@pytest.mark.slow
def test_pgo_full_capacity_2048():
    """4-DoF PGO at the default 2048-keyframe capacity must close a long
    drifting loop. At this capacity it takes the dense path (268 MB Hessian;
    its GPU time against PCG's sequential matvecs is not measured); the PCG
    path is forced explicitly below to pin the beyond-capacity solver too."""
    n = 2000
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n, yaw_drift_total=0.2,
                                                      pos_drift_total=1.0)
    g = pg.PoseGraph(LoopConfig(max_keyframes=2048))
    for k in range(n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[0], 0.0, 0.0])))
    g.edges.append(dict(i=0, j=n - 1, t=Ri.T @ (gt_p[n - 1] - gt_p[0]),
                        yaw=gt_yaw[n - 1] - gt_yaw[0], w=2.0, loop=1))
    err_before = np.linalg.norm(vio_p[n - 1] - gt_p[n - 1])
    g.optimize(iters=15)
    err_after = np.linalg.norm(g.opt_p[n - 1] - gt_p[n - 1])
    assert err_after < err_before * 0.35, (err_before, err_after)

    # beyond-capacity path: same graph through the matrix-free PCG solver
    import plslam.models.pose_graph as pgm
    old = pgm._PCG_THRESHOLD
    try:
        pgm._PCG_THRESHOLD = 512  # force PCG for this capacity
        g.optimize(iters=15)
        err_pcg = np.linalg.norm(g.opt_p[n - 1] - gt_p[n - 1])
        assert err_pcg < err_before * 0.35, (err_before, err_pcg)
    finally:
        pgm._PCG_THRESHOLD = old


def test_temporal_consistency_rejects_transient_alias():
    """detectLoop temporal consistency (SURVEY.md:144): a place that matches
    for a SINGLE keyframe (perceptual aliasing) produces no candidate; a
    revisit that persists across consecutive keyframe queries does."""
    db = kdb.KeyframeDB(64)

    def gd(place):
        """Place descriptors: distinct places near-orthogonal, NEIGHBORING
        places correlated (consecutive keyframes see overlapping scenery) —
        so a genuine hit also produces the strong second candidate the
        detectLoop relative-threshold check requires."""
        v = np.zeros(kdb.GDESC_DIM, np.float32)
        v[place % kdb.GDESC_DIM] = 1.0
        v[(place + 1) % kdb.GDESC_DIM] = 0.6
        v += 0.05 * np.asarray(np.random.default_rng(place).normal(size=kdb.GDESC_DIM), np.float32)
        return v / np.linalg.norm(v)

    # 30 distinct places
    for s in range(30):
        db.add({}, gd(s))
    # transient alias: ONE query resembling place 3, then a distinct one
    hit = db.query(gd(3), exclude_last=10, consistency=2)
    assert hit is None  # first hit held back by consistency
    miss = db.query(gd(100), exclude_last=10, consistency=2)
    assert miss is None
    # …so a later isolated re-hit is again held back (no stale chain)
    assert db.query(gd(3), exclude_last=10, consistency=2) is None
    # sustained revisit (> consistency_gap away from the alias chain, inside
    # the searchable [0, n−exclude_last) range): consecutive queries hit
    # neighboring places
    assert db.query(gd(18), exclude_last=10, consistency=2) is None  # 1st of chain
    got = db.query(gd(18), exclude_last=10, consistency=2)
    assert got == 18  # 2nd consecutive → accepted
    # consistency=1 keeps the old single-shot behavior
    db2 = kdb.KeyframeDB(64)
    for s in range(30):
        db2.add({}, gd(s))
    assert db2.query(gd(3), exclude_last=10, consistency=1) == 3


def test_capacity_eviction_keeps_closing_loops():
    """Past max_keyframes the graph downsamples old non-loop keyframes
    instead of dropping new ones: keyframes keep being accepted, loop edges
    and the loaded-map base survive, and a post-eviction loop still closes."""
    n_total, cap = 100, 64
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n_total, yaw_drift_total=0.15)
    g = pg.PoseGraph(LoopConfig(max_keyframes=cap))

    def add(k):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)

    for k in range(cap):
        add(k)
    # an early loop edge whose endpoints must survive eviction
    Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[2], 0.0, 0.0])))
    g.edges.append(dict(i=2, j=40, t=Ri.T @ (gt_p[40] - gt_p[2]),
                        yaw=gt_yaw[40] - gt_yaw[2], w=2.0, loop=1))
    t_loop_i, t_loop_j = float(g.t_kf[2]), float(g.t_kf[40])

    for k in range(cap, n_total):
        add(k)  # each insert past capacity triggers eviction
    assert g.n <= cap
    assert g.n > cap // 2  # still holding a meaningful graph
    # loop edge endpoints survived (identified by timestamp)
    loops = [e for e in g.edges if e["loop"]]
    assert len(loops) == 1
    e = loops[0]
    assert g.t_kf[e["i"]] == t_loop_i and g.t_kf[e["j"]] == t_loop_j
    # newest keyframe is the last added
    assert g.t_kf[g.n - 1] == float(n_total - 1)
    # sequential edges remain VIO-pure across eviction gaps
    for e2 in g.edges:
        if e2["loop"]:
            continue
        i, j = e2["i"], e2["j"]
        Ri_v = np.asarray(ypr_to_rot(jnp.asarray([g.vio_yaw[i], 0.0, 0.0])))
        np.testing.assert_allclose(
            e2["t"], Ri_v.T @ (g.vio_p[j] - g.vio_p[i]), atol=1e-9)
    # a fresh GT loop edge on the evicted graph still closes it
    jn = g.n - 1
    kj = int(g.t_kf[jn])
    Ri0 = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[0], 0.0, 0.0])))
    g.edges.append(dict(i=0, j=jn, t=Ri0.T @ (gt_p[kj] - gt_p[0]),
                        yaw=gt_yaw[kj] - gt_yaw[0], w=2.0, loop=1))
    g.optimize(iters=25)
    err = np.linalg.norm(g.opt_p[jn] - gt_p[kj])
    assert err < 0.12, err

def test_pgo_bucketed_capacity_matches_full():
    """`optimize()` sizes the solve to the LIVE graph (node capacity bucketed
    to the next power of two, min 64) — the bucketed system must produce the
    same solution as solving at the configured full capacity, ~20× cheaper
    at n=100/cap=2048 (VERDICT r3 item 6)."""
    n = 100
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n)
    g = pg.PoseGraph(LoopConfig(max_keyframes=2048))
    for k in range(n):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    Ri = np.asarray(ypr_to_rot(jnp.asarray([gt_yaw[0], 0.0, 0.0])))
    g.edges.append(dict(i=0, j=n - 1, t=Ri.T @ (gt_p[n - 1] - gt_p[0]),
                        yaw=gt_yaw[n - 1] - gt_yaw[0], w=2.0, loop=1))
    opt_p0 = g.opt_p.copy()
    opt_yaw0 = g.opt_yaw.copy()
    g.optimize(iters=12)  # bucketed: K = 128 (f32)

    # reference solve at the FULL configured capacity, same dtype
    args = list(_pgo_arrays(g, 2048))
    args[0] = jnp.asarray(np.asarray(opt_p0[:2048], np.float32))
    args[1] = jnp.asarray(np.asarray(opt_yaw0[:2048], np.float32))
    args = [a.astype(jnp.float32) if a.dtype in (jnp.float64,) else a for a in args]
    xyz_f, yaw_f, _ = pg.optimize_4dof(*args, iters=12)
    np.testing.assert_allclose(g.opt_p[:n], np.asarray(xyz_f)[:n], atol=2e-3)
    np.testing.assert_allclose(g.opt_yaw[:n], np.asarray(yaw_f)[:n], atol=2e-3)


def test_capacity_misaligned_db_warns_and_drops():
    """A DB misaligned with the keyframe list (imagery for only some
    keyframes) cannot be evicted safely: at capacity the graph must fall
    back to drop-new LOUDLY (warning + counter), never corrupt indices
    (VERDICT r3 weak #5/#6)."""
    import warnings as _w

    cap = 32
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(cap + 4)
    g = pg.PoseGraph(LoopConfig(max_keyframes=cap))
    for k in range(cap):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)
    # simulate partial imagery: DB holds entries for only a prefix
    g.db.n = 10
    g.db.entries = [{} for _ in range(10)]
    n_before = g.n
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[cap], 0.0, 0.0]))))
        out = g.add_keyframe(float(cap), vio_p[cap], q)
    assert out is None and g.n == n_before
    assert g.evict_fallbacks == 1
    assert any("misaligned" in str(w.message) for w in rec)


def test_eviction_preserves_loaded_map_edges():
    """Capacity eviction must keep loaded-map-INTERNAL sequential edges: the
    rebuild loop only regenerates edges for the live session (i >= base_n),
    and map nodes are not gauge-pinned — dropping their edges would leave
    them unconstrained (ADVICE r3 #3)."""
    n_total, cap, base = 90, 64, 20
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n_total)
    g = pg.PoseGraph(LoopConfig(max_keyframes=cap))

    def add(k):
        q = np.asarray(rot_to_quat(ypr_to_rot(jnp.asarray([vio_yaw[k], 0.0, 0.0]))))
        g.add_keyframe(float(k), vio_p[k], q)

    for k in range(base):
        add(k)
    map_edges = [dict(e) for e in g.edges]  # all internal to [0, base)
    g.base_n = base  # everything so far is "the loaded map"
    for k in range(base, n_total):
        add(k)  # fills past capacity → evictions
    assert g.n <= cap
    kept_map = [e for e in g.edges
                if not e["loop"] and e["i"] < base and e["j"] < base]
    assert len(kept_map) == len(map_edges), (len(kept_map), len(map_edges))
    # map nodes themselves were never evicted
    np.testing.assert_allclose(g.vio_p[:base], vio_p[:base])
    # and the graph still optimizes (no unconstrained blocks blowing up)
    g.edges.append(dict(i=2, j=g.n - 1,
                        t=np.zeros(3), yaw=0.0, w=2.0, loop=1))
    g.optimize(iters=5)
    assert np.isfinite(g.opt_p[: g.n]).all()
