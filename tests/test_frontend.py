"""Frontend tests on rendered synthetic images: LK tracking accuracy,
Shi-Tomasi detection, RANSAC gating, line detection + LBD matching."""
import jax.numpy as jnp
import numpy as np
import pytest

from plslam.models import frontend_points as fp
from plslam.models import frontend_lines as fl
from plslam.ops.cameras import PinholeRadTan


def smooth_texture(rng, h=240, w=320, sigma=3):
    img = rng.standard_normal((h, w))
    k = np.exp(-0.5 * (np.arange(-7, 8) / sigma) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def shift_image(img, dx, dy):
    """Bilinear shift: output(x,y) = img(x - dx, y - dy)."""
    h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    sx = np.clip(xs - dx, 0, w - 1.001)
    sy = np.clip(ys - dy, 0, h - 1.001)
    x0 = sx.astype(int)
    y0 = sy.astype(int)
    fx = sx - x0
    fy = sy - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy
    ).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def test_shi_tomasi_detects_in_free_cells(rng):
    img = smooth_texture(rng)
    uv, score = fp.shi_tomasi_grid(
        jnp.asarray(img), jnp.zeros((1, 2), jnp.float32), jnp.zeros((1,), jnp.float32),
        cell=24, max_out=60,
    )
    uv = np.asarray(uv)
    score = np.asarray(score)
    assert (score[:30] > 0).all()
    # min-dist NMS: no two kept corners within the cell radius
    d = np.linalg.norm(uv[:30, None] - uv[None, :30], axis=-1)
    np.fill_diagonal(d, 1e9)
    assert d.min() >= 24.0, d.min()


def test_lk_tracks_known_shift(rng):
    img1 = smooth_texture(rng)
    dx, dy = 3.7, -2.3
    img2 = shift_image(img1, dx, dy)
    pyr1 = fp.build_pyramid(jnp.asarray(img1), levels=fp.auto_levels(img1.shape))
    pyr2 = fp.build_pyramid(jnp.asarray(img2), levels=fp.auto_levels(img2.shape))
    uv, score = fp.shi_tomasi_grid(
        jnp.asarray(img1), jnp.zeros((1, 2), jnp.float32), jnp.zeros((1,), jnp.float32),
        cell=24, max_out=40,
    )
    uv = np.asarray(uv)[np.asarray(score) > 1e-5][:30]
    # keep away from borders so the shifted patch exists
    keep = (uv[:, 0] > 25) & (uv[:, 0] < 295) & (uv[:, 1] > 25) & (uv[:, 1] < 215)
    uv = uv[keep]
    out, status = fp.lk_track(pyr1, pyr2, jnp.asarray(uv, jnp.float32), jnp.ones(len(uv), bool))
    out = np.asarray(out)
    status = np.asarray(status)
    assert status.sum() >= len(uv) * 0.8
    flow = out[status] - uv[status]
    err = np.linalg.norm(flow - np.array([dx, dy]), axis=1)
    assert np.median(err) < 0.25, np.median(err)


def test_fundamental_ransac_rejects_outliers(rng):
    n = 60
    pts = rng.uniform(-1, 1, (n, 3)) * [2, 2, 1] + [0, 0, 6]
    R = np.eye(3)
    t = np.array([0.3, 0.05, 0.0])
    p1 = (pts[:, :2] / pts[:, 2:3]).astype(np.float64)
    pc2 = pts @ R.T + t
    p2 = (pc2[:, :2] / pc2[:, 2:3]).astype(np.float64)
    bad = rng.choice(n, 10, replace=False)
    p2[bad] += rng.uniform(0.05, 0.1, (10, 2)) * rng.choice([-1, 1], (10, 2))
    import jax

    inl = fp.fundamental_ransac(
        jnp.asarray(p1, jnp.float64), jnp.asarray(p2, jnp.float64),
        jnp.ones(n, bool), 2.0 / 460.0, key=jax.random.PRNGKey(1),
    )
    inl = np.asarray(inl)
    assert inl[bad].sum() <= 3, inl[bad].sum()
    good = np.setdiff1d(np.arange(n), bad)
    assert inl[good].sum() > len(good) * 0.8


def draw_lines(segs, h=240, w=320):
    img = np.full((h, w), 0.25, np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    for (x0, y0, x1, y1) in segs:
        d = np.array([x1 - x0, y1 - y0])
        L = np.linalg.norm(d)
        u = d / L
        px = xs - x0
        py = ys - y0
        tproj = px * u[0] + py * u[1]
        dperp = np.abs(-px * u[1] + py * u[0])
        on = (tproj > 0) & (tproj < L) & (dperp < 1.2)
        img[on] = 0.9
    return img


def test_line_detection(rng):
    segs_gt = [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150)]
    img = draw_lines(segs_gt)
    img += rng.standard_normal(img.shape).astype(np.float32) * 0.01
    mag, ang, edge = fl.edge_map(jnp.asarray(img))
    segs, score, valid = fl.detect_segments(mag, ang, edge, *img.shape, max_out=32)
    segs = np.asarray(segs)[np.asarray(valid)]
    assert len(segs) >= 3
    # each GT line matched by some detection (angle + midpoint distance)
    for (x0, y0, x1, y1) in segs_gt:
        mid_gt = np.array([(x0 + x1) / 2, (y0 + y1) / 2])
        ang_gt = np.arctan2(y1 - y0, x1 - x0) % np.pi
        mids = 0.5 * (segs[:, 0:2] + segs[:, 2:4])
        angs = np.arctan2(segs[:, 3] - segs[:, 1], segs[:, 2] - segs[:, 0]) % np.pi
        d_ang = np.abs((angs - ang_gt + np.pi / 2) % np.pi - np.pi / 2)
        # midpoint distance along the normal only (detections may be split)
        n = np.array([-np.sin(ang_gt), np.cos(ang_gt)])
        d_perp = np.abs((mids - mid_gt) @ n)
        assert np.any((d_ang < 0.1) & (d_perp < 5.0)), (x0, y0, x1, y1)


def test_line_tracking_across_shift(rng):
    segs_gt = [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150)]
    img1 = draw_lines(segs_gt) + rng.standard_normal((240, 320)).astype(np.float32) * 0.01
    img2 = shift_image(img1, 4.0, 2.0)
    cam = PinholeRadTan.create(300.0, 300.0, 160.0, 120.0)
    fe = fl.FrontendLines(cam, max_lines=32)
    ids1, s1 = fe.process(img1, 0.0)
    ids2, s2 = fe.process(img2, 0.05)
    common = np.intersect1d(ids1, ids2)
    assert len(common) >= 2, (ids1, ids2)


def test_line_tracking_binary_matches_float(rng):
    """Binary LBD (256-bit packed Hamming — the reference's
    BinaryDescriptorMatcher path) tracks the same lines across a shift as the
    float-cosine path, and the two matchers agree on the matched pairs."""
    segs_gt = [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150)]
    img1 = draw_lines(segs_gt) + rng.standard_normal((240, 320)).astype(np.float32) * 0.01
    img2 = shift_image(img1, 4.0, 2.0)
    cam = PinholeRadTan.create(300.0, 300.0, 160.0, 120.0)
    fe_f = fl.FrontendLines(cam, max_lines=32)
    fe_b = fl.FrontendLines(cam, max_lines=32, binary_desc=True)
    idsf1, _ = fe_f.process(img1, 0.0)
    idsb1, _ = fe_b.process(img1, 0.0)
    idsf2, _ = fe_f.process(img2, 0.05)
    idsb2, _ = fe_b.process(img2, 0.05)
    common_b = np.intersect1d(idsb1, idsb2)
    common_f = np.intersect1d(idsf1, idsf2)
    assert len(common_b) >= 2, (idsb1, idsb2)
    # binary is a lossy compression of the 72-d float LBD (≤72 independent
    # bits): it must track most of what float-cosine tracks, not all of it
    assert len(common_b) >= max(2, len(common_f) // 2), (common_b, common_f)


def test_binarize_lbd_hamming_discriminative(rng):
    """Binarized LBD: same segment on a shifted image → small Hamming
    distance; different segments → large."""
    segs_gt = [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150)]
    img1 = draw_lines(segs_gt) + rng.standard_normal((240, 320)).astype(np.float32) * 0.01
    img2 = shift_image(img1, 3.0, 1.0)
    segs = jnp.asarray(np.asarray(segs_gt, np.float32))
    segs_sh = segs + jnp.asarray([3.0, 1.0, 3.0, 1.0], jnp.float32)  # content moves +(dx,dy)
    v = jnp.ones((len(segs_gt),), jnp.float32)
    gx1, gy1 = fl._scharr(jnp.asarray(img1))
    gx2, gy2 = fl._scharr(jnp.asarray(img2))
    d1 = fl.binarize_lbd(fl.lbd_descriptors(gx1, gy1, segs, v))
    d2 = fl.binarize_lbd(fl.lbd_descriptors(gx2, gy2, segs_sh, v))
    dist = np.asarray(fl._hamming_dist(jnp.asarray(d1), jnp.asarray(d2)))
    assert (np.diag(dist) < 45).all(), dist
    off = dist[~np.eye(len(segs_gt), dtype=bool)]
    assert off.min() > 70, dist


def test_fisheye_mask_image(rng):
    """Explicit fisheye_mask image (the reference's fisheye_mask.jpg):
    features must only live where the mask is nonzero."""
    img1 = smooth_texture(rng, 240, 320)
    img2 = shift_image(img1, 2.0, 1.0)
    mask = np.zeros((240, 320), np.float32)
    mask[:, 160:] = 1.0  # right half usable
    cam = PinholeRadTan.create(300.0, 300.0, 160.0, 120.0)
    fe = fp.FrontendPoints(cam, max_cnt=64, min_dist=16, fisheye_mask=mask)
    ids1, pts1, vel1, uv1 = fe.process(img1, 0.0)
    ids2, pts2, vel2, uv2 = fe.process(img2, 0.05)
    assert len(uv1) > 5 and len(uv2) > 5
    assert (uv1[:, 0] >= 159.5).all(), uv1[:, 0].min()
    assert (uv2[:, 0] >= 159.5).all(), uv2[:, 0].min()
    # circle fallback still works
    fe2 = fp.FrontendPoints(cam, max_cnt=64, min_dist=16, fisheye=True)
    _, _, _, uvc = fe2.process(img1, 0.0)
    r = np.hypot(uvc[:, 0] - 160.0, uvc[:, 1] - 120.0)
    assert (r <= 0.5 * 240 - 2.5).all()


def test_frontend_reset_kills_cross_gap_tracks(rng):
    """Restart handshake: after `reset()` (timestamp-jump restart) no track
    may survive the gap — every feature re-detects with track_cnt 1 and
    fresh ids (the reference restarted the whole tracker node)."""
    from plslam.models.frontend_points import FrontendPoints as FPDriver

    img = smooth_texture(rng)
    cam = PinholeRadTan.create(200.0, 200.0, 160.0, 120.0)
    drv = FPDriver(cam, max_cnt=48, min_dist=24, min_score=1e-4)
    drv.process(np.asarray(img), 0.0, want_output=False)
    drv.process(np.asarray(img), 0.05)
    # most features carried over (detector/RANSAC churn may refill a few)
    assert (drv.track_cnt[drv.prev_valid] >= 2).sum() > 10
    drv.reset()
    assert drv.prev_pyr is None and drv._state is None
    ids2, _, _, uv2 = drv.process(np.asarray(img), 9.0)
    # re-detected from scratch: every track restarts at count 1
    assert (drv.track_cnt[drv.prev_valid] == 1).all()
    assert len(ids2) > 10
