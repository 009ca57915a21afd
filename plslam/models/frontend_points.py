"""Point-feature frontend: Shi-Tomasi detection + pyramidal LK tracking +
fundamental-matrix RANSAC + min-distance NMS.

JAX equivalent of the reference's `feature_tracker/src/feature_tracker.cpp`
(`FeatureTracker::readImage`: CLAHE → `cv::calcOpticalFlowPyrLK` →
`rejectWithF` (`cv::findFundamentalMat` RANSAC) → `setMask` min-dist NMS →
`cv::goodFeaturesToTrack` → `undistortedPoints` — SURVEY.md §2.1 / §3.1).

Re-design notes (data-parallel first, not a port):
  * detection: dense min-eigenvalue (Shi-Tomasi) score over the whole image in
    one fused conv pipeline, then per-grid-cell argmax — the greedy min-dist
    mask of the reference becomes a cell decomposition (cell = min_dist), so
    selection is a fixed-shape argmax instead of a sequential loop.
  * tracking: all features advance together — batched bilinear patch gathers
    + a fixed-count LK iteration per pyramid level (`lax.fori_loop`), no
    per-feature early exit (masks carry convergence state).
  * RANSAC: fixed-K batched 8-point hypothesis scoring (no data-dependent
    iteration count).
All functions are jitted once per image shape.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.utils.device import asdev
from plslam.ops.cameras import PinholeRadTan, lift

LK_WIN = 10  # half window → 21×21 like cv::calcOpticalFlowPyrLK default
# the reference passes maxLevel=3 to cv::calcOpticalFlowPyrLK — that is the
# max pyramid INDEX, i.e. 4 levels; matching it doubles the capture range
# (±4 px margin per level → ~±32 px full-res motion)
LK_LEVELS = 4
LK_ITERS = 10


def auto_levels(shape, cap: int = LK_LEVELS) -> int:
    """Pyramid depth for an image size — like cv::buildOpticalFlowPyramid,
    which shrinks maxLevel until the tracking window fits the coarsest level.
    Our batched window gather needs the search window (30 px) to fit with
    room, so the coarsest level keeps min-dim ≥ 60 px."""
    m = min(shape)
    l = 1
    while l < cap and (m >> l) >= 60:
        l += 1
    return l


# ------------------------------------------------------------------ pyramid
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _band(n: int, stride: int) -> np.ndarray:
    """[ceil(n/stride), n] banded 5-tap blur(+decimate) matrix with
    edge-clamp padding — static per (n, stride), folded at compile time."""
    pad = len(_K5) // 2
    idx = np.arange(0, n, stride)
    B = np.zeros((len(idx), n), np.float32)
    for o, c in enumerate(idx):
        for t, kv in enumerate(_K5):
            B[o, min(max(c + t - pad, 0), n - 1)] += kv
    return B


@partial(jax.jit, static_argnames=("levels",))
def build_pyramid(img, levels: int = LK_LEVELS):
    """Gaussian-ish pyramid: 5-tap binomial blur + 2× decimation, expressed
    as two banded matmuls per level (Bh @ img @ Bw with the decimation folded
    into the bands) instead of 10 shifted-add passes over device memory (its
    GPU time against the shifted adds is not measured). At the default
    precision a GPU runs these float32 matmuls in TF32."""
    pyr = [img]
    cur = img
    h, w = img.shape
    for _ in range(levels - 1):
        Bh = jnp.asarray(_band(h, 2), img.dtype)
        Bw = jnp.asarray(_band(w, 2).T, img.dtype)
        cur = Bh @ cur @ Bw
        h, w = Bh.shape[0], Bw.shape[1]
        pyr.append(cur)
    return pyr


def _sep_conv(img, k):
    pad = len(k) // 2
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    x = sum(x[i : i + img.shape[0], :] * k[i] for i in range(len(k)))
    x = jnp.pad(x, ((0, 0), (pad, pad)), mode="edge")
    x = sum(x[:, i : i + img.shape[1]] * k[i] for i in range(len(k)))
    return x


# ---------------------------------------------------------------- detection
@partial(jax.jit, static_argnames=("cell", "max_out"))
def shi_tomasi_grid(img, occupied_uv, occupied_valid, cell: int, max_out: int):
    """Dense Shi-Tomasi min-eig score → per-cell argmax → top-`max_out` new
    corners avoiding cells occupied by existing features.

    Returns (uv [max_out,2] float, score [max_out]) — caller thresholds score.
    """
    H, W = img.shape
    gx = (jnp.pad(img, ((0, 0), (1, 1)), mode="edge")[:, 2:] -
          jnp.pad(img, ((0, 0), (1, 1)), mode="edge")[:, :-2]) * 0.5
    gy = (jnp.pad(img, ((1, 1), (0, 0)), mode="edge")[2:, :] -
          jnp.pad(img, ((1, 1), (0, 0)), mode="edge")[:-2, :]) * 0.5
    k = jnp.ones(3, img.dtype) / 3.0
    a = _sep_conv(gx * gx, k)
    b = _sep_conv(gx * gy, k)
    c = _sep_conv(gy * gy, k)
    # min eigenvalue of [[a,b],[b,c]]
    tr = 0.5 * (a + c)
    det = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    score = tr - det
    # suppress borders
    bw = 8
    mask = jnp.zeros_like(score).at[bw:-bw, bw:-bw].set(1.0)
    score = score * mask

    # cells
    nch = H // cell
    ncw = W // cell
    sc = score[: nch * cell, : ncw * cell].reshape(nch, cell, ncw, cell).transpose(0, 2, 1, 3)
    sc = sc.reshape(nch * ncw, cell * cell)
    best = jnp.argmax(sc, axis=1)
    best_score = jnp.take_along_axis(sc, best[:, None], axis=1)[:, 0]
    cy = best // cell + (jnp.arange(nch * ncw) // ncw) * cell
    cx = best % cell + (jnp.arange(nch * ncw) % ncw) * cell

    # occupied cells (existing features): zero their score
    occ_cell = (
        jnp.clip(occupied_uv[:, 1].astype(jnp.int32) // cell, 0, nch - 1) * ncw
        + jnp.clip(occupied_uv[:, 0].astype(jnp.int32) // cell, 0, ncw - 1)
    )
    occ = jnp.zeros((nch * ncw,), img.dtype).at[occ_cell].max(occupied_valid)
    best_score = best_score * (1.0 - occ)

    # cross-cell min-dist NMS (the reference's greedy `setMask`, batched):
    # a candidate dies if a strictly better one sits within `cell` pixels
    pts = jnp.stack([cx.astype(img.dtype), cy.astype(img.dtype)], axis=-1)
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    close = d2 < float(cell) ** 2
    sc_j, sc_i = best_score[None, :], best_score[:, None]
    jidx = jnp.arange(best_score.shape[0])
    better = (sc_j > sc_i) | ((sc_j == sc_i) & (jidx[None, :] < jidx[:, None]))
    dead = jnp.any(close & better & (sc_j > 0), axis=1)
    best_score = best_score * (1.0 - dead)

    top = jnp.argsort(-best_score)[:max_out]
    return pts[top], best_score[top]


# ----------------------------------------------------------------- tracking
def _bilinear(img, x, y):
    H, W = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 2)
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    return (
        i00 * (1 - dx) * (1 - dy) + i01 * dx * (1 - dy)
        + i10 * (1 - dx) * dy + i11 * dx * dy
    )


def _patch_coords(dtype):
    r = jnp.arange(-LK_WIN, LK_WIN + 1, dtype=dtype)
    yy, xx = jnp.meshgrid(r, r, indexing="ij")
    return xx.reshape(-1), yy.reshape(-1)


@partial(jax.jit, static_argnames=("levels", "iters"))
def lk_track(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = LK_ITERS):
    """Pyramidal Lucas-Kanade: track pts_prev [N,2] (pixels, level 0) into the
    current frame. Returns (pts_cur [N,2], status [N]).

    Inverse-compositional per level: template gradient from the previous
    frame's patch, fixed `iters` Gauss-Newton updates, all features batched.
    levels=None uses the full supplied pyramid."""
    levels = len(pyr_prev) if levels is None else levels
    dtype = pts_prev.dtype
    xx, yy = _patch_coords(dtype)  # [P]
    n = pts_prev.shape[0]

    def track_level(pts_guess, level):
        scale = 2.0**level
        prev = pyr_prev[level]
        cur = pyr_cur[level]
        p0 = pts_prev / scale  # template centers
        g = pts_guess / scale

        def per_feature(p0_i, g_i):
            px = p0_i[0] + xx
            py = p0_i[1] + yy
            T = _bilinear(prev, px, py)
            Tx = (_bilinear(prev, px + 1.0, py) - _bilinear(prev, px - 1.0, py)) * 0.5
            Ty = (_bilinear(prev, px, py + 1.0) - _bilinear(prev, px, py - 1.0)) * 0.5
            H00 = jnp.sum(Tx * Tx)
            H01 = jnp.sum(Tx * Ty)
            H11 = jnp.sum(Ty * Ty)
            det = H00 * H11 - H01 * H01
            ok = det > 1e-6
            det_safe = jnp.where(ok, det, 1.0)

            def body(_, gi):
                I = _bilinear(cur, gi[0] + xx, gi[1] + yy)
                e = I - T
                b0 = jnp.sum(e * Tx)
                b1 = jnp.sum(e * Ty)
                du = (H11 * b0 - H01 * b1) / det_safe
                dv = (-H01 * b0 + H00 * b1) / det_safe
                return gi - jnp.stack([du, dv])

            g_out = jax.lax.fori_loop(0, iters, body, g_i)
            # residual for convergence check
            I = _bilinear(cur, g_out[0] + xx, g_out[1] + yy)
            err = jnp.mean(jnp.abs(I - T))
            return g_out, ok, err

        g_out, ok, err = jax.vmap(per_feature)(p0, g)
        return g_out * scale, ok, err

    pts = pts_prev
    ok_all = jnp.ones((n,), bool)
    err = jnp.zeros((n,), dtype)
    for level in range(levels - 1, -1, -1):
        pts, ok, err = track_level(pts, level)
        ok_all = ok_all & ok

    H, W = pyr_cur[0].shape
    inb = (
        (pts[:, 0] > LK_WIN) & (pts[:, 0] < W - LK_WIN)
        & (pts[:, 1] > LK_WIN) & (pts[:, 1] < H - LK_WIN)
    )
    status = valid & ok_all & inb & (err < 0.12)
    return pts, status


# ------------------------------------------------------------------- RANSAC
LK_MARGIN = 4  # max integer motion per level inside one window (px)
WIN = 2 * LK_WIN + 1  # full patch size (21)
HALF = LK_WIN


@partial(jax.jit, static_argnames=("levels", "iters"))
def lk_track_fast(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = LK_ITERS):
    """Fully-batched pyramidal LK — the speed-of-light formulation.

    One window gather per feature per level; every GN iteration is then pure
    batched matmuls: bilinear sampling of the patch at a fractional offset is
    expressed as row/col selection matrices (two one-hot matrices blended by
    the fraction), so the iteration loop is [N,21,28]·[N,28,28]·[N,28,21]
    einsums — no gathers, no per-feature programs. Per-level
    motion is bounded by LK_MARGIN (the pyramid absorbs large motion, as in
    cv::calcOpticalFlowPyrLK's window clamping). levels=None uses the full
    supplied pyramid.
    """
    levels = len(pyr_prev) if levels is None else levels
    dtype = pts_prev.dtype
    n = pts_prev.shape[0]
    S_T = WIN + 3  # template window (23×23 patch + 1 slack)
    S_C = WIN + 2 * LK_MARGIN + 1  # current window

    def sel(frac, base_i, out_size, in_size):
        """[N,out,in] bilinear row-selector: rows pick base_i+u with weights
        (1-frac, frac) on the two integer neighbours."""
        u = jnp.arange(out_size)
        idx = base_i[:, None] + u[None, :]  # [N,out]
        e0 = jax.nn.one_hot(idx, in_size, dtype=dtype)
        e1 = jax.nn.one_hot(idx + 1, in_size, dtype=dtype)
        f = frac[:, None, None]
        return (1.0 - f) * e0 + f * e1  # [N,out,in]

    def gather_windows(img, tl, size):
        return jax.vmap(
            lambda c: jax.lax.dynamic_slice(img, (c[1], c[0]), (size, size))
        )(tl)

    guess = pts_prev
    err = jnp.zeros((n,), dtype)
    ok_all = jnp.ones((n,), bool)
    for level in range(levels - 1, -1, -1):
        scale = 2.0**level
        prev = pyr_prev[level]
        cur = pyr_cur[level]
        H, W = prev.shape
        p0 = pts_prev / scale
        g = guess / scale

        # --- template: 23×23 patch (+1 ring) at fixed fractional offset ---
        t_f = p0 - (HALF + 1)
        t_i = jnp.floor(t_f)
        t_frac = t_f - t_i
        tl_t = jnp.clip(t_i.astype(jnp.int32), 0, jnp.asarray([W - S_T, H - S_T]))
        # border features get a clipped (shifted) template and die via the
        # residual gate — same behaviour as the per-feature kernel
        slack_t = jnp.clip(t_i.astype(jnp.int32) - tl_t, 0, S_T - WIN - 3)
        Wt = gather_windows(prev, tl_t, S_T)  # [N,24,24]
        Rt = sel(t_frac[:, 1], slack_t[:, 1], WIN + 2, S_T)
        Ct = sel(t_frac[:, 0], slack_t[:, 0], WIN + 2, S_T)
        T23 = jnp.einsum("nab,nbc,ndc->nad", Rt, Wt, Ct)  # [N,23,23]
        T = T23[:, 1 : WIN + 1, 1 : WIN + 1]
        Tx = 0.5 * (T23[:, 1 : WIN + 1, 2 : WIN + 2] - T23[:, 1 : WIN + 1, 0:WIN])
        Ty = 0.5 * (T23[:, 2 : WIN + 2, 1 : WIN + 1] - T23[:, 0:WIN, 1 : WIN + 1])
        H00 = jnp.sum(Tx * Tx, axis=(1, 2))
        H01 = jnp.sum(Tx * Ty, axis=(1, 2))
        H11 = jnp.sum(Ty * Ty, axis=(1, 2))
        det = H00 * H11 - H01 * H01
        ok = det > 1e-6
        det_safe = jnp.where(ok, det, 1.0)

        # --- current window centred on the initial guess for this level ---
        c_tl = jnp.floor(g - HALF).astype(jnp.int32) - LK_MARGIN
        c_tl = jnp.clip(c_tl, 0, jnp.asarray([W - S_C, H - S_C]))
        Wc = gather_windows(cur, c_tl, S_C)  # [N,S_C,S_C]
        lo = c_tl.astype(dtype) + HALF  # guess bounds within the window
        hi = c_tl.astype(dtype) + S_C - 1 - HALF - 1

        def body(_, gi):
            gc = jnp.clip(gi, lo, hi)
            a = gc - HALF - c_tl.astype(dtype)  # patch top-left inside window
            ia = jnp.floor(a).astype(jnp.int32)
            fa = a - ia.astype(dtype)
            Rc = sel(fa[:, 1], ia[:, 1], WIN, S_C)
            Cc = sel(fa[:, 0], ia[:, 0], WIN, S_C)
            I = jnp.einsum("nab,nbc,ndc->nad", Rc, Wc, Cc)
            e = I - T
            b0 = jnp.sum(e * Tx, axis=(1, 2))
            b1 = jnp.sum(e * Ty, axis=(1, 2))
            du = (H11 * b0 - H01 * b1) / det_safe
            dv = (-H01 * b0 + H00 * b1) / det_safe
            return gc - jnp.stack([du, dv], axis=-1)

        g = jax.lax.fori_loop(0, iters, body, g)
        g = jnp.clip(g, lo, hi)

        # final residual
        a = g - HALF - c_tl.astype(dtype)
        ia = jnp.floor(a).astype(jnp.int32)
        fa = a - ia.astype(dtype)
        Rc = sel(fa[:, 1], ia[:, 1], WIN, S_C)
        Cc = sel(fa[:, 0], ia[:, 0], WIN, S_C)
        I = jnp.einsum("nab,nbc,ndc->nad", Rc, Wc, Cc)
        err = jnp.mean(jnp.abs(I - T), axis=(1, 2))
        ok_all = ok_all & ok
        guess = g * scale

    H0, W0 = pyr_cur[0].shape
    inb = (
        (guess[:, 0] > HALF) & (guess[:, 0] < W0 - HALF)
        & (guess[:, 1] > HALF) & (guess[:, 1] < H0 - HALF)
    )
    status = valid & ok_all & inb & (err < 0.12)
    return guess, status


@partial(jax.jit, static_argnames=("iters",))
def fundamental_ransac(p1, p2, valid, thresh, iters: int = 100, key=None):
    """Batched 8-point fundamental-matrix RANSAC (`rejectWithF`).

    p1,p2: [N,2] *normalized* coordinates. Returns inlier mask [N]."""
    n = p1.shape[0]
    dtype = p1.dtype
    key = key if key is not None else jax.random.PRNGKey(0)
    # sample 8 DISTINCT valid slots per hypothesis via Gumbel top-k (uniform
    # without replacement over the valid set — no duplicate rows, no low-slot
    # bias). With <8 valid slots the extra picks are invalid → degenerate
    # hypothesis → NaN F → zero inliers, same as a degenerate SVD sample.
    gumbel = jax.random.gumbel(key, (iters, n), dtype)
    score = jnp.where(valid[None, :], gumbel, -jnp.inf)
    # exact top_k (a sort): approx_max_k's binned sampling coincided with an
    # initialization failure on the noisy fps dataset on an accelerator (CPU
    # falls back to exact and initialized fine) — robustness of the RANSAC
    # draw wins over speed
    _, samples = jax.lax.top_k(score, 8)  # [iters,8]

    x1 = jnp.concatenate([p1, jnp.ones((n, 1), dtype)], axis=1)
    x2 = jnp.concatenate([p2, jnp.ones((n, 1), dtype)], axis=1)

    def build_A(sample):
        a1 = x1[sample]
        a2 = x2[sample]
        return jnp.stack(
            [a2[:, 0] * a1[:, 0], a2[:, 0] * a1[:, 1], a2[:, 0],
             a2[:, 1] * a1[:, 0], a2[:, 1] * a1[:, 1], a2[:, 1],
             a1[:, 0], a1[:, 1], jnp.ones(8, dtype)], axis=1)

    A = jax.vmap(build_A)(samples)  # [iters,8,9]
    # null vector of each A via inverse iteration on AᵀA + εI: the nullspace
    # eigenvalue is ~0 vs O(1) others, so 3 solves against one Cholesky
    # factorisation converge it — a batched [iters,9,9] chol + triangular
    # solves instead of the batched SVD.
    # Degenerate samples → NaN F → infinite sampson distance → hypothesis
    # scores zero inliers and loses, matching the SVD path's behavior.
    AtA = jnp.einsum("kij,kil->kjl", A, A)
    eps = 1e-8 * jnp.trace(AtA, axis1=1, axis2=2)[:, None]
    L = jnp.linalg.cholesky(AtA + eps[..., None] * jnp.eye(9, dtype=dtype))
    v = jnp.ones((A.shape[0], 9, 1), dtype)
    for _ in range(3):
        v = jax.scipy.linalg.cho_solve((L, True), v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=1, keepdims=True), 1e-30)
    Fs = v.reshape(-1, 3, 3)  # [iters,3,3]

    def sampson(F):
        Fx1 = x1 @ F.T
        Ftx2 = x2 @ F
        num = jnp.sum(x2 * Fx1, axis=1) ** 2
        den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
        return num / jnp.maximum(den, 1e-12)

    d = jax.vmap(sampson)(Fs)  # [iters,N]
    inl = (d < thresh * thresh) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return inl[best] & valid


# ------------------------------------------------------------------- driver
class FrontendPoints:
    """Host orchestration (`FeatureTracker` class equivalent).

    The ENTIRE per-frame tick — pyramid, LK, rejectWithF RANSAC, detection,
    slot refill, feature-id assignment, track counts, per-feature velocity —
    runs as ONE jitted device program carrying device-resident slot state.
    Nothing is read back on tracked-only frames; a published frame pulls ONE
    packed bundle: one dispatch and at most one readback per frame."""

    def __init__(self, cam: PinholeRadTan, max_cnt=150, min_dist=30, f_thresh_px=1.0,
                 focal=460.0, dtype=jnp.float32,
                 min_score=1e-4, fisheye: bool = False, fisheye_mask=None):
        self.cam = cam
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.f_thresh = f_thresh_px / focal
        self.dtype = dtype
        self.min_score = min_score  # detection quality gate (goodFeaturesToTrack qualityLevel)
        # fisheye FOV mask (`fisheye_mask.jpg` in the reference): either an
        # explicit [H,W] 0/1 mask image or the standard centered circle
        self.fisheye = fisheye or fisheye_mask is not None
        self._mask_img = (jnp.asarray(np.asarray(fisheye_mask) > 0.5, dtype)
                          if fisheye_mask is not None else None)
        self.prev_pyr = None
        self._state = None  # device: (uv, valid, norm, ids, track_cnt, next_id)
        self.prev_t = None
        self._key = jax.random.PRNGKey(7)
        self._frame_i = 0
        # host mirrors of the last PULLED frame (viz / debugging only)
        self.prev_valid = np.zeros(max_cnt, bool)
        self.track_cnt = np.zeros(max_cnt, np.int64)

    def reset(self):
        """Restart the tracker from scratch (the reference's restart handshake
        on an input timestamp discontinuity): drop the device-resident
        pyramid + slot/id state so no cross-gap track survives — the next
        `process` call re-detects like the very first frame."""
        self.prev_pyr = None
        self._state = None
        self.prev_t = None
        self.prev_valid = np.zeros(self.max_cnt, bool)
        self.track_cnt = np.zeros(self.max_cnt, np.int64)

    # ------------------------------------------------------------- programs
    def _programs(self):
        return _pt_programs(self.min_dist, self.max_cnt,
                            self.fisheye, self._mask_img is not None, self.dtype)

    # --------------------------------------------------------------- ticking
    def process(self, img, t: float, want_output: bool = True,
                light: bool = False):
        """One frame tick (`FeatureTracker::readImage`).

        want_output=True pulls ONE packed bundle and returns
        (ids, normalized pts, velocities, pixel uv) of valid features;
        want_output=False keeps everything on device and returns None (the
        FREQ-control non-published frames — SURVEY.md §2.1).
        light=True (tracked-only frames) runs the pyramid+LK-only tick —
        no RANSAC / detection / refill, the reference's non-PUB_THIS_FRAME
        work split. `img` may be a host array or an already-uploaded device
        array."""
        prog, det_prog, _, _, light_prog = self._programs()
        # host images upload as uint8 (4× less H2D — see to_u8);
        # already-on-device arrays (e.g. a shared pyramid level) pass through
        img_j = img if isinstance(img, jax.Array) else jnp.asarray(to_u8(img))
        if self.prev_pyr is None:
            mask_arg = (self._mask_img if self._mask_img is not None
                        else jnp.zeros((1, 1), self.dtype))
            self.prev_pyr, self._state, bundle = det_prog(
                self.cam, img_j, jnp.asarray(self.min_score, self.dtype), mask_arg)
        elif light and not want_output:
            mask_arg = (self._mask_img if self._mask_img is not None
                        else jnp.zeros((1, 1), self.dtype))
            self.prev_pyr, self._state = light_prog(
                self.cam, self.prev_pyr, img_j, self._state, mask_arg)
            self._frame_i += 1
            self.prev_t = t
            return None
        else:
            key = jax.random.fold_in(self._key, self._frame_i)
            dt = (t - self.prev_t) if self.prev_t is not None else 0.0
            mask_arg = (self._mask_img if self._mask_img is not None
                        else jnp.zeros((1, 1), self.dtype))
            self.prev_pyr, self._state, bundle = prog(
                self.cam, self.prev_pyr, img_j, self._state,
                jnp.asarray(self.f_thresh, self.dtype), key,
                jnp.asarray(dt, self.dtype), jnp.asarray(self.min_score, self.dtype),
                mask_arg)
        self._frame_i += 1
        self.prev_t = t
        if not want_output:
            return None

        def unpack(parts):
            b, ids_i = parts
            uv = b[:, 0:2].astype(np.float64)
            norm = b[:, 2:4].astype(np.float64)
            vel = b[:, 4:6].astype(np.float64)
            valid = b[:, 6] > 0
            ids = ids_i.astype(np.int64)
            self.prev_valid = valid
            self.track_cnt = b[:, 7].astype(np.int64)
            return ids[valid], norm[valid], vel[valid], uv[valid]

        h = OutputHandle(bundle, unpack)
        return h if want_output == "defer" else h.get()


from functools import lru_cache  # noqa: E402


def to_u8(img):
    """Quantize a float [0,1] grayscale image to uint8 for the H2D upload.

    EuRoC source PNGs are 8-bit and the reference's cv::CLAHE emits CV_8U,
    so shipping uint8 and casting on device loses nothing (≤1/510
    quantization on the equalized image) and cuts the upload 4× (a 16-frame
    burst chunk is 5.8 MB instead of 23 MB). `dev_image` is the device-side
    inverse."""
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def dev_image(img, dtype):
    """Device-side cast for `to_u8` uploads (trace-time no-op for floats)."""
    if img.dtype == jnp.uint8:
        return img.astype(dtype) * jnp.asarray(1.0 / 255.0, dtype)
    return img.astype(dtype) if img.dtype != dtype else img


@lru_cache(maxsize=None)
def _pt_programs(cell: int, N: int, fisheye: bool, mask_img: bool, dtype):
    """Build the fused per-frame programs ONCE per static config (module
    -level cache: per-instance closures would recompile for every new
    FrontendPoints — seconds per compile). The camera is a dynamic pytree
    argument, so intrinsics never trigger a retrace. The whole tick is one
    dispatch and at most one pull."""

    def in_fov(uv, shape, mask):
        if mask_img:  # explicit fisheye_mask image: nonzero = usable FOV
            h, w = mask.shape
            xi = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1)
            yi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1)
            return mask[yi, xi] > 0.5
        h, w = shape
        r = 0.5 * min(h, w) - 3.0
        d2 = (uv[:, 0] - w / 2.0) ** 2 + (uv[:, 1] - h / 2.0) ** 2
        return d2 <= r * r

    def pack(uv, norm, vel, valid, ids, track_cnt):
        # ids stay a SEPARATE int32 array: bitcasting them into f32 lanes
        # makes small ids denormal floats, and a device op on the bundle
        # (e.g. the joint-pull concat) may flush denormals to zero
        bundle_f = jnp.concatenate([
            uv, norm, vel, valid.astype(dtype)[:, None],
            track_cnt.astype(dtype)[:, None],
        ], axis=1)  # [N,8]
        return bundle_f, ids

    def tick(cam, pyr_prev, img_new, state, f_thresh, key, dt, min_score, fov_mask):
        """Un-jitted tick body — also composed into larger programs (the
        offline burst scan in models/burst.py chains it frame-to-frame)."""
        img_new = dev_image(img_new, dtype)
        uv0, valid0, norm0, ids0, cnt0, next_id = state
        pyr_new = build_pyramid(img_new, levels=len(pyr_prev))
        track_uv, status = lk_track_fast(pyr_prev, pyr_new, uv0, valid0)
        ok = status & valid0
        if fisheye:
            ok = ok & in_fov(track_uv, img_new.shape, fov_mask)
        norm_t = lift(cam, track_uv)
        inl = fundamental_ransac(norm0, norm_t, ok, f_thresh, key=key)
        ok = jnp.where(jnp.sum(ok) >= 8, ok & inl, ok)  # host path skipped <8
        det_uv, det_sc = shi_tomasi_grid(pyr_new[0], track_uv, ok.astype(dtype),
                                         cell=cell, max_out=N)
        det_norm = lift(cam, det_uv)
        det_good = det_sc > min_score
        if fisheye:
            det_good = det_good & in_fov(det_uv, img_new.shape, fov_mask)
        # refill: free slot of rank r takes candidate r. New ids are
        # assigned by FILL rank (not free rank): the FOV/mask gate can punch
        # holes in det_good, so free-rank ids would skip values while next1
        # advances by sum(fill) — the skipped id would later be REASSIGNED
        # to a different physical feature, collapsing two tracks into one.
        fr = jnp.cumsum(~ok) - 1  # free rank per slot
        ci = jnp.clip(fr, 0, N - 1)
        fill = (~ok) & det_good[ci]
        valid1 = ok | fill
        uv1 = jnp.where(fill[:, None], det_uv[ci], track_uv)
        norm1 = jnp.where(fill[:, None], det_norm[ci], norm_t)
        ids1 = jnp.where(ok, ids0,
                         jnp.where(fill,
                                   next_id + (jnp.cumsum(fill) - 1).astype(jnp.int32),
                                   -1))
        cnt1 = jnp.where(ok, cnt0 + 1, jnp.where(fill, 1, 0))
        next1 = next_id + jnp.sum(fill).astype(jnp.int32)
        # per-feature normalized velocity (`undistortedPoints`): only for
        # slots genuinely TRACKED from the previous frame
        vel = jnp.where((ok & (dt > 0))[:, None], (norm_t - norm0) / jnp.maximum(dt, 1e-6), 0.0)
        bundle = pack(uv1, norm1, vel, valid1, ids1, cnt1)
        return tuple(pyr_new), (uv1, valid1, norm1, ids1, cnt1, next1), bundle

    def tick_light(cam, pyr_prev, img_new, state, fov_mask):
        """Tracked-only (non-published) frame: pyramid + LK + track upkeep.

        The reference's FeatureTracker runs rejectWithF and
        goodFeaturesToTrack only when PUB_THIS_FRAME (FREQ control); the
        in-between frames just continue existing tracks. Skipping RANSAC +
        detection + refill here matches that per-frame work split (outliers
        survive at most one extra frame — the publish frame's RANSAC still
        gates what the estimator sees)."""
        img_new = dev_image(img_new, dtype)
        uv0, valid0, norm0, ids0, cnt0, next_id = state
        pyr_new = build_pyramid(img_new, levels=len(pyr_prev))
        track_uv, status = lk_track_fast(pyr_prev, pyr_new, uv0, valid0)
        ok = status & valid0
        if fisheye:
            ok = ok & in_fov(track_uv, img_new.shape, fov_mask)
        norm_t = lift(cam, track_uv)
        cnt1 = jnp.where(ok, cnt0 + 1, 0)
        ids1 = jnp.where(ok, ids0, -1)
        return tuple(pyr_new), (track_uv, ok, norm_t, ids1, cnt1, next_id)

    prog = jax.jit(tick)
    light_prog = jax.jit(tick_light)

    @jax.jit
    def det_prog(cam, img, min_score, fov_mask):
        img = dev_image(img, dtype)
        pyr = build_pyramid(img, levels=auto_levels(img.shape))
        det_uv, det_sc = shi_tomasi_grid(
            pyr[0], jnp.zeros((1, 2), dtype), jnp.zeros((1,), dtype),
            cell=cell, max_out=N)
        det_norm = lift(cam, det_uv)
        good = det_sc > min_score
        if fisheye:
            good = good & in_fov(det_uv, img.shape, fov_mask)
        ids = jnp.where(good, jnp.cumsum(good) - 1, -1).astype(jnp.int32)
        cnt = good.astype(jnp.int32)
        next_id = jnp.sum(good).astype(jnp.int32)
        state = (det_uv, good, det_norm, ids, cnt, next_id)
        bundle = pack(det_uv, det_norm, jnp.zeros_like(det_uv), good, ids, cnt)
        return tuple(pyr), state, bundle

    return prog, det_prog, tick, tick_light, light_prog


class OutputHandle:
    """Deferred readback of frontend bundles (a tuple of device arrays, one
    per dtype — ids stay int32): the host copies start immediately (async);
    .get() materializes them — pulling multiple handles back-to-back
    overlaps their device round trips, and `get_joint` concatenates all
    bundles per dtype on device so N handles cost one round trip per dtype
    (the concats are SAME-DTYPE only: routing int32 ids through f32 lanes
    can flush denormal bit patterns to zero on an accelerator)."""

    def __init__(self, bundles, unpack):
        if not isinstance(bundles, tuple):
            bundles = (bundles,)
        for b in bundles:
            try:
                b.copy_to_host_async()
            except Exception:
                pass
        self._bundles = bundles
        self._unpack = unpack
        self._out = None

    def _finish(self, parts):
        self._out = self._unpack(parts if len(parts) > 1 else parts[0])
        self._bundles = None
        self._unpack = None
        return self._out

    def get(self):
        if self._unpack is not None:
            return self._finish(tuple(np.array(b) for b in self._bundles))
        return self._out

    @staticmethod
    def get_joint(*handles):
        """Materialize several handles with one round trip per dtype group."""
        pend = [h for h in handles if h._unpack is not None]
        items = [(h, i, b) for h in pend for i, b in enumerate(h._bundles)]
        if len(items) >= 2:
            groups = {}
            for key, (h, i, b) in enumerate(items):
                groups.setdefault(str(b.dtype), []).append((h, i, b))
            flats = {}
            cats = {dt: _cat_jit(tuple(b for _, _, b in g)) for dt, g in groups.items()}
            for c in cats.values():
                try:
                    c.copy_to_host_async()
                except Exception:
                    pass
            for dt, c in cats.items():
                flats[dt] = np.array(c)
            parts = {id(h): [None] * len(h._bundles) for h in pend}
            for dt, g in groups.items():
                off = 0
                for h, i, b in g:
                    n = int(np.prod(b.shape))
                    parts[id(h)][i] = flats[dt][off: off + n].reshape(b.shape)
                    off += n
            for h in pend:
                h._finish(tuple(parts[id(h)]))
        return tuple(h.get() for h in handles)


@jax.jit
def _cat_jit(bundles: tuple):
    return jnp.concatenate([b.reshape(-1) for b in bundles])
