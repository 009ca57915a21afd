"""Keyframe database: FAST-like corners + BRIEF descriptors, global place
-recognition descriptor, descriptor matching, and PnP-RANSAC geometric check.

JAX equivalent of the reference's `pose_graph/src/keyframe.cpp`
(`KeyFrame::computeBRIEFPoint`, `searchByBRIEFDes` Hamming<80,
`PnPRANSAC`, `findConnection`) and the vendored DBoW2 stack
(`BriefVocabulary/BriefDatabase` TF-IDF inverted index) — SURVEY.md §2.4.

Design deviation (documented, SURVEY.md §7 stage 4): DBoW2's 40 MB BRIEF
vocabulary + inverted index is replaced by a train-free global descriptor —
the mean of sign-random-projected local BRIEF descriptors, L2-normalised —
searched exhaustively on-device (one [K,D]·[D] matvec per query over ≤K
keyframes; at K≤2048 this is a small matvec and needs no vocabulary
file). Local BRIEF matching + PnP RANSAC gating mirror the reference's
thresholds.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.models.frontend_points import _bilinear, build_pyramid, shi_tomasi_grid

N_BRIEF_BITS = 256
N_BRIEF_WORDS = N_BRIEF_BITS // 32
GDESC_DIM = 128
MAX_KP = 256


def _brief_pattern(dtype=np.float32, seed=11, radius=15.0):
    """Fixed random BRIEF test pattern (the reference shipped
    `brief_pattern.yml`; ours is generated from a fixed seed)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, radius / 2.5, (N_BRIEF_BITS, 2)).clip(-radius, radius)
    b = rng.normal(0, radius / 2.5, (N_BRIEF_BITS, 2)).clip(-radius, radius)
    return a.astype(dtype), b.astype(dtype)


_PAT_A, _PAT_B = _brief_pattern()
_PROJ = np.random.default_rng(23).choice([-1.0, 1.0], (N_BRIEF_BITS, GDESC_DIM)).astype(np.float32)


@jax.jit
def brief_descriptors(img, uv, valid):
    """Packed 256-bit BRIEF per keypoint → [N, 8] uint32 (+ bit matrix).

    The image is pre-blurred (two 5-tap binomial passes ≈ Gaussian σ≈1.5, the
    cv::BRIEF convention) so single-pixel localization noise between the query
    keypoint and the database corner doesn't flip test bits."""
    from plslam.models.frontend_points import _sep_conv

    k5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], img.dtype) / 16.0
    img = _sep_conv(_sep_conv(img, k5), k5)
    pa = jnp.asarray(_PAT_A)
    pb = jnp.asarray(_PAT_B)

    def one(p):
        ax = p[0] + pa[:, 0]
        ay = p[1] + pa[:, 1]
        bx = p[0] + pb[:, 0]
        by = p[1] + pb[:, 1]
        va = _bilinear(img, ax, ay)
        vb = _bilinear(img, bx, by)
        return (va < vb)

    bits = jax.vmap(one)(uv)  # [N,256] bool
    bits = bits & (valid[:, None] > 0)
    words = bits.reshape(-1, N_BRIEF_WORDS, 32)
    packed = jnp.sum(words.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32)[None, None, :], axis=-1)
    return packed, bits


@jax.jit
def hamming_matrix(d1, d2):
    """[N1,8]u32 × [N2,8]u32 → Hamming distances [N1,N2] (XOR + popcount —
    the packed-bit matcher of SURVEY.md §2.2/§2.4)."""
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@jax.jit
def global_descriptor(bits, valid):
    """Mean sign-random-projection of local BRIEF bit vectors, L2-normalised."""
    f = (bits.astype(jnp.float32) * 2.0 - 1.0) * (valid[:, None] > 0)
    g = jnp.sum(f @ jnp.asarray(_PROJ), axis=0)
    return g / jnp.maximum(jnp.linalg.norm(g), 1e-9)


def extract_keyframe_features(img_j, extra_uv=None):
    """FAST/Shi-Tomasi corners + BRIEF for a new keyframe
    (`computeBRIEFPoint`; `computeWindowBRIEFPoint` when extra_uv carries the
    estimator's window points)."""
    uv, score = shi_tomasi_grid(
        img_j, jnp.zeros((1, 2), img_j.dtype), jnp.zeros((1,), img_j.dtype),
        cell=16, max_out=MAX_KP,
    )
    valid = (score > 1e-5).astype(img_j.dtype)
    if extra_uv is not None and len(extra_uv):
        # pad extra_uv to a BUCKETED slot count: a per-call length would give
        # every distinct window-point count its own compiled executable
        # (seconds of compile each), but a single MAX_KP//2
        # reservation costs small payloads up to MAX_KP//2 - cnt detector
        # corners — two buckets bound both
        nmax = MAX_KP // 4 if len(extra_uv) <= MAX_KP // 4 else MAX_KP // 2
        cnt = min(len(extra_uv), nmax)
        buf = np.zeros((nmax, 2), np.float32)
        buf[:cnt] = np.asarray(extra_uv[:cnt], np.float32)
        vbuf = np.zeros((nmax,), np.float32)
        vbuf[:cnt] = 1.0
        uv = jnp.concatenate([jnp.asarray(buf, img_j.dtype), uv[: MAX_KP - nmax]])
        valid = jnp.concatenate([jnp.asarray(vbuf, img_j.dtype), valid[: MAX_KP - nmax]])
    desc, bits = brief_descriptors(img_j, uv, valid)
    gdesc = global_descriptor(bits, valid)
    return np.asarray(uv), np.asarray(valid, bool), np.asarray(desc), np.asarray(gdesc)


# ----------------------------------------------------------------- PnP RANSAC
def _dlt_batch(X, x):
    """Batched DLT pose-from-points. X [..., M, 3] world, x [..., M, 2]
    normalized obs → (R [...,3,3], t [...,3]) with x_c = R x_w + t.

    One batched 2M×12 SVD for the projection matrix + one batched 3×3 SVD to
    project onto SO(3) — the reference's per-hypothesis cv::solvePnP inner
    solve, vectorized over all RANSAC hypotheses at once."""
    M = X.shape[-2]
    Xh = np.concatenate([X, np.ones(X.shape[:-1] + (1,))], axis=-1)  # [...,M,4]
    zeros = np.zeros_like(Xh)
    r0 = np.concatenate([Xh, zeros, -x[..., 0:1] * Xh], axis=-1)  # [...,M,12]
    r1 = np.concatenate([zeros, Xh, -x[..., 1:2] * Xh], axis=-1)
    A = np.concatenate([r0, r1], axis=-2)  # [...,2M,12]
    _, _, Vt = np.linalg.svd(A)
    P = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    Mm = P[..., :3]
    U, S, Vt2 = np.linalg.svd(Mm)
    scale = np.mean(S, axis=-1)
    R = U @ Vt2
    det = np.linalg.det(R)
    R = R * np.sign(det)[..., None, None]
    scale = scale * np.sign(det)
    t = P[..., 3] / scale[..., None]
    return R, t


def pnp_ransac(pts3d, pts2d_norm, iters=128, thresh=10.0 / 460.0, seed=0, min_inliers=12,
               return_best=False):
    """`cv::solvePnPRansac` equivalent: all DLT-6pt hypotheses built, solved
    (batched SVD) and scored at once — no sequential hypothesis loop.

    pts3d [N,3] world, pts2d_norm [N,2] normalized obs in query cam.
    `thresh` is in NORMALIZED units — pass pixel_tol / fx (the reference's
    reprojectionError=10 px is camera-dependent).
    Returns (R_cw, t_cw, inlier_mask) with x_c = R_cw x_w + t_cw, or None;
    with return_best=True the best hypothesis is returned even below
    `min_inliers` (caller gates and can log the count)."""
    n = len(pts3d)
    if n < 6:
        return None
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 6, replace=False) for _ in range(iters)])  # [I,6]

    def score(R, t):
        """R [...,3,3], t [...,3] → inlier mask [...,N]."""
        pc = np.einsum("...ij,nj->...ni", R, pts3d) + t[..., None, :]
        z = pc[..., 2]
        proj = pc[..., :2] / np.where(np.abs(z[..., None]) > 1e-6, z[..., None], 1e-6)
        err = np.linalg.norm(proj - pts2d_norm, axis=-1)
        return (err < thresh) & (z > 0.1)

    with np.errstate(all="ignore"):
        R, t = _dlt_batch(pts3d[idx], pts2d_norm[idx])  # [I,3,3],[I,3]
    ok = np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
    inl = score(R, t) & ok[:, None]  # [I,N]
    best_i = int(np.argmax(inl.sum(axis=1)))
    best = (R[best_i], t[best_i], inl[best_i])
    if best[2].sum() < min_inliers and not return_best:
        return None
    R, t, inl = best
    if inl.sum() < 6:
        return (R, t, inl) if return_best else None
    for _ in range(2):  # refit on inliers (cv's iterative refinement)
        sel = np.nonzero(inl)[0][:48]
        try:
            with np.errstate(all="ignore"):
                R2, t2 = _dlt_batch(pts3d[sel], pts2d_norm[sel])
        except np.linalg.LinAlgError:
            break
        if not (np.isfinite(R2).all() and np.isfinite(t2).all()):
            break
        inl2 = score(R2, t2)
        if inl2.sum() < inl.sum():
            break
        R, t, inl = R2, t2, inl2
    if inl.sum() < min_inliers and not return_best:
        return None
    return R, t, inl


class KeyframeDB:
    """Fixed-capacity keyframe store + exhaustive global-descriptor search
    (`BriefDatabase::query` replacement, thresholds per `detectLoop`)."""

    def __init__(self, capacity=2048):
        self.capacity = capacity
        self.gdescs = np.zeros((capacity, GDESC_DIM), np.float32)
        self.n = 0
        self.entries = []  # per-kf dicts: uv, valid, desc, pts3d, pose
        self.recent = []  # per-query best-candidate index (or None) — the
        # temporal-consistency history of `detectLoop` (SURVEY.md:144)
        self.last_candidates = []  # strong candidates of the last ACCEPTED query

    def add(self, entry, gdesc):
        if self.n >= self.capacity:
            return -1
        self.gdescs[self.n] = gdesc
        self.entries.append(entry)
        self.n += 1
        return self.n - 1

    def query(self, gdesc, exclude_last=50, min_score=0.15, top_k=4, always_include=0,
              consistency=1, consistency_gap=12):
        """Top-k cosine candidates older than `exclude_last` frames.
        Mirrors detectLoop's relative-threshold check (best strong AND a
        second candidate present) plus its TEMPORAL consistency: with
        `consistency` > 1, a candidate is returned only when the previous
        (consistency − 1) queries also produced candidates within
        ±consistency_gap of it — a transiently-aliased place fires once and
        is rejected; a genuine revisit persists across keyframes.
        `always_include`: entries [0, always_include) are a loaded previous
        map — never "recent", so always searchable, and exempt from temporal
        consistency (fast_relocalization snaps on the first confirmed match).

        On acceptance, `self.last_candidates` holds the strong candidates
        OLDEST-FIRST (the reference's detectLoop took the MINIMUM index among
        qualifying candidates): under perceptual aliasing — two visually
        identical places — the best COSINE candidate can be the wrong room
        while an older one is the true revisit, and the oldest hypothesis is
        also the one that closes the most drift; geometric verification
        (BRIEF+PnP in findConnection), not place recognition, is the
        disambiguator, so the caller tries each in order until one
        confirms."""
        self.last_candidates = []
        hi = max(self.n - exclude_last, min(always_include, self.n))
        if hi <= 0:
            self.recent.append(None)
            return None
        sims = self.gdescs[:hi] @ gdesc
        # rank depth 2×top_k: clones of the true place can crowd out the
        # oldest qualifying candidate from a shallow top-k (aliased scenes)
        order = np.argsort(-sims)[: 2 * top_k]
        cand = None
        if sims[order[0]] >= min_score and not (
                len(order) > 1 and sims[order[1]] < min_score * 0.45):
            cand = int(order[0])
        accepted = cand
        if cand is not None and cand >= always_include and consistency > 1:
            hist = self.recent[-(consistency - 1):]
            if len(hist) < consistency - 1 or not all(
                    p is not None and abs(p - cand) <= consistency_gap for p in hist):
                accepted = None
        self.recent.append(cand)
        if accepted is not None:
            # oldest-first (reference min_index semantics)
            self.last_candidates = sorted(
                int(i) for i in order if sims[i] >= min_score)
        return accepted
