"""Line-feature frontend: detection + LBD descriptors + matching.

JAX equivalent of the reference's `linefeature_tracker.cpp` +
vendored `line_descriptor/` (`LSDDetector::detect`, `BinaryDescriptor::compute`
(band-based LBD), `BinaryDescriptorMatcher` — SURVEY.md §2.2 / §3.2).

Re-design (SURVEY.md §7 stage 2 — LSD's sequential region-growing does not
map to a data-parallel device): a **tiled windowed-Hough detector**:
  1. Scharr gradients → orientation + magnitude, Canny-style thin edge mask
     (all dense conv/elementwise),
  2. the image splits into overlapping tiles; each tile computes an
     edge-magnitude-weighted Hough transform ([n_theta × n_rho] — one einsum
     per tile, batched over tiles as one matmul),
  3. top-K Hough peaks per tile → candidate (θ, ρ) lines; supporting edge
     pixels project onto the line direction to give endpoints + support
     density gates,
  4. near-duplicate suppression across tiles (angle/distance gating).
All shapes fixed: T tiles × K peaks candidates, masked validity. Recall
differs from OpenCV LSD per design; the matching+BA layer only needs
comparable segments (SURVEY.md stage-2 note).

Descriptor: band-based LBD over the line-support region (9 bands × 8
gradient statistics → 72-d float, L2-normalised). The reference binarised to
256 bits for Hamming matching; we match the float descriptor with a cosine
distance matrix (one matmul) + mutual-best + geometric gating, and keep
binarisation as an optional compression (documented deviation).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.ops.cameras import PinholeRadTan, lift

TILE = 64
TILE_STRIDE = 48
N_THETA = 32
N_RHO = 40
TOP_K = 4
N_BANDS = 9
BAND_W = 3  # pixels per band across the line
LBD_SAMPLES = 32  # samples along the line


# ---------------------------------------------------------------- gradients
def _scharr(img):
    kx = jnp.asarray([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]], img.dtype) / 32.0
    ky = kx.T
    pad = jnp.pad(img, 1, mode="edge")
    gx = _conv3(pad, kx, img.shape)
    gy = _conv3(pad, ky, img.shape)
    return gx, gy


def _conv3(padded, k, shape):
    H, W = shape
    out = jnp.zeros(shape, padded.dtype)
    for dy in range(3):
        for dx in range(3):
            out = out + k[dy, dx] * padded[dy : dy + H, dx : dx + W]
    return out


@jax.jit
def edge_map(img):
    """Gradient magnitude + orientation + thin (NMS) edge mask."""
    gx, gy = _scharr(img)
    mag = jnp.hypot(gx, gy)
    # direction-quantized non-max suppression (4 directions)
    ang = jnp.arctan2(gy, gx)  # [-pi, pi]
    d = jnp.round(ang / (jnp.pi / 4.0)).astype(jnp.int32) % 4  # 0:E 1:NE 2:N 3:NW
    pm = jnp.pad(mag, 1)
    H, W = img.shape
    n0a, n0b = pm[1 : H + 1, 2:], pm[1 : H + 1, :W]
    n1a, n1b = pm[2:, 2:], pm[:H, :W]
    n2a, n2b = pm[2:, 1 : W + 1], pm[:H, 1 : W + 1]
    n3a, n3b = pm[2:, :W], pm[:H, 2:]
    na = jnp.select([d == 0, d == 1, d == 2, d == 3], [n0a, n1a, n2a, n3a])
    nb = jnp.select([d == 0, d == 1, d == 2, d == 3], [n0b, n1b, n2b, n3b])
    thin = (mag >= na) & (mag >= nb)
    thresh = 4.0 * jnp.mean(mag)
    edge = thin & (mag > thresh)
    return mag, ang, edge


# ------------------------------------------------------------------- Hough
def _tile_starts(size, tile, stride):
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] != size - tile and size > tile:
        starts.append(size - tile)
    return starts


@partial(jax.jit, static_argnames=("h", "w", "max_out", "min_support"))
def detect_segments(mag, ang, edge, h: int, w: int, max_out: int = 96,
                    min_support: float = 18.0, min_len: float = 24.0):
    """Tiled Hough line-segment detection. Returns
    (segs [max_out,4] pixel endpoints (sx,sy,ex,ey), score [max_out],
    valid [max_out])."""
    dtype = mag.dtype
    ys = _tile_starts(h, TILE, TILE_STRIDE)
    xs = _tile_starts(w, TILE, TILE_STRIDE)
    tiles = [(y, x) for y in ys for x in xs]
    T = len(tiles)

    thetas = jnp.linspace(0.0, np.pi, N_THETA, endpoint=False).astype(dtype)
    ct, st = jnp.cos(thetas), jnp.sin(thetas)
    rho_max = float(TILE) * 0.75
    rho_edges = jnp.linspace(-rho_max, rho_max, N_RHO + 1).astype(dtype)
    drho = float(2 * rho_max / N_RHO)

    yy, xx = jnp.meshgrid(
        jnp.arange(TILE, dtype=dtype), jnp.arange(TILE, dtype=dtype), indexing="ij"
    )
    xc = xx - TILE / 2.0
    yc = yy - TILE / 2.0

    ty = jnp.asarray([t[0] for t in tiles])
    tx = jnp.asarray([t[1] for t in tiles])
    tile_mag = jnp.stack([
        jax.lax.dynamic_slice(mag * edge, (y, x), (TILE, TILE)) for (y, x) in tiles
    ])  # [T,TILE,TILE]
    tile_ang = jnp.stack([
        jax.lax.dynamic_slice(ang, (y, x), (TILE, TILE)) for (y, x) in tiles
    ])

    # rho-bin membership per (pixel, theta) depends only on the tile's pixel
    # grid — a static one-hot [NT, NR, P] folded at compile time, turning the
    # Hough accumulation into one batched matmul instead of a scatter-add
    # (which of the two is faster on the GPU is not measured)
    rho = xc.reshape(-1)[:, None] * ct[None, :] + yc.reshape(-1)[:, None] * st[None, :]
    rbin = jnp.clip(((rho + rho_max) / drho).astype(jnp.int32), 0, N_RHO - 1)  # [P,NT]
    onehot_T = jnp.transpose(
        (rbin[:, :, None] == jnp.arange(N_RHO)[None, None, :]).astype(dtype), (1, 2, 0))

    # edge-pixel weights, orientation-gated per theta: a line at angle
    # θ_line has gradient ⟂ to it → gradient angle ≈ θ (the normal)
    pix_w = tile_mag.reshape(T, -1)  # [T,P]
    pa = tile_ang.reshape(T, -1)
    # orientation gate: gradient direction vs theta (mod pi)
    dth = jnp.abs(((pa[..., None] - thetas) + jnp.pi / 2) % jnp.pi - jnp.pi / 2)
    gate = dth < (np.pi / N_THETA) * 1.5
    # the [T,P,NT] gated-weight tensor is the detector's one big device-memory
    # intermediate (~71 MB at 752×480 in f32) — it lives in bfloat16: peak
    # SELECTION only needs ~0.4 % relative score accuracy, the downstream
    # uses are a (>0) support mask and sums re-accumulated in f32
    mm_dtype = jnp.bfloat16 if dtype == jnp.float32 else dtype
    wgt_all = pix_w.astype(mm_dtype)[..., None] * gate.astype(mm_dtype)  # [T,P,NT]
    # acc[θ,r,t] = Σ_p 1[rbin(p,θ)=r]·wgt[t,p,θ] — ALL tiles ride the matmul
    # N-dimension (a [NT,NR,P]@[NT,P,T] batched matmul instead of T matvecs,
    # which would run the matrix units at N=1), bf16 in / f32 out
    acc = jax.lax.dot_general(
        onehot_T.astype(mm_dtype),
        jnp.transpose(wgt_all, (2, 1, 0)),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=dtype,
    )  # [NT,NR,T]
    acc = jnp.transpose(acc, (2, 0, 1)).astype(dtype)  # [T,NT,NR]

    flat = acc.reshape(T, -1)
    top = jax.lax.top_k(flat, TOP_K)[1]  # [T,K]
    th_i = top // N_RHO
    rh_i = top % N_RHO

    def peak_segment(t):
        def one(k):
            ti = th_i[t, k]
            ri = rh_i[t, k]
            rho0 = rho_edges[ri] + 0.5 * drho
            c, s = ct[ti], st[ti]
            # supporting pixels: near the line & orientation-gated
            d_line = xc.reshape(-1) * c + yc.reshape(-1) * s - rho0
            sup = (jnp.abs(d_line) < 1.5) * wgt_all[t, :, ti]
            sup_cnt = jnp.sum(sup > 0)  # supporting edge-pixel count
            # extent along the line direction (-s, c)
            tpos = -xc.reshape(-1) * s + yc.reshape(-1) * c
            wsum = jnp.sum(sup.astype(dtype))  # f32 accumulation of bf16 weights
            big = 1e9
            tmin = jnp.min(jnp.where(sup > 0, tpos, big))
            tmax = jnp.max(jnp.where(sup > 0, tpos, -big))
            # endpoints in tile coords
            p0 = jnp.stack([rho0 * c - tmin * s, rho0 * s + tmin * c])
            p1 = jnp.stack([rho0 * c - tmax * s, rho0 * s + tmax * c])
            length = tmax - tmin
            # density gate: supporting pixels per unit length (thin edges → ≈1)
            dens = sup_cnt / jnp.maximum(length, 1.0)
            off = jnp.stack([tx[t].astype(dtype) + TILE / 2, ty[t].astype(dtype) + TILE / 2])
            ok_seg = (length > min_len) & (sup_cnt > min_support) & (dens > 0.6)
            return jnp.concatenate([p0 + off, p1 + off]), wsum, ok_seg

        return jax.vmap(one)(jnp.arange(TOP_K))

    segs, score, ok = jax.vmap(peak_segment)(jnp.arange(T))
    segs = segs.reshape(-1, 4)
    score = score.reshape(-1)
    ok = ok.reshape(-1)

    # cross-tile near-duplicate suppression: keep highest score among
    # candidates with similar angle and midpoint distance
    mid = 0.5 * (segs[:, 0:2] + segs[:, 2:4])
    dvec = segs[:, 2:4] - segs[:, 0:2]
    angs = jnp.arctan2(dvec[:, 1], dvec[:, 0]) % jnp.pi
    n_cand = segs.shape[0]
    d_mid = jnp.linalg.norm(mid[:, None, :] - mid[None, :, :], axis=-1)
    d_ang = jnp.abs((angs[:, None] - angs[None, :] + jnp.pi / 2) % jnp.pi - jnp.pi / 2)
    similar = (d_mid < 16.0) & (d_ang < 0.12)
    better = (score[None, :] > score[:, None]) & similar
    keep = ok & ~jnp.any(better & ok[None, :], axis=1)

    order = jnp.argsort(-(score * keep))[:max_out]
    return segs[order], score[order], keep[order]


# --------------------------------------------------------------------- LBD
@partial(jax.jit, static_argnames=())
def lbd_descriptors(mag_gx, mag_gy, segs, valid):
    """Band-based LBD float descriptor per segment [N, 8*N_BANDS].

    For each segment: LBD_SAMPLES points along the line × N_BANDS rows across
    it; gradients rotate into the line frame (d∥, d⊥); per band compute
    (mean⁺, mean⁻, std of d⊥; mean⁺, mean⁻, std of d∥, |mean|s) — 8 stats —
    then L2-normalise (`BinaryDescriptor::compute` band statistics, float
    form)."""
    n = segs.shape[0]
    dtype = segs.dtype
    # both gradient channels ride each gather (4 gathers of [2,P] instead of
    # 8 of [P], bit-identical descriptors)
    g2 = jnp.stack([mag_gx, mag_gy])  # [2,H,W]
    Himg, Wimg = mag_gx.shape

    def one(seg):
        p0 = seg[0:2]
        p1 = seg[2:4]
        d = p1 - p0
        L = jnp.maximum(jnp.linalg.norm(d), 1e-6)
        u = d / L  # along line
        v = jnp.stack([-u[1], u[0]])  # normal
        t = jnp.linspace(0.05, 0.95, LBD_SAMPLES).astype(dtype)
        base = p0[None, :] + t[:, None] * d[None, :]  # [S,2]
        offs = (jnp.arange(N_BANDS, dtype=dtype) - (N_BANDS - 1) / 2.0) * BAND_W
        pts = base[None, :, :] + offs[:, None, None] * v[None, None, :]  # [B,S,2]
        px = pts[..., 0].reshape(-1)
        py = pts[..., 1].reshape(-1)
        x0 = jnp.floor(px)
        y0 = jnp.floor(py)
        dx = (px - x0)[None, :]
        dy = (py - y0)[None, :]
        x0i = jnp.clip(x0.astype(jnp.int32), 0, Wimg - 2)
        y0i = jnp.clip(y0.astype(jnp.int32), 0, Himg - 2)
        i00 = g2[:, y0i, x0i]
        i01 = g2[:, y0i, x0i + 1]
        i10 = g2[:, y0i + 1, x0i]
        i11 = g2[:, y0i + 1, x0i + 1]
        gs = (i00 * (1 - dx) * (1 - dy) + i01 * dx * (1 - dy)
              + i10 * (1 - dx) * dy + i11 * dx * dy)  # [2,B*S]
        gxx = gs[0].reshape(N_BANDS, LBD_SAMPLES)
        gyy = gs[1].reshape(N_BANDS, LBD_SAMPLES)
        d_par = gxx * u[0] + gyy * u[1]
        d_perp = gxx * v[0] + gyy * v[1]

        def band_stats(x):
            pos = jnp.maximum(x, 0.0)
            neg = jnp.maximum(-x, 0.0)
            return jnp.stack([
                jnp.mean(pos, axis=1), jnp.mean(neg, axis=1),
                jnp.std(x, axis=1), jnp.mean(jnp.abs(x), axis=1),
            ], axis=1)  # [B,4]

        feats = jnp.concatenate([band_stats(d_perp), band_stats(d_par)], axis=1)  # [B,8]
        f = feats.reshape(-1)
        return f / jnp.maximum(jnp.linalg.norm(f), 1e-9)

    desc = jax.vmap(one)(segs)
    return desc * valid[:, None]


# fixed band-pair comparison tests: the reference's binary LBD
# (binary_descriptor.cpp) is a vector of comparisons of the SAME statistic
# between band pairs — same-type stats share scale, so the comparison is
# stable under noise (random cross-stat pairs compare near-zero values and
# flip bits). 8 stats × C(9,2)=36 band pairs = 288 tests; a fixed random 256
# -subset gives the reference's 256-bit descriptor shape.
_N_LBD_BITS = 256


def _lbd_pairs():
    pa, pb = [], []
    for s in range(8):
        for b1 in range(N_BANDS):
            for b2 in range(b1 + 1, N_BANDS):
                pa.append(b1 * 8 + s)
                pb.append(b2 * 8 + s)
    pa = np.asarray(pa, np.int32)
    pb = np.asarray(pb, np.int32)
    sel = np.random.default_rng(31).permutation(len(pa))[:_N_LBD_BITS]
    return pa[sel], pb[sel]


_LBD_PA, _LBD_PB = _lbd_pairs()


@jax.jit
def binarize_lbd(desc):
    """Float LBD [N,72] → packed 256-bit binary descriptor [N,8] uint32
    (the reference's `BinaryDescriptor` output shape: Hamming-matchable)."""
    bits = desc[:, _LBD_PA] > desc[:, _LBD_PB]  # [N,256]
    words = bits.reshape(-1, _N_LBD_BITS // 32, 32)
    return jnp.sum(words.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32)[None, None, :], axis=-1)


def _hamming_dist(d1, d2):
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_dist",))
def match_lbd_binary(desc1, segs1, valid1, desc2, segs2, valid2,
                     max_dist: int = 80):
    """Binary variant of `match_lbd`: packed-bit Hamming KNN (the reference's
    `BinaryDescriptorMatcher`, distance thresholded) + the same mutual-best
    and geometric gates."""
    dist = _hamming_dist(desc1, desc2)  # [N1,N2] int32
    ok = (valid1[:, None] > 0) & (valid2[None, :] > 0)

    mid1 = 0.5 * (segs1[:, 0:2] + segs1[:, 2:4])
    mid2 = 0.5 * (segs2[:, 0:2] + segs2[:, 2:4])
    d1 = segs1[:, 2:4] - segs1[:, 0:2]
    d2 = segs2[:, 2:4] - segs2[:, 0:2]
    a1 = jnp.arctan2(d1[:, 1], d1[:, 0]) % jnp.pi
    a2 = jnp.arctan2(d2[:, 1], d2[:, 0]) % jnp.pi
    d_mid = jnp.linalg.norm(mid1[:, None] - mid2[None, :], axis=-1)
    d_ang = jnp.abs((a1[:, None] - a2[None, :] + jnp.pi / 2) % jnp.pi - jnp.pi / 2)
    gate = (d_mid < 60.0) & (d_ang < 0.25)

    dist = jnp.where(ok & gate, dist, 999)
    best12 = jnp.argmin(dist, axis=1)
    best21 = jnp.argmin(dist, axis=0)
    mutual = best21[best12] == jnp.arange(dist.shape[0])
    good = mutual & (jnp.min(dist, axis=1) < max_dist) & (valid1 > 0)
    return jnp.where(good, best12, -1)


@jax.jit
def match_lbd(desc1, segs1, valid1, desc2, segs2, valid2):
    """Mutual-best cosine matching + geometric gating
    (`BinaryDescriptorMatcher` + the tracker's angle/midpoint gates).
    Returns idx2 [N1] (match in frame 2, −1 = none)."""
    sim = desc1 @ desc2.T  # [N1,N2] cosine (descs are L2-normalised)
    ok = (valid1[:, None] > 0) & (valid2[None, :] > 0)

    mid1 = 0.5 * (segs1[:, 0:2] + segs1[:, 2:4])
    mid2 = 0.5 * (segs2[:, 0:2] + segs2[:, 2:4])
    d1 = segs1[:, 2:4] - segs1[:, 0:2]
    d2 = segs2[:, 2:4] - segs2[:, 0:2]
    a1 = jnp.arctan2(d1[:, 1], d1[:, 0]) % jnp.pi
    a2 = jnp.arctan2(d2[:, 1], d2[:, 0]) % jnp.pi
    d_mid = jnp.linalg.norm(mid1[:, None] - mid2[None, :], axis=-1)
    d_ang = jnp.abs((a1[:, None] - a2[None, :] + jnp.pi / 2) % jnp.pi - jnp.pi / 2)
    gate = (d_mid < 60.0) & (d_ang < 0.25)

    sim = jnp.where(ok & gate, sim, -2.0)
    best12 = jnp.argmax(sim, axis=1)
    best21 = jnp.argmax(sim, axis=0)
    mutual = best21[best12] == jnp.arange(sim.shape[0])
    good = mutual & (jnp.max(sim, axis=1) > 0.75) & (valid1 > 0)
    return jnp.where(good, best12, -1)


@partial(jax.jit, static_argnames=("max_out",))
def merge_candidates(segs, score, valid, max_out: int):
    """Cross-octave/near-duplicate suppression, vectorized (same
    strictly-better idiom as the in-tile suppression in `detect_segments` —
    replaces the former O(n²) host Python loop). Returns
    (segs [max_out,4], score [max_out], valid [max_out]) sorted by score."""
    mid = 0.5 * (segs[:, 0:2] + segs[:, 2:4])
    dvec = segs[:, 2:4] - segs[:, 0:2]
    angs = jnp.arctan2(dvec[:, 1], dvec[:, 0]) % jnp.pi
    d_mid = jnp.linalg.norm(mid[:, None, :] - mid[None, :, :], axis=-1)
    d_ang = jnp.abs((angs[:, None] - angs[None, :] + jnp.pi / 2) % jnp.pi - jnp.pi / 2)
    similar = (d_mid < 20.0) & (d_ang < 0.12)
    idx = jnp.arange(segs.shape[0])
    better = (score[None, :] > score[:, None]) | (
        (score[None, :] == score[:, None]) & (idx[None, :] < idx[:, None]))
    keep = valid & ~jnp.any(similar & better & valid[None, :], axis=1)
    order = jnp.argsort(-(score * keep))[:max_out]
    return segs[order], score[order] * keep[order], keep[order]


# ------------------------------------------------------------------- driver
class FrontendLines:
    """Host orchestration (`LineFeatureTracker` equivalent)."""

    def __init__(self, cam: PinholeRadTan, max_lines=64, dtype=jnp.float32, octaves=2,
                 binary_desc: bool = False):
        self.cam = cam
        self.max_lines = max_lines
        self.dtype = dtype
        self.octaves = octaves  # LSDDetector's scale pyramid (`numOctaves`)
        # binary_desc: match 256-bit binarized LBD by packed Hamming (the
        # reference's BinaryDescriptorMatcher path) instead of float cosine
        self.binary_desc = binary_desc
        self.prev = None  # (segs, desc, valid, ids)

    def reset(self):
        """Restart the tracker (timestamp-jump restart handshake): drop the
        device-resident segment/descriptor/id state so no cross-gap line
        track survives."""
        self.prev = None

    def _program(self):
        return _ln_program(self.max_lines, self.octaves, self.binary_desc,
                           self.dtype)

    def process(self, img, t: float, oct1=None, want_output: bool = True):
        """One frame tick. With want_output=True pulls ONE bundle and returns
        (ids, normalized segments [n,4]); with want_output=False everything
        stays on device and returns None (non-published FREQ-control frames).
        `img` may be a host array or an already-uploaded device array;
        `oct1`: optional shared half-res device image (the point pyramid's
        level 1)."""
        prog, _ = self._program()
        img_j = img if isinstance(img, jax.Array) else jnp.asarray(img, self.dtype)
        if self.prev is None:
            desc_shape = ((self.max_lines, _N_LBD_BITS // 32) if self.binary_desc
                          else (self.max_lines, N_BANDS * 8))
            desc0 = (jnp.zeros(desc_shape, jnp.uint32) if self.binary_desc
                     else jnp.zeros(desc_shape, self.dtype))
            self.prev = (jnp.zeros((self.max_lines, 4), self.dtype), desc0,
                         jnp.zeros((self.max_lines,), self.dtype),
                         jnp.full((self.max_lines,), -1, jnp.int32),
                         jnp.zeros((), jnp.int32))
        have = oct1 is not None
        oct1_j = (jnp.asarray(oct1, self.dtype) if have
                  else jnp.zeros((2, 2), self.dtype))
        self.prev, bundle = prog(self.cam, img_j, oct1_j, have, *self.prev)
        if not want_output:
            return None

        def unpack(parts):
            b, ids_i = parts
            sp, ep = b[:, 0:2].astype(np.float64), b[:, 2:4].astype(np.float64)
            v = b[:, 4] > 0
            ids = ids_i.astype(np.int64)
            out = v & (ids >= 0)
            return ids[out], np.concatenate([sp[out], ep[out]], axis=1)

        from plslam.models.frontend_points import OutputHandle

        h = OutputHandle(bundle, unpack)
        return h if want_output == "defer" else h.get()


from functools import lru_cache  # noqa: E402


@lru_cache(maxsize=None)
def _ln_program(max_lines: int, octaves: int, binary: bool, dtype):
    """The whole line tick as ONE jitted program carrying device-resident
    state (segments, descriptors, validity, feature ids) — built ONCE per
    static config at module level (per-instance closures would recompile for
    every new FrontendLines; the tick is one dispatch and at most one pull).
    The camera is a dynamic pytree argument."""

    def tick(cam, img, oct1, have_oct1: bool, prev_segs, prev_desc, prev_valid,
             prev_ids, next_id):
        """Un-jitted tick body — also composed into larger programs (the
        offline burst scan in models/burst.py)."""
        all_segs, all_scores, all_valid = [], [], []
        cur = img
        for o in range(octaves):
            mag, ang, edge = edge_map(cur)
            segs_o, score_o, valid_o = detect_segments(
                mag, ang, edge, *cur.shape, max_out=max_lines)
            s = float(2 ** o)
            all_segs.append(segs_o * s)
            all_scores.append(score_o * s)
            all_valid.append(valid_o)
            if o + 1 < octaves:
                if o == 0 and have_oct1:
                    cur = oct1
                else:
                    from plslam.models.frontend_points import _sep_conv

                    k5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], img.dtype) / 16.0
                    cur = _sep_conv(cur, k5)[::2, ::2]
        segs, score, valid = merge_candidates(
            jnp.concatenate(all_segs), jnp.concatenate(all_scores),
            jnp.concatenate(all_valid), max_out=max_lines)
        valid_f = valid.astype(dtype)
        gx, gy = _scharr(img)
        desc = lbd_descriptors(gx, gy, segs, valid_f)
        if binary:
            desc = binarize_lbd(desc)
            m = match_lbd_binary(prev_desc, prev_segs, prev_valid,
                                 desc, segs, valid_f)
        else:
            m = match_lbd(prev_desc, prev_segs, prev_valid, desc, segs, valid_f)
        # id propagation on device: prev line i matched to cur j carries its
        # id; unmatched valid cur lines get fresh consecutive ids
        L = max_lines
        ok_m = (m >= 0) & (prev_ids >= 0) & (prev_valid > 0)
        tgt = jnp.where(ok_m, m, L)  # out-of-range drops
        ids = jnp.full((L,), -1, jnp.int32).at[tgt].set(prev_ids, mode="drop")
        newly = valid & (ids < 0)
        rank = (jnp.cumsum(newly) - 1).astype(jnp.int32)
        ids = jnp.where(newly, next_id + rank, ids)
        ids = jnp.where(valid, ids, -1)
        next1 = next_id + jnp.sum(newly).astype(jnp.int32)
        sp = lift(cam, segs[:, 0:2])
        ep = lift(cam, segs[:, 2:4])
        # ids stay a SEPARATE int32 array (bitcast-into-f32 lanes are
        # denormals, which accelerators may flush to zero downstream)
        bundle = jnp.concatenate([sp, ep, valid_f[:, None]], axis=1)  # [L,5]
        return (segs, desc, valid_f, ids, next1), (bundle, ids)

    prog = partial(jax.jit, static_argnames=("have_oct1",))(tick)
    return prog, tick
