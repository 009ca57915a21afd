"""Synthetic image rendering + EuRoC-format dataset writer.

Closes the loop the sandbox can't (no EuRoC data on disk): render actual
images of the simulator's 3D world — gaussian blobs at landmark projections
(trackable corners) + anti-aliased line segments — and write a miniature
ASL-layout dataset (`mav0/cam0/data.csv` + PNGs, `mav0/imu0/data.csv`,
ground truth). `runner.run_euroc` then exercises the ENTIRE image pipeline:
PNG decode (native C++) → CLAHE → point/line frontends → estimator → pose
graph, exactly as it would on the real dataset.
"""
from __future__ import annotations

import os
import shutil
import struct
import zlib

import numpy as np

from plslam.io.synthetic import SyntheticSequence
from plslam.utils.geometry import quat_rotate, quat_conj, quat_mul


_STAMP_CACHE: dict = {}


def _landmark_stamps(n: int, r: int, sigma: float, style: str = "gaussian") -> np.ndarray:
    """Per-landmark stamps. style="gaussian": clean isotropic blobs (best LK
    tracking accuracy — the default); style="textured": a checkerboard corner
    at the stamp center (exact Shi-Tomasi/LK localization) surrounded by
    unique band-limited noise per landmark, wide enough (≥ the BRIEF pattern
    radius) to give each landmark a distinctive BRIEF appearance — this is
    what makes appearance-level loop confirmation fire on rendered imagery."""
    key = (n, r, round(sigma, 3), style)
    if key in _STAMP_CACHE:
        return _STAMP_CACHE[key]
    rng = np.random.default_rng(1234)
    size = 2 * r + 1
    ys, xs = np.meshgrid(np.arange(size) - r, np.arange(size) - r, indexing="ij")
    gwin = np.exp(-((xs**2 + ys**2) / (2.0 * sigma**2))).astype(np.float32)
    amps = (0.35 + 0.45 * rng.random(n)) * rng.choice([-1.0, 1.0], n)
    if style == "gaussian":
        stamps = (amps[:, None, None] * gwin[None]).astype(np.float32)
        _STAMP_CACHE[key] = stamps
        return stamps
    # unique smoothed noise texture per landmark (the BRIEF signature)
    noise = rng.standard_normal((n, size, size)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(2):
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, noise.reshape(-1, size)).reshape(n, size, size)
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, noise.transpose(0, 2, 1).reshape(-1, size)).reshape(n, size, size).transpose(0, 2, 1)
    noise = noise / (np.abs(noise).max(axis=(1, 2), keepdims=True) + 1e-9)
    # per-landmark randomly-signed checkerboard corner at the center: gives
    # the detector/LK an exact corner and anchors the BRIEF patch
    quad = np.sign(xs + 0.5)[None] * np.sign(ys + 0.5)[None] * rng.choice([-1.0, 1.0], n)[:, None, None]
    cwin = np.exp(-((xs**2 + ys**2) / (2.0 * max(0.55 * sigma, 2.2) ** 2))).astype(np.float32)
    # wide annular window for the noise: texture reaches the whole BRIEF
    # patch but stays OFF the center so the checker corner wins Shi-Tomasi
    # (detected corners must localize to the landmark, not a noise peak)
    rr2 = (xs**2 + ys**2).astype(np.float32)
    nwin = np.exp(-rr2 / (2.0 * (0.60 * r) ** 2)).astype(np.float32)
    nwin = nwin * np.clip((np.sqrt(rr2) - 3.0) / 2.5, 0.0, 1.0)
    pattern = 1.0 * quad * cwin[None] + 0.8 * noise * nwin[None]
    stamps = (amps[:, None, None] * 1.3 * pattern).astype(np.float32)
    _STAMP_CACHE[key] = stamps
    return stamps


def render_frame(seq: SyntheticSequence, k: int, cam, h: int, w: int,
                 blob_sigma=2.0, style: str = "gaussian", rng=None,
                 stamp_of=None) -> np.ndarray:
    """Render frame k: background gradient + landmark blobs + line segments.

    stamp_of: optional [n_landmarks] index map landmark → stamp. Mapping two
    landmark sets onto the SAME stamps renders perceptually-aliased places
    (two visually identical rooms) — the loop-closure robustness scenario."""
    import jax.numpy as jnp
    from plslam.ops.cameras import normalized_to_pixel

    img = np.full((h, w), 0.35, np.float32)
    # mild static vignette/gradient for CLAHE to chew on
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img += 0.08 * np.sin(3 * xx) * np.cos(2 * yy)

    obs = np.asarray(seq.obs[k])
    vis = np.asarray(seq.obs_valid[k])
    uv = np.asarray(normalized_to_pixel(cam, jnp.asarray(obs, jnp.float32)), np.float64)

    # textured stamps must cover the BRIEF pattern radius (±15 px)
    r = int(3 * blob_sigma) if style == "gaussian" else max(int(3 * blob_sigma), 16)
    stamps = _landmark_stamps(obs.shape[0], r, blob_sigma, style)
    if stamp_of is not None:
        stamps = stamps[np.asarray(stamp_of)]
    for li in np.nonzero(vis)[0]:
        cx, cy = uv[li]
        if not (r < cx < w - r and r < cy < h - r):
            continue
        # SUBPIXEL placement: bilinear-shift the stamp by the fractional part
        # (integer-snapped stamps put ±0.5 px of temporally-correlated jitter
        # on every landmark — at f=160 that is 5× EuRoC's angular noise and
        # corrupts the VIO scale; stamps decay to ~0 at the border so the
        # wrap of np.roll is negligible)
        x0, y0 = int(np.floor(cx)) - r, int(np.floor(cy)) - r
        fx, fy = cx - np.floor(cx), cy - np.floor(cy)
        s = stamps[li]
        s = (1 - fx) * s + fx * np.roll(s, 1, axis=1)
        s = (1 - fy) * s + fy * np.roll(s, 0 + 1, axis=0)
        img[y0 : y0 + 2 * r + 1, x0 : x0 + 2 * r + 1] += s

    # line segments
    lobs = np.asarray(seq.line_obs[k])
    lvis = np.asarray(seq.line_obs_valid[k])
    sp = np.asarray(normalized_to_pixel(cam, jnp.asarray(lobs[:, 0:2], jnp.float32)), np.float64)
    ep = np.asarray(normalized_to_pixel(cam, jnp.asarray(lobs[:, 2:4], jnp.float32)), np.float64)
    ygrid, xgrid = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    for li in np.nonzero(lvis)[0]:
        p0, p1 = sp[li], ep[li]
        d = p1 - p0
        L = np.linalg.norm(d)
        if L < 5:
            continue
        u = d / L
        # restrict work to the segment's bounding box (+2 px)
        xlo = int(max(0, min(p0[0], p1[0]) - 2)); xhi = int(min(w, max(p0[0], p1[0]) + 3))
        ylo = int(max(0, min(p0[1], p1[1]) - 2)); yhi = int(min(h, max(p0[1], p1[1]) + 3))
        if xhi <= xlo or yhi <= ylo:
            continue
        px = xgrid[ylo:yhi, xlo:xhi] - p0[0]
        py = ygrid[ylo:yhi, xlo:xhi] - p0[1]
        t = px * u[0] + py * u[1]
        dist = np.abs(-px * u[1] + py * u[0])
        on = (t > 0) & (t < L)
        val = np.clip(1.4 - dist, 0.0, 1.0) * on
        img[ylo:yhi, xlo:xhi] += 0.45 * val.astype(np.float32)

    return np.clip(img, 0.0, 1.0)


def write_png_gray(path: str, img01: np.ndarray):
    """Minimal 8-bit grayscale PNG writer (filter 0)."""
    u8 = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    h, w = u8.shape
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))
    comp = zlib.compress(raw, 6)

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp) + chunk(b"IEND", b""))


def write_euroc_dataset(seq: SyntheticSequence, out_dir: str, cam, h: int, w: int,
                        max_frames: int | None = None, blob_sigma: float = 2.0,
                        style: str = "gaussian", stamp_of=None,
                        cam_stamp_offset: float = 0.0):
    """Write the simulator sequence as a miniature EuRoC ASL dataset.
    stamp_of: see render_frame (perceptual-aliasing scenario).
    cam_stamp_offset: shift the CLAIMED camera timestamps by this amount
    while the image content stays at the true sample time — emulates
    camera-IMU latency (an image stamped t was actually captured at
    t − cam_stamp_offset, i.e. td_true = −cam_stamp_offset for the
    estimator's `t_img + td` pairing convention)."""
    mav = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(mav, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)

    imu_t = np.asarray(seq.imu_t)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#t,wx,wy,wz,ax,ay,az\n")
        for i in range(len(imu_t)):
            g = np.asarray(seq.imu_gyr[i])
            a = np.asarray(seq.imu_acc[i])
            f.write(f"{int(imu_t[i]*1e9)},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")

    frame_t = np.asarray(seq.frame_t)
    n = len(frame_t) if max_frames is None else min(max_frames, len(frame_t))
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#t,filename\n")
        for k in range(n):
            ns = int((frame_t[k] + cam_stamp_offset) * 1e9)
            name = f"{ns}.png"
            img = render_frame(seq, k, cam, h, w, blob_sigma=blob_sigma,
                               style=style, stamp_of=stamp_of)
            write_png_gray(os.path.join(mav, "cam0", "data", name), img)
            f.write(f"{ns},{name}\n")

    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#t,px,py,pz,qw,qx,qy,qz,vx,vy,vz\n")
        for k in range(len(frame_t)):
            p = np.asarray(seq.gt_p[k]); q = np.asarray(seq.gt_q[k]); v = np.asarray(seq.gt_v[k])
            f.write(f"{int(frame_t[k]*1e9)},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]},{v[0]},{v[1]},{v[2]}\n")
    return out_dir


# Camera of the EuRoC-class recipe below: 752×480 pinhole, f = 460 px.
EUROC_CLASS_SHAPE = (480, 752)
EUROC_CLASS_INTRINSICS = (460.0, 460.0, 376.0, 240.0)


def _png_shape(path: str):
    """(h, w) from a PNG's IHDR chunk, None if the file is missing or not a PNG."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        return None
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _rendered_matches(out_dir: str, seed: int, n_frames: int) -> bool:
    """True when `out_dir` holds this recipe's render for `seed`/`n_frames`."""
    meta_path = os.path.join(out_dir, "meta.npz")
    if not os.path.exists(meta_path):
        return False
    with np.load(meta_path) as meta:
        if ("seed" not in meta.files or int(meta["seed"]) != seed
                or int(meta["n_frames"]) != n_frames):
            return False
    cam_dir = os.path.join(out_dir, "mav0", "cam0")
    try:
        with open(os.path.join(cam_dir, "data.csv")) as f:
            names = [ln.strip().split(",")[1] for ln in f if not ln.startswith("#")]
    except (OSError, IndexError):
        return False
    return (len(names) == n_frames
            and _png_shape(os.path.join(cam_dir, "data", names[0])) == EUROC_CLASS_SHAPE)


def write_euroc_class_dataset(out_dir: str, seed: int = 17, n_frames: int = 160):
    """Render the EuRoC-class sequence used by `bench.py` and `chip_smoke.py`
    into `out_dir` and return its metadata: R_bc, p_bc (body←camera
    extrinsic), gt_t, gt_p, seed, n_frames.

    752×480 pinhole (`EUROC_CLASS_SHAPE`, `EUROC_CLASS_INTRINSICS`) at
    20 Hz, 200 Hz IMU with EuRoC-class noise and bias, a textured
    500-landmark / 40-line world, 8 s (160 frames) by default. A render that
    is already in `out_dir` is reused only when its seed, frame count and
    first frame's shape match; otherwise it is replaced.
    Rendering is host work with small JAX calls; run it with the CPU as the
    default device to keep it off an accelerator."""
    from plslam.io import synthetic
    from plslam.ops.cameras import PinholeRadTan
    from plslam.utils.geometry import quat_to_rot

    meta_path = os.path.join(out_dir, "meta.npz")
    if not _rendered_matches(out_dir, seed, n_frames):
        # drop the other render, so no frame of it is left behind
        shutil.rmtree(os.path.join(out_dir, "mav0"), ignore_errors=True)
        if os.path.exists(meta_path):
            os.remove(meta_path)
        params = synthetic.TrajectoryParams(omega=0.4, z_omega=0.7,
                                            wiggle_amp=0.15, excite_amp=0.1)
        seq = synthetic.make_sequence(
            duration=n_frames / 20.0, n_points=500, n_lines=40, seed=seed,
            params=params, acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05,
            gyr_bias=0.002)
        cam = PinholeRadTan.create(*EUROC_CLASS_INTRINSICS)
        h, w = EUROC_CLASS_SHAPE
        os.makedirs(out_dir, exist_ok=True)
        write_euroc_dataset(seq, out_dir, cam, h, w, max_frames=n_frames,
                            blob_sigma=3.0, style="textured")
        tmp = meta_path + ".tmp.npz"
        np.savez(tmp, R_bc=np.array(quat_to_rot(seq.q_bc)),
                 p_bc=np.array(seq.p_bc), gt_t=np.asarray(seq.frame_t),
                 gt_p=np.asarray(seq.gt_p), seed=np.int64(seed),
                 n_frames=np.int64(n_frames))
        os.replace(tmp, meta_path)
    with np.load(meta_path) as meta:
        return {k: meta[k] for k in meta.files}
