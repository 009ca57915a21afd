"""Camera models: pinhole + radial-tangential distortion.

JAX equivalent of the reference's camodocal subset
(`camera_model/src/camera_models/PinholeCamera.cc`: `liftProjective`,
`spaceToPlane` — SURVEY.md §2.5; reconstruction, reference mount empty).

The camera is a NamedTuple of arrays → a jit-friendly pytree; all ops are
vectorised over arbitrary leading axes so the whole feature table projects in
one fused XLA call (no per-feature loops).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class PinholeRadTan(NamedTuple):
    """fx, fy, cx, cy intrinsics + k1,k2,p1,p2 radtan distortion."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=jnp.float32):
        return PinholeRadTan(*[jnp.asarray(v, dtype) for v in (fx, fy, cx, cy, k1, k2, p1, p2)])

    @staticmethod
    def euroc_cam0(dtype=jnp.float32):
        """EuRoC MAV cam0 intrinsics (SURVEY.md §A.8)."""
        return PinholeRadTan.create(
            458.654, 457.296, 367.215, 248.375,
            -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, dtype=dtype,
        )


def distort(cam: PinholeRadTan, mn):
    """Apply radtan distortion to normalized coords mn [...,2] -> distorted [...,2].

    (`PinholeCamera::distortion` in the reference lineage.)
    """
    x, y = mn[..., 0], mn[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * rad + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x2)
    dy = y * rad + cam.p1 * (r2 + 2.0 * y2) + 2.0 * cam.p2 * xy
    return mn + jnp.stack([dx, dy], axis=-1)


def _pinhole_project(cam: PinholeRadTan, p_c):
    """3D camera-frame points [...,3] -> pixel coords [...,2].

    (`PinholeCamera::spaceToPlane`.) Points behind the camera project through
    their (negative-z) normalized coords; callers mask on z > 0.
    """
    z = p_c[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, jnp.full_like(z, 1e-9), z)
    mn = p_c[..., 0:2] / z_safe
    md = distort(cam, mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


def _distort_jac(cam: PinholeRadTan, mn):
    """Analytic 2×2 jacobian of the distortion map (for Newton undistortion)."""
    x, y = mn[..., 0], mn[..., 1]
    r2 = x * x + y * y
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dr = cam.k1 + 2.0 * cam.k2 * r2  # d(rad)/d(r2)
    j00 = 1.0 + rad + 2.0 * x * x * dr + 2.0 * cam.p1 * y + 6.0 * cam.p2 * x
    j01 = 2.0 * x * y * dr + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    j10 = 2.0 * x * y * dr + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    j11 = 1.0 + rad + 2.0 * y * y * dr + 6.0 * cam.p1 * y + 2.0 * cam.p2 * x
    return j00, j01, j10, j11


def _pinhole_lift(cam: PinholeRadTan, uv, iters: int = 5):
    """Pixel coords [...,2] -> undistorted normalized coords [...,2].

    (`PinholeCamera::liftProjective`.) The reference used a fixed-point
    recursive approximation; with EuRoC-strength distortion that contracts
    slowly near the image border, so we run a fixed-count batched Newton
    iteration (closed-form 2×2 solve, quadratic convergence, branch-free —
    one fused XLA graph over the whole batch)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    md = jnp.stack([mx, my], axis=-1)
    mn = md
    for _ in range(iters):
        f = distort(cam, mn) - md
        j00, j01, j10, j11 = _distort_jac(cam, mn)
        det = j00 * j11 - j01 * j10
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        dx = (j11 * f[..., 0] - j01 * f[..., 1]) / det
        dy = (-j10 * f[..., 0] + j00 * f[..., 1]) / det
        mn = mn - jnp.stack([dx, dy], axis=-1)
    return mn


def _pinhole_normalized_to_pixel(cam: PinholeRadTan, mn):
    md = distort(cam, mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt fisheye (`EquidistantCamera.cc` in the camodocal subset:
    θ-polynomial r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k2: jnp.ndarray
    k3: jnp.ndarray
    k4: jnp.ndarray
    k5: jnp.ndarray

    @staticmethod
    def create(fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0, dtype=jnp.float32):
        return EquidistantCamera(*[jnp.asarray(v, dtype) for v in (fx, fy, cx, cy, k2, k3, k4, k5)])


def equi_project(cam: EquidistantCamera, p_c):
    """3D camera point -> pixel (`EquidistantCamera::spaceToPlane`)."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    rd = theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5))))
    r_safe = jnp.maximum(r, 1e-12)
    u = cam.fx * rd * x / r_safe + cam.cx
    v = cam.fy * rd * y / r_safe + cam.cy
    return jnp.stack([u, v], axis=-1)


def equi_lift(cam: EquidistantCamera, uv, iters: int = 8):
    """Pixel -> undistorted normalized coords (`liftProjective`): Newton on
    the θ-polynomial, batched + branch-free."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    rd = jnp.sqrt(mx * mx + my * my)
    theta = rd
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5)))) - rd
        fp = 1.0 + t2 * (3 * cam.k2 + t2 * (5 * cam.k3 + t2 * (7 * cam.k4 + t2 * 9 * cam.k5)))
        theta = theta - f / jnp.maximum(fp, 1e-6)
    scale = jnp.tan(theta) / jnp.maximum(rd, 1e-12)
    return jnp.stack([mx * scale, my * scale], axis=-1)


class MeiCamera(NamedTuple):
    """MEI / unified omnidirectional model (`CataCamera.cc`): unit-sphere
    projection with mirror parameter ξ + radtan distortion."""

    xi: jnp.ndarray
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray

    @staticmethod
    def create(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=jnp.float32):
        return MeiCamera(*[jnp.asarray(v, dtype) for v in (xi, fx, fy, cx, cy, k1, k2, p1, p2)])


def mei_project(cam: MeiCamera, p_c):
    """(`CataCamera::spaceToPlane`)."""
    n = jnp.linalg.norm(p_c, axis=-1, keepdims=True)
    s = p_c / jnp.maximum(n, 1e-12)  # unit sphere
    denom = jnp.maximum(s[..., 2:3] + cam.xi, 1e-6)
    mn = s[..., 0:2] / denom
    dcam = PinholeRadTan(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2)
    md = distort(dcam, mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


class ScaramuzzaCamera(NamedTuple):
    """Scaramuzza omnidirectional model (`ScaramuzzaCamera.cc`): the camera
    ray's z-component is a polynomial of the image radius ρ:
    z(ρ) = a0 + a2 ρ² + a3 ρ³ + a4 ρ⁴ (cam2world); world2cam inverts it by
    batched Newton. Affine (c, d, e) + center (cx, cy) map sensor↔image."""

    a0: jnp.ndarray
    a2: jnp.ndarray
    a3: jnp.ndarray
    a4: jnp.ndarray
    c: jnp.ndarray
    d: jnp.ndarray
    e: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def create(a0, a2, a3, a4, c=1.0, d=0.0, e=0.0, cx=0.0, cy=0.0, dtype=jnp.float32):
        return ScaramuzzaCamera(*[jnp.asarray(v, dtype) for v in (a0, a2, a3, a4, c, d, e, cx, cy)])


def _scara_poly(cam: ScaramuzzaCamera, rho):
    r2 = rho * rho
    return cam.a0 + r2 * (cam.a2 + rho * (cam.a3 + rho * cam.a4))


def _scara_dpoly(cam: ScaramuzzaCamera, rho):
    return rho * (2.0 * cam.a2 + rho * (3.0 * cam.a3 + rho * 4.0 * cam.a4))


def scara_lift(cam: ScaramuzzaCamera, uv):
    """Pixel -> normalized z=1 coords (`ScaramuzzaCamera::liftProjective`)."""
    # affine inverse
    up = uv[..., 0] - cam.cx
    vp = uv[..., 1] - cam.cy
    det = cam.c - cam.d * cam.e
    x = (up - cam.d * vp) / det
    y = (-cam.e * up + cam.c * vp) / det
    rho = jnp.sqrt(x * x + y * y)
    z = _scara_poly(cam, rho)
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return jnp.stack([x / z_safe, y / z_safe], axis=-1)


def scara_project(cam: ScaramuzzaCamera, p_c, iters: int = 12):
    """3D camera point -> pixel (`ScaramuzzaCamera::spaceToPlane`): solve
    ρ with Newton on  z(ρ)·r_xy − ρ·z_3d = 0  (ray alignment)."""
    x, y, z3 = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    r_xy = jnp.sqrt(x * x + y * y)
    r_safe = jnp.maximum(r_xy, 1e-12)
    rho = jnp.full_like(r_xy, 100.0)
    for _ in range(iters):
        g = _scara_poly(cam, rho) * r_xy - rho * z3
        gp = _scara_dpoly(cam, rho) * r_xy - z3
        rho = rho - g / jnp.where(jnp.abs(gp) < 1e-9, 1e-9, gp)
    sx = x / r_safe * rho
    sy = y / r_safe * rho
    u = sx * cam.c + sy * cam.d + cam.cx
    v = sx * cam.e + sy + cam.cy
    return jnp.stack([u, v], axis=-1)


def mei_lift(cam: MeiCamera, uv, iters: int = 8):
    """(`CataCamera::liftProjective`): undistort (Newton on radtan), then
    invert the sphere projection to a normalized z=1 ray."""
    dcam = PinholeRadTan(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2)
    mn = _pinhole_lift(dcam, uv, iters)
    r2 = jnp.sum(mn * mn, axis=-1, keepdims=True)
    xi = cam.xi
    # sphere point: solve for the ray through (mn, 1) intersecting the sphere
    disc = jnp.maximum(1.0 + (1.0 - xi * xi) * r2, 0.0)
    lam = (xi + jnp.sqrt(disc)) / (1.0 + r2)
    z = lam - xi
    xy = lam * mn
    return xy / jnp.maximum(z, 1e-6)


# --------------------------------------------------------------------------
# Generic camera dispatch + factory (the reference's `CameraFactory`
# semantics — `camera_model/src/camera_models/CameraFactory.cc` lineage,
# SURVEY.md §2.5: every node constructs its camera from `model_type` and
# calls `liftProjective`/`spaceToPlane` through the base-class interface).
# Dispatch is isinstance-on-NamedTuple at TRACE time — zero runtime cost
# inside jit; a different camera class is a different pytree treedef, so
# cached programs specialize per model automatically.
# --------------------------------------------------------------------------

def project(cam, p_c):
    """3D camera-frame points [...,3] -> pixel coords [...,2] (`spaceToPlane`)."""
    if isinstance(cam, EquidistantCamera):
        return equi_project(cam, p_c)
    if isinstance(cam, MeiCamera):
        return mei_project(cam, p_c)
    if isinstance(cam, ScaramuzzaCamera):
        return scara_project(cam, p_c)
    return _pinhole_project(cam, p_c)


def lift(cam, uv, iters: int = 5):
    """Pixel coords [...,2] -> normalized z=1 coords [...,2] (`liftProjective`)."""
    if isinstance(cam, EquidistantCamera):
        return equi_lift(cam, uv, max(iters, 8))
    if isinstance(cam, MeiCamera):
        return mei_lift(cam, uv, max(iters, 8))
    if isinstance(cam, ScaramuzzaCamera):
        return scara_lift(cam, uv)
    return _pinhole_lift(cam, uv, iters)


def pixel_to_normalized(cam, uv, iters: int = 8):
    return lift(cam, uv, iters)


def normalized_to_pixel(cam, mn):
    """Normalized z=1 coords -> pixel: project the ray (x, y, 1)."""
    if isinstance(cam, PinholeRadTan):
        return _pinhole_normalized_to_pixel(cam, mn)
    ones = jnp.ones_like(mn[..., :1])
    return project(cam, jnp.concatenate([mn, ones], axis=-1))


def make_camera(cc, dtype=jnp.float32):
    """Build the camera model named by `CameraConfig.model_type` (the
    reference's `CameraFactory::generateCameraFromYamlFile`).

    Accepted names (case-insensitive): PINHOLE; KANNALA_BRANDT / EQUIDISTANT /
    FISHEYE; MEI / CATA; SCARAMUZZA / OCAM. Parameter mapping documented per
    branch (the camodocal YAML key set → CameraConfig fields, config.py)."""
    mt = str(cc.model_type).upper()
    if mt in ("PINHOLE", ""):
        return PinholeRadTan.create(cc.fx, cc.fy, cc.cx, cc.cy,
                                    cc.k1, cc.k2, cc.p1, cc.p2, dtype=dtype)
    if mt in ("KANNALA_BRANDT", "EQUIDISTANT", "FISHEYE"):
        # camodocal projection_parameters {k2..k5, mu, mv, u0, v0} →
        # fields (k1→k2, k2→k3, k3→k4, k4 unused… see config.from_yaml):
        # CameraConfig carries them as kb2..kb5 + fx/fy/cx/cy (= mu/mv/u0/v0)
        return EquidistantCamera.create(cc.fx, cc.fy, cc.cx, cc.cy,
                                        cc.kb2, cc.kb3, cc.kb4, cc.kb5, dtype=dtype)
    if mt in ("MEI", "CATA"):
        # mirror_parameters {xi} + projection {gamma1, gamma2, u0, v0} +
        # distortion {k1, k2, p1, p2}
        return MeiCamera.create(cc.xi, cc.fx, cc.fy, cc.cx, cc.cy,
                                cc.k1, cc.k2, cc.p1, cc.p2, dtype=dtype)
    if mt in ("SCARAMUZZA", "OCAM"):
        # poly_parameters {p0, p2, p3, p4} + affine_parameters {ac, ad, ae} +
        # center (cx, cy)
        return ScaramuzzaCamera.create(cc.a0, cc.a2, cc.a3, cc.a4,
                                       cc.ac, cc.ad, cc.ae, cc.cx, cc.cy, dtype=dtype)
    raise ValueError(f"unknown camera model_type {cc.model_type!r}")


# fixed-width (kind, params[9]) serialization for pose-graph persistence
_CAM_KINDS = ("PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA")


def cam_to_params(cam):
    """-> (kind_index, float64[9]) for npz storage (pose_graph save)."""
    import numpy as np

    vals = [float(v) for v in cam]
    vals += [0.0] * (9 - len(vals))
    if isinstance(cam, EquidistantCamera):
        k = 1
    elif isinstance(cam, MeiCamera):
        k = 2
    elif isinstance(cam, ScaramuzzaCamera):
        k = 3
    else:
        k = 0
    return k, np.asarray(vals, np.float64)


def cam_from_params(kind, params, dtype=jnp.float32):
    cls = (PinholeRadTan, EquidistantCamera, MeiCamera, ScaramuzzaCamera)[int(kind)]
    n = len(cls._fields)
    return cls(*[jnp.asarray(v, dtype) for v in params[:n]])
