"""Sliding-window state as a fixed-shape pytree + its manifold structure.

JAX equivalent of the reference estimator's raw state arrays
(`Estimator::Ps/Rs/Vs/Bas/Bgs[11]`, `tic/ric`, `td`, `para_Feature`,
`para_LineFeature` — `vins_estimator/src/estimator.cpp`,
`vector2double()/double2vector()`; SURVEY.md §2.3). Where the reference
shuttled Eigen state into flat `double[7]`/`double[9]` parameter blocks for
Ceres, here the window state *is* the optimisation variable: a NamedTuple of
arrays, with one global tangent vector δ ∈ R^D and a `retract` map applying
the same local parameterisations (`PoseLocalParameterization`,
`LineOrthParameterization`) the reference registered with Ceres.

Tangent layout (offsets static per config):
  [ pose δ(p,θ) 11×6 | speed/bias 11×9 | extrinsic 6 | td 1 |
    inverse depths MAX_F | line-orth MAX_L×4 ]
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from plslam.config import SolverConfig
from plslam.ops.lines import orth_retract
from plslam.utils.geometry import quat_box_minus, quat_box_plus, quat_rotate


class WindowState(NamedTuple):
    p: jnp.ndarray  # [NW,3] body position in world
    q: jnp.ndarray  # [NW,4] body orientation (wxyz), R_wb
    v: jnp.ndarray  # [NW,3] velocity in world
    ba: jnp.ndarray  # [NW,3] accel bias
    bg: jnp.ndarray  # [NW,3] gyro bias
    p_bc: jnp.ndarray  # [3] extrinsic: body_T_cam translation
    q_bc: jnp.ndarray  # [4] extrinsic rotation
    td: jnp.ndarray  # [] camera-IMU time offset
    relo_p: jnp.ndarray  # [3] relocalization pose (old keyframe body in world)
    relo_q: jnp.ndarray  # [4]  — `Estimator::setReloFrame`'s relo_Pose block
    inv_depth: jnp.ndarray  # [MAX_F] inverse depth in first observing frame
    line: jnp.ndarray  # [MAX_L,6] world-frame Plücker lines


class TangentLayout(NamedTuple):
    nw: int
    max_f: int
    max_l: int
    off_pose: int
    off_sb: int
    off_ext: int
    off_td: int
    off_relo: int
    off_depth: int
    off_line: int
    dim: int
    dim_cam: int  # pose-side dim (poses+sb+ext+td+relo) — the Schur "camera" block


def layout(cfg: SolverConfig) -> TangentLayout:
    nw = cfg.window_size + 1
    off_pose = 0
    off_sb = off_pose + nw * 6
    off_ext = off_sb + nw * 9
    off_td = off_ext + 6
    off_relo = off_td + 1
    off_depth = off_relo + 6
    off_line = off_depth + cfg.max_features
    dim = off_line + cfg.max_line_feats * 4
    return TangentLayout(
        nw, cfg.max_features, cfg.max_line_feats,
        off_pose, off_sb, off_ext, off_td, off_relo, off_depth, off_line, dim, off_depth,
    )


def zero_state(cfg: SolverConfig, dtype=jnp.float32) -> WindowState:
    nw = cfg.window_size + 1
    q0 = jnp.zeros((nw, 4), dtype).at[:, 0].set(1.0)
    return WindowState(
        p=jnp.zeros((nw, 3), dtype),
        q=q0,
        v=jnp.zeros((nw, 3), dtype),
        ba=jnp.zeros((nw, 3), dtype),
        bg=jnp.zeros((nw, 3), dtype),
        p_bc=jnp.zeros(3, dtype),
        q_bc=jnp.asarray([1.0, 0, 0, 0], dtype),
        td=jnp.zeros((), dtype),
        relo_p=jnp.zeros(3, dtype),
        relo_q=jnp.asarray([1.0, 0, 0, 0], dtype),
        inv_depth=jnp.full((cfg.max_features,), 0.2, dtype),
        line=_default_lines(cfg.max_line_feats, dtype),
    )


def _default_lines(max_l, dtype):
    # benign default: line x=5,z-axis-direction → n=(0,0,?)… keep well-conditioned
    L = jnp.zeros((max_l, 6), dtype)
    L = L.at[:, 1].set(5.0)  # n = (0,5,0)
    L = L.at[:, 5].set(1.0)  # v = (0,0,1)
    return L


def retract(state: WindowState, delta: jnp.ndarray, lay: TangentLayout) -> WindowState:
    """x ⊞ δ with the reference's local parameterisations."""
    nw = lay.nw
    dp = delta[lay.off_pose : lay.off_sb].reshape(nw, 6)
    dsb = delta[lay.off_sb : lay.off_ext].reshape(nw, 9)
    dext = delta[lay.off_ext : lay.off_td]
    dtd = delta[lay.off_td]
    drelo = delta[lay.off_relo : lay.off_depth]
    ddep = delta[lay.off_depth : lay.off_line]
    dline = delta[lay.off_line :].reshape(lay.max_l, 4)
    return WindowState(
        p=state.p + dp[:, 0:3],
        q=quat_box_plus(state.q, dp[:, 3:6]),
        v=state.v + dsb[:, 0:3],
        ba=state.ba + dsb[:, 3:6],
        bg=state.bg + dsb[:, 6:9],
        p_bc=state.p_bc + dext[0:3],
        q_bc=quat_box_plus(state.q_bc, dext[3:6]),
        td=state.td + dtd,
        relo_p=state.relo_p + drelo[0:3],
        relo_q=quat_box_plus(state.relo_q, drelo[3:6]),
        inv_depth=state.inv_depth + ddep,
        line=orth_retract(state.line, dline),
    )


def box_minus_cam(state: WindowState, state0: WindowState, lay: TangentLayout) -> jnp.ndarray:
    """(x ⊟ x0) restricted to the camera-side dims (poses, speed/bias, ext, td)
    — the prior residual's argument (`MarginalizationFactor::Evaluate`)."""
    dp = state.p - state0.p
    dth = quat_box_minus(state.q, state0.q)
    pose = jnp.concatenate([dp, dth], axis=-1).reshape(-1)
    sb = jnp.concatenate(
        [state.v - state0.v, state.ba - state0.ba, state.bg - state0.bg], axis=-1
    ).reshape(-1)
    ext = jnp.concatenate([state.p_bc - state0.p_bc, quat_box_minus(state.q_bc, state0.q_bc)])
    td = (state.td - state0.td)[None]
    relo = jnp.concatenate([state.relo_p - state0.relo_p, quat_box_minus(state.relo_q, state0.relo_q)])
    return jnp.concatenate([pose, sb, ext, td, relo])


def cam_poses(state: WindowState):
    """World_T_cam for each window frame: R_wc = R_wb R_bc, p_wc = p + R_wb p_bc."""
    from plslam.utils.geometry import quat_mul

    q_wc = quat_mul(state.q, state.q_bc[None, :])
    p_wc = state.p + quat_rotate(state.q, jnp.broadcast_to(state.p_bc, state.p.shape))
    return p_wc, q_wc
