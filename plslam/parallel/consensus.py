"""Keyframe-partitioned large-window BA with boundary-pose consensus.

The reference cannot grow its window: the Ceres solve is O(window³) and
single-threaded (SURVEY.md §5.7). This module is the accelerator scaling
answer along the *keyframe* axis (the SLAM analog of sequence parallelism),
complementing the landmark sharding of `distributed_ba`:

  * a long trajectory of N keyframes splits into P overlapping partitions of
    window_size+1 frames (1-frame overlap at each boundary),
  * ALL partitions solve in parallel as one batched `vmap` of the standard
    LM/Schur window solver — one compiled kernel, P problems, batched,
  * between rounds, partitions are chain-aligned through their shared
    boundary frame (a cost-free gauge transform) and the two copies of each
    boundary state are consensus-averaged (overlapping-Schwarz / simplified
    ADMM without duals — exact agreement at convergence on consistent data),
  * a few outer rounds reach the joint optimum; wall-clock scales with the
    slowest partition, not the trajectory length.

Over a device mesh the same structure runs with partitions sharded on a
`kf_part` axis (vmap → shard_map is mechanical); on one chip the batched vmap
already uses the hardware well.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models import solver as solver_mod
from plslam.models.state import TangentLayout, WindowState
from plslam.ops.lines import plucker_transform
from plslam.utils.geometry import (
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    ypr_to_rot,
)
from plslam.utils.device import highest_matmul_precision


def partition_frames(n_frames: int, window: int):
    """Overlapping partitions: [0..W], [W..2W], … (shared boundary frame)."""
    parts = []
    start = 0
    while start + window < n_frames:
        parts.append(list(range(start, start + window + 1)))
        start += window
    if parts and parts[-1][-1] != n_frames - 1:
        parts.append(list(range(n_frames - window - 1, n_frames)))
    return parts


def _yaw_t_align(p_ref, q_ref, p_src, q_src):
    """Gauge transform (Rz, t) taking (p_src,q_src) onto (p_ref,q_ref)."""
    dyaw = rot_to_ypr(quat_to_rot(q_ref))[0] - rot_to_ypr(quat_to_rot(q_src))[0]
    z = jnp.zeros_like(dyaw)
    Rz = ypr_to_rot(jnp.stack([dyaw, z, z]))
    t = p_ref - Rz @ p_src
    return Rz, t


def _apply_gauge(st: WindowState, Rz, t) -> WindowState:
    q_z = rot_to_quat(Rz)
    return st._replace(
        p=st.p @ Rz.T + t,
        q=quat_mul(jnp.broadcast_to(q_z, st.q.shape), st.q),
        v=st.v @ Rz.T,
        line=plucker_transform(st.line, Rz, t),
    )


@highest_matmul_precision
def consensus_solve(
    part_states: WindowState,  # stacked over leading axis P
    part_factors: res.WindowFactors,  # stacked over P
    lay: TangentLayout,
    cfg: SolverConfig,
    rounds: int = 3,
    num_iters: int = 8,
    mesh=None,
    solve_fn=None,
):
    """Solve P partitioned windows to a consistent trajectory.

    With `mesh`, the partition axis is sharded across its first axis (the
    `kf_part` dimension of the scaling plan): the batched solve then runs
    SPMD — each device solves its partitions, XLA inserts no collectives
    inside the solve (partitions are independent; only the tiny host-side
    boundary consensus crosses partitions).

    `solve_fn(part_states, part_factors) -> part_states` replaces the default
    batched single-device solve — `parallel.mesh2d` plugs in the
    landmark-sharded distributed solve here to run BOTH scaling axes on one
    ('kf_part', 'lmk') mesh.

    NOTE: the chain alignment assumes partition k's frame 0 IS partition
    k−1's frame nw−1 (one shared boundary frame) — i.e. n_frames must be
    P·window + 1. `partition_frames`' ragged tail partition (overlap > 1)
    violates this; trim the history to full partitions first (see
    `runner.run_synthetic_large_window`).

    Returns the stacked partition states after consensus; use
    `stitch_trajectory` to extract the global keyframe poses."""
    P = part_states.p.shape[0]

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        sh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        put = lambda t: jax.tree.map(lambda a: jax.device_put(a, sh), t)
        part_states = put(part_states)
        part_factors = put(part_factors)

    solve_all = solve_fn if solve_fn is not None else jax.vmap(
        lambda s, f: solver_mod.optimize_window(s, f, lay, cfg, num_iters=num_iters)[0]
    )

    st = part_states
    for _ in range(rounds):
        st = solve_all(st, part_factors)
        # chain-align partitions through boundary frames, then average the
        # two copies of each boundary state (host loop over P — tiny)
        parts = [jax.tree.map(lambda a: a[k], st) for k in range(P)]
        for k in range(1, P):
            Rz, t = _yaw_t_align(
                parts[k - 1].p[lay.nw - 1], parts[k - 1].q[lay.nw - 1],
                parts[k].p[0], parts[k].q[0],
            )
            parts[k] = _apply_gauge(parts[k], Rz, t)
            # consensus on the shared frame (state average; quaternion renorm)
            p_avg = 0.5 * (parts[k - 1].p[lay.nw - 1] + parts[k].p[0])
            q_avg = quat_normalize(0.5 * (parts[k - 1].q[lay.nw - 1] + parts[k].q[0]))
            v_avg = 0.5 * (parts[k - 1].v[lay.nw - 1] + parts[k].v[0])
            ba_avg = 0.5 * (parts[k - 1].ba[lay.nw - 1] + parts[k].ba[0])
            bg_avg = 0.5 * (parts[k - 1].bg[lay.nw - 1] + parts[k].bg[0])
            parts[k - 1] = parts[k - 1]._replace(
                p=parts[k - 1].p.at[lay.nw - 1].set(p_avg),
                q=parts[k - 1].q.at[lay.nw - 1].set(q_avg),
                v=parts[k - 1].v.at[lay.nw - 1].set(v_avg),
                ba=parts[k - 1].ba.at[lay.nw - 1].set(ba_avg),
                bg=parts[k - 1].bg.at[lay.nw - 1].set(bg_avg),
            )
            parts[k] = parts[k]._replace(
                p=parts[k].p.at[0].set(p_avg),
                q=parts[k].q.at[0].set(q_avg),
                v=parts[k].v.at[0].set(v_avg),
                ba=parts[k].ba.at[0].set(ba_avg),
                bg=parts[k].bg.at[0].set(bg_avg),
            )
        st = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    return st


def stitch_trajectory(part_states: WindowState, parts: list[list[int]], n_frames: int):
    """Global (p [N,3], q [N,4]) from partition states (boundaries averaged)."""
    P = len(parts)
    p_out = np.zeros((n_frames, 3))
    q_out = np.tile([1.0, 0, 0, 0], (n_frames, 1))
    for k in range(P):
        pk = np.asarray(part_states.p[k])
        qk = np.asarray(part_states.q[k])
        for j, fr in enumerate(parts[k]):
            p_out[fr] = pk[j]
            q_out[fr] = qk[j]
    return p_out, q_out
