"""Two-axis device mesh: keyframe partitions × landmark shards.

SURVEY.md §5.7/§5.8 plans one global mesh with logical axes
('kf_part', 'lmk_shard'). `consensus.py` scales the keyframe axis (partition
-parallel window solves + boundary consensus) and `distributed_ba.py` scales
the landmark axis (sharded Schur reduction with a psum'd camera system); this
module composes them on ONE 2-D mesh so both axes run in the same SPMD
program — each mesh row owns a keyframe partition, each column a landmark
shard of that partition:

  * within a row: `psum` over 'lmk' reduces the DC×DC camera system and
    `all_gather` over 'lmk' rebuilds the landmark vector — exactly the 1-D
    distributed-BA schedule (shared `make_lm_iter`),
  * across rows: partitions are independent inside the solve (no collective
    touches 'kf_part'); only the tiny host-side boundary consensus between
    rounds couples them (the axis that tolerates a slow link — boundary
    state is ~30 floats per partition pair).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models.state import TangentLayout, WindowState
from plslam.parallel import consensus
from plslam.parallel import distributed_ba as dba
from plslam.utils.device import highest_matmul_precision


def make_mesh2d(n_part: int, n_lmk: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_part * n_lmk, "not enough devices for the 2-D mesh"
    grid = np.asarray(devices[: n_part * n_lmk]).reshape(n_part, n_lmk)
    return Mesh(grid, axis_names=("kf_part", "lmk"))


@partial(jax.jit, static_argnames=("lay", "cfg", "mesh", "num_iters"))
@highest_matmul_precision
def partitioned_distributed_solve(
    part_states: WindowState,  # stacked over leading P axis
    part_factors: res.WindowFactors,  # stacked over P
    lay: TangentLayout,
    cfg: SolverConfig,
    mesh: Mesh,
    num_iters: int = 8,
):
    """One round of P simultaneous landmark-sharded window solves on a
    ('kf_part','lmk') mesh. Returns (part_states', costs [P])."""
    L = mesh.shape["lmk"]
    MF, ML = lay.max_f, lay.max_l
    assert MF % L == 0 and ML % L == 0, "capacities must divide the lmk axis"
    mf_s, ml_s = MF // L, ML // L
    focal = cfg.focal_length
    dtype = part_states.p.dtype

    st_specs = WindowState(*[P("kf_part") for _ in WindowState._fields])
    f_specs = res.WindowFactors(*[P("kf_part") for _ in res.WindowFactors._fields])

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(st_specs, f_specs),
        out_specs=(st_specs, P("kf_part")),
        check_vma=False,
    )
    def solve(st_p, f_p):
        # local partition (leading axis 1 after kf_part sharding); landmark
        # arrays arrive replicated along 'lmk' — each column slices its shard
        st = jax.tree.map(lambda a: a[0], st_p)
        f = jax.tree.map(lambda a: a[0], f_p)
        li = jax.lax.axis_index("lmk")
        slf = lambda a, s: jax.lax.dynamic_slice_in_dim(a, li * s, s, axis=0)
        pt = (slf(f.pt_obs, mf_s), slf(f.pt_vel, mf_s), slf(f.pt_mask, mf_s),
              slf(f.pt_start, mf_s), slf(f.pt_valid, mf_s))
        ln = (slf(f.ln_obs, ml_s), slf(f.ln_mask, ml_s), slf(f.ln_valid, ml_s))
        inv_d0 = slf(st.inv_depth, mf_s)
        line0 = slf(st.line, ml_s)
        st_cam = dba._strip(st)

        def cam_residual(s):
            r_imu = res.imu_residuals(s, f).reshape(-1)
            r_pr = res.prior_residual(s, f, lay)
            return jnp.concatenate([r_pr, r_imu])

        lm_iter = dba.make_lm_iter("lmk", lay, cfg, focal, mf_s, ml_s, dtype,
                                   pt, ln, cam_residual)
        lam0 = jnp.asarray(cfg.lm_lambda_init, dtype)
        init = (st_cam, inv_d0, line0, lam0, jnp.zeros((), dtype))
        (st_cam_out, inv_out, line_out, _, cost), _ = jax.lax.scan(
            lm_iter, init, None, length=num_iters)

        # rebuild the full landmark vectors within the row
        inv_full = jax.lax.all_gather(inv_out, "lmk").reshape(-1)[:MF]
        line_full = jax.lax.all_gather(line_out, "lmk").reshape(-1, 6)[:ML]
        st_out = st_cam_out._replace(inv_depth=inv_full, line=line_full)
        return jax.tree.map(lambda a: a[None], st_out), cost[None]

    st_out, costs = solve(part_states, part_factors)
    # per-partition gauge repair against the pre-solve states
    st_out = jax.vmap(dba.reanchor)(st_out, part_states)
    return st_out, costs


def consensus_distributed_solve(
    part_states, part_factors, lay, cfg, mesh, rounds: int = 2, num_iters: int = 4
):
    """Both scaling axes end-to-end: landmark-sharded solves per partition
    (SPMD over the full 2-D mesh) + boundary-pose consensus between rounds."""
    return consensus.consensus_solve(
        part_states, part_factors, lay, cfg, rounds=rounds, num_iters=num_iters,
        solve_fn=lambda st, f: partitioned_distributed_solve(
            st, f, lay, cfg, mesh, num_iters=num_iters)[0],
    )
