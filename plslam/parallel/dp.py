"""Data-parallel (DP) sequence batching: many independent window problems as
one batched solve, optionally sharded over a device mesh.

The reference has no DP at all (SURVEY.md §2.6 — one rosbag, one estimator
process); its multi-sequence EuRoC evaluation is 11 serial runs. This
plan batches independent sequences/windows on the leading axis:

  * `batched_optimize_windows` — `jax.vmap` of the standard LM/Schur window
    solve: B problems, one compiled executable, batched linear algebra.
    This is the benchmarking/eval workhorse (11 EuRoC sequences = B=11).
  * with `mesh`, the batch axis is device-sharded (`NamedSharding` on the
    mesh's first axis — the `dp` dimension): XLA runs each shard's batch
    locally with ZERO collectives inside the solve (problems are
    independent), so DP scaling is embarrassingly parallel and the measured
    efficiency isolates compilation/dispatch overheads.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from plslam.config import SolverConfig
from plslam.models import residuals as res
from plslam.models import solver as solver_mod
from plslam.models.state import TangentLayout, WindowState
from plslam.utils.device import highest_matmul_precision


@partial(jax.jit, static_argnames=("lay", "cfg", "num_iters"))
def _vmapped_solve(states, factors, lay, cfg, num_iters):
    def one(s, f):
        st, stats = solver_mod.optimize_window(s, f, lay, cfg, num_iters=num_iters)
        return st, stats.cost

    return jax.vmap(one)(states, factors)


@highest_matmul_precision
def batched_optimize_windows(
    states: WindowState,  # stacked over leading batch axis B
    factors: res.WindowFactors,  # stacked over B
    lay: TangentLayout,
    cfg: SolverConfig,
    num_iters: int = 8,
    mesh=None,
):
    """Solve B independent windows at once; returns (states [B,...], costs [B]).

    `mesh`: shard the batch over the mesh's first axis (B must be divisible
    by the axis size for an even layout; XLA pads otherwise)."""
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        sh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        put = lambda t: jax.tree.map(lambda a: jax.device_put(a, sh), t)
        states = put(states)
        factors = put(factors)
    return _vmapped_solve(states, factors, lay, cfg, num_iters)


def stack_windows(pairs):
    """Stack [(state, factors), ...] along a new leading batch axis."""
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    factors = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in pairs])
    return states, factors
