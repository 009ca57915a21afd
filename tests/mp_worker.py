"""Worker for the multi-process CPU-mesh test (NOT collected by pytest).

Launched as: python mp_worker.py <pid> <nproc> <coordinator_addr>
with JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=4
— two of these form a 2-process × 4-device cluster, the stand-in for a
2-host GPU cluster (SURVEY.md §4/§5.8). Each process builds identical
data deterministically, shards it over the GLOBAL ('kf_part','lmk') mesh
(kf_part = the process axis), runs one
`mesh2d.partitioned_distributed_solve` step, and verifies its local
partition against a purely-local single-device `optimize_window`."""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    pid, nproc, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # optional: landmark-axis width (devices per process), default 4; a
    # 4th argv below 4 keeps the 4-core box un-oversubscribed for TIMING
    n_lmk = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    from plslam.parallel.multihost import global_mesh_2d, init_distributed

    assert init_distributed(addr, nproc, pid), "distributed init failed"
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == n_lmk * nproc, len(jax.devices())
    assert len(jax.local_devices()) == n_lmk

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from plslam.config import SolverConfig
    from plslam.io import synthetic
    from plslam.models import packing, solver as solver_mod
    from plslam.models.state import layout, retract
    from plslam.parallel import mesh2d

    cfg = SolverConfig(max_features=48, max_line_feats=8)
    lay = layout(cfg)
    mesh = global_mesh_2d(n_part=nproc, n_lmk=n_lmk)
    assert mesh.devices.shape == (nproc, n_lmk)
    # row p of the mesh must be process p's devices (consensus axis across processes)
    assert all(d.process_index == p for p in range(nproc) for d in mesh.devices[p])

    # identical data in every process (deterministic seed)
    seq = synthetic.make_sequence(duration=6.0, n_points=160, n_lines=16, seed=3)
    rng = np.random.default_rng(1)
    states, factors = [], []
    all_windows = ([0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30],
                   [30, 33, 36, 39, 42, 45, 48, 51, 54, 57, 60])
    for frames in all_windows[:nproc]:  # one partition per process (weak scaling)
        st_gt, f = packing.factors_from_synthetic(seq, frames, cfg, lay,
                                                  with_lines=False, dtype=jnp.float32)
        delta = np.zeros(lay.dim, np.float32)
        delta[6: lay.nw * 6] = rng.standard_normal((lay.nw - 1) * 6) * 0.01
        states.append(retract(st_gt, jnp.asarray(delta), lay))
        factors.append(f)
    stack_np = lambda items: jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)
    st_np, f_np = stack_np(states), stack_np(factors)

    def to_global(tree):
        def leaf(a):
            sh = NamedSharding(mesh, P("kf_part"))
            return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

        return jax.tree.map(leaf, tree)

    st_g, f_g = to_global(st_np), to_global(f_np)
    st_out, costs = mesh2d.partitioned_distributed_solve(st_g, f_g, lay, cfg, mesh,
                                                         num_iters=3)

    # local single-device reference for THIS process's partition
    st_ref, _ = solver_mod.optimize_window(
        jax.tree.map(lambda a: jnp.asarray(a[pid]), st_np),
        jax.tree.map(lambda a: jnp.asarray(a[pid]), f_np),
        lay, cfg, num_iters=3)
    local_p = np.asarray([s.data for s in st_out.p.addressable_shards][0])[0]
    local_inv = np.asarray([s.data for s in st_out.inv_depth.addressable_shards][0])[0]
    np.testing.assert_allclose(local_p, np.asarray(st_ref.p), atol=2e-3)
    np.testing.assert_allclose(local_inv, np.asarray(st_ref.inv_depth), atol=2e-3)
    local_cost = np.asarray([s.data for s in costs.addressable_shards][0])
    assert np.isfinite(local_cost).all()
    print(f"MP_OK pid={pid} cost={float(local_cost[0]):.6f}")

    if os.environ.get("PLSLAM_MP_TIME"):
        # weak-scaling TIMING row (VERDICT r4 weak #5): repeated solve calls
        # with per-call input jitter (no executable/buffer memoization), all
        # processes in lockstep through the collective
        import time

        def jittered(i):
            return jax.tree.map(
                lambda a: jax.make_array_from_callback(
                    a.shape, NamedSharding(mesh, P("kf_part")),
                    lambda idx: a[idx] + np.float32(1e-6 * i)
                    if a.dtype == np.float32 and a is st_np.p else a[idx]),
                st_np)

        n_warm, n_meas = 4, 10
        for i in range(n_warm):
            out = mesh2d.partitioned_distributed_solve(
                jittered(i), f_g, lay, cfg, mesh, num_iters=3)
            jax.block_until_ready(out)
        t0 = time.time()
        for i in range(n_meas):
            out = mesh2d.partitioned_distributed_solve(
                jittered(n_warm + i), f_g, lay, cfg, mesh, num_iters=3)
            jax.block_until_ready(out)
        dt = (time.time() - t0) / n_meas
        print(f"MP_TIME pid={pid} ms_per_solve={dt*1e3:.2f} iters=3")


if __name__ == "__main__":
    main()
