"""Multi-host bring-up: `jax.distributed.initialize` + global mesh helpers.

The reference's only "communication backend" was single-machine ROS TCPROS
pub/sub (SURVEY.md §5.8); the scaling plan replaces it with one global device
mesh whose collectives XLA compiles to NCCL. This module is the process-level
entry: call `init_distributed()` once per host process before building
meshes, then `global_mesh_2d()` for the ('kf_part','lmk') layout used by
`parallel/mesh2d.py` — consensus partitions ride the (slower, sparser)
network axis across hosts, landmark-shard psums ride NVLink among the
all-to-all-connected cards of one host.

Without a cluster configuration it stays single-process (multi-host behavior
is validated on forced CPU device meshes — tests/test_multihost.py,
SURVEY.md §4).
"""
from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize JAX's multi-process runtime (idempotent).

    With no arguments, reads the standard cluster env
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); with
    neither an address nor a process count it stays single-process. Returns
    True if a multi-process runtime is active after the call, False for
    plain single-process mode."""
    import jax

    # do NOT probe jax.process_count() here — it initializes the XLA backend,
    # after which jax.distributed.initialize() refuses to run
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else (
        int(os.environ["JAX_NUM_PROCESSES"]) if "JAX_NUM_PROCESSES" in os.environ else None)
    pid = process_id if process_id is not None else (
        int(os.environ["JAX_PROCESS_ID"]) if "JAX_PROCESS_ID" in os.environ else None)
    if addr is None and nproc is None:
        return False
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc, process_id=pid)
    return jax.process_count() > 1


def global_mesh_2d(n_part: int | None = None, n_lmk: int | None = None):
    """('kf_part','lmk') mesh over ALL processes' devices.

    Default shape: kf_part = number of hosts (consensus traffic is tiny and
    infrequent → the network between hosts), lmk = devices per host (psum of
    the reduced camera system every LM iteration → NVLink). Override either
    axis explicitly."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()  # global, ordered by (process, local index)
    if n_part is None:
        n_part = max(jax.process_count(), 1)
    if n_lmk is None:
        n_lmk = len(devs) // n_part
    if n_part * n_lmk != len(devs):
        raise ValueError(f"mesh {n_part}x{n_lmk} != {len(devs)} devices")
    grid = np.asarray(devs).reshape(n_part, n_lmk)
    return Mesh(grid, axis_names=("kf_part", "lmk"))
