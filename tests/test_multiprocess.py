"""True multi-PROCESS mesh validation (SURVEY.md §4/§5.8): two OS processes
× 4 forced-CPU devices each form a (2 process × 4 device) cluster via
`jax.distributed.initialize` — the stand-in for a 2-host GPU cluster. One
`mesh2d.partitioned_distributed_solve` step runs with the
consensus ('kf_part') axis mapped onto the PROCESS boundary — the
semantics the single-process 8-device dryrun cannot exercise."""
import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cpu_mesh_solve():
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no local ports available")
    addr = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), "2", addr],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MP_OK pid={pid}" in out, out[-2000:]
