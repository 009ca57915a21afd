"""Where the time of a warm `run_euroc` pass goes, from one `jax.profiler`
trace per pass, at `chip_smoke.py`'s configuration (752×480, 150 corners,
192/64 slots, lines and loop closure on).

    python scripts/trace_e2e.py [--out chiprun_out/trace_e2e] [--burst 0 16]

For each pass (streaming `burst=0`, offline replay `burst=16`): one pass to
compile, one untraced pass for the wall, one traced pass. The trace is
reduced to

  - device busy time: the union of kernel intervals on the GPU's stream
    lines, and its share of the traced wall;
  - kernels per published frame; device time and kernel count by XLA module;
  - host time by event name, as SELF time (an event's duration less that of
    the events nested directly inside it, per thread) and as inclusive time
    counted at the outermost occurrence of a name on a thread's stack.

The Python tracer is on (it names the host functions), so the traced wall
is longer than the untraced one; both are written. Results go to
`<out>/trace_e2e.json` (a relative `--out` is taken from the repo root), one
summary line per pass to stdout. The raw traces are deleted unless
`--keep-traces`. Needs a GPU."""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_ns(spans) -> int:
    """Length of the union of [start, end) intervals."""
    busy, end = 0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def host_times(events):
    """(self, inclusive) time by name of ONE thread's nested events, given as
    (name, start_ns, duration_ns). Self time subtracts the events directly
    inside; inclusive time counts a name only where no enclosing event has
    the same name, so recursion is not counted twice."""
    self_t, incl_t = collections.Counter(), collections.Counter()
    stack = []  # [name, end_ns, self_ns]

    def pop():
        name, _, slf = stack.pop()
        self_t[name] += slf

    for name, start, dur in sorted(events, key=lambda e: (e[1], -e[2])):
        while stack and stack[-1][1] <= start:
            pop()
        end = start + dur
        if stack:
            stack[-1][2] -= min(end, stack[-1][1]) - start
        if all(s[0] != name for s in stack):
            incl_t[name] += dur
        stack.append([name, end, dur])
    while stack:
        pop()
    return self_t, incl_t


def reduce_trace(path: str, n_published: int, wall_s: float, top: int = 20) -> dict:
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    spans, by_mod, n_mod = [], collections.Counter(), collections.Counter()
    self_t, incl_t = collections.Counter(), collections.Counter()
    for pl in pd.planes:
        if pl.name.startswith("/device:GPU"):
            for ln in pl.lines:
                if not ln.name.startswith("Stream"):
                    continue
                for e in ln.events:
                    spans.append((e.start_ns, e.end_ns))
                    m = dict(e.stats).get("hlo_module", "?")
                    by_mod[m] += e.duration_ns
                    n_mod[m] += 1
        elif pl.name == "/host:CPU":
            for ln in pl.lines:
                s, i = host_times([(e.name, e.start_ns, e.duration_ns) for e in ln.events])
                self_t.update(s)
                incl_t.update(i)
    busy = busy_ns(spans) / 1e9
    return {
        "traced_wall_s": wall_s, "n_published": n_published,
        "device_busy_s": busy, "device_busy_share": busy / wall_s,
        "kernels": len(spans), "kernels_per_published_frame": len(spans) / n_published,
        "device_ms_by_module": [(m, v / 1e6, n_mod[m]) for m, v in by_mod.most_common(top)],
        "host_self_ms": [(m, v / 1e6) for m, v in self_t.most_common(top)],
        "host_inclusive_ms": [(m, v / 1e6) for m, v in incl_t.most_common(top)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/trace_e2e")
    ap.add_argument("--burst", type=int, nargs="+", default=[0, 16])
    ap.add_argument("--keep-traces", action="store_true")
    args = ap.parse_args(argv)
    out = args.out if os.path.isabs(args.out) else os.path.join(ROOT, args.out)

    sys.path.insert(0, ROOT)
    import jax

    import chip_smoke as cs
    from plslam import runner
    from plslam.io import render
    from plslam.utils.device import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_e2e.py needs a GPU; JAX's first device is {dev.platform!r}")
    enable_compile_cache()
    with jax.default_device(jax.devices("cpu")[0]):
        meta = render.write_euroc_class_dataset(cs.DATA_DIR, seed=cs.SEED,
                                                n_frames=cs.N_FRAMES)
    cfg = cs.smoke_config(meta)
    os.makedirs(out, exist_ok=True)
    res = {"device_kind": dev.device_kind}
    for burst in args.burst:
        run = lambda: runner.run_euroc(cs.DATA_DIR, cfg, use_lines=True, burst=burst)
        run()  # compiles
        t0 = time.perf_counter()
        run()
        untraced = time.perf_counter() - t0
        tdir = os.path.join(out, f"b{burst}")
        with jax.profiler.trace(tdir):
            t1 = time.perf_counter()
            _, _, _, est, _ = run()
            traced = time.perf_counter() - t1
        path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True))[-1]
        r = {"untraced_wall_s": untraced,
             **reduce_trace(path, len(est.metrics), traced)}
        res[f"burst={burst}"] = r
        if not args.keep_traces:
            shutil.rmtree(tdir)
        print(json.dumps({f"burst={burst}": {k: v for k, v in r.items()
                                              if not isinstance(v, list)}}), flush=True)
    with open(os.path.join(out, "trace_e2e.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
