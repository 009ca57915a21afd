"""Start-up plumbing: the compile-cache helper, the GPU smoke check's
refusal to run without a GPU, its dataset cache, and the trace reduction
of `scripts/trace_e2e.py`."""
import importlib.util
import json
import os

import jax
import pytest

from plslam.utils.device import enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defers_to_env(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/elsewhere")
    jax.config.update("jax_compilation_cache_dir", "/nonexistent/before")
    assert enable_compile_cache() == "/nonexistent/elsewhere"
    assert jax.config.jax_compilation_cache_dir == "/nonexistent/before"  # nothing set


def test_compile_cache_fixed_path_when_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", "/nonexistent/before")
    want = os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("argv", [[], ["--multichip"]], ids=["one_gpu", "multichip"])
def test_chip_smoke_refuses_cpu(argv, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert jax.devices()[0].platform == "cpu"
    assert mod.main(argv) != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out and "platform=cpu" in out[0]
    with pytest.raises(ValueError):
        json.loads(out[-1])  # no result line


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_busy_is_interval_union():
    te = _load_script("trace_e2e")
    assert te.busy_ns([(20, 30), (0, 10), (5, 15), (22, 25)]) == 25
    assert te.busy_ns([]) == 0


def test_trace_host_times_self_and_outermost_inclusive():
    te = _load_script("trace_e2e")
    # A[0,100) holds B[10,40) (holding C[20,30)), D[50,60) and a recursive A[70,90)
    ev = [("A", 0, 100), ("B", 10, 30), ("C", 20, 10), ("D", 50, 10), ("A", 70, 20)]
    self_t, incl_t = te.host_times(ev)
    assert dict(self_t) == {"A": 60, "B": 20, "C": 10, "D": 10}
    assert dict(incl_t) == {"A": 100, "B": 30, "C": 10, "D": 10}
    assert sum(self_t.values()) == 100  # self times partition the thread's span


def test_euroc_class_render_reused_only_when_it_matches(tmp_path):
    from plslam.io import render

    d = str(tmp_path / "ds")
    cam = os.path.join(d, "mav0", "cam0", "data")
    meta = render.write_euroc_class_dataset(d, seed=3, n_frames=1)
    (png,) = os.listdir(cam)
    assert render._png_shape(os.path.join(cam, png)) == render.EUROC_CLASS_SHAPE
    mtime = os.path.getmtime(os.path.join(cam, png))
    render.write_euroc_class_dataset(d, seed=3, n_frames=1)  # same recipe: reused
    assert os.path.getmtime(os.path.join(cam, png)) == mtime
    meta = render.write_euroc_class_dataset(d, seed=3, n_frames=2)
    assert int(meta["n_frames"]) == 2 and len(os.listdir(cam)) == 2
    frame = lambda: open(os.path.join(cam, png), "rb").read()
    seed3 = frame()
    meta = render.write_euroc_class_dataset(d, seed=4, n_frames=2)
    assert int(meta["seed"]) == 4 and len(os.listdir(cam)) == 2
    assert frame() != seed3  # another seed's world, rendered anew
