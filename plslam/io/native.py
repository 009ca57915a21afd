"""ctypes bindings to the native IO library (native/dataloader.cpp).

The reference's data pump (rosbag decode + cv::imdecode + CLAHE) was native
C++; so is ours — the PNG decode and CLAHE run in C++ (no pybind11 in the
image; plain C ABI via ctypes). The library is built from source on first use,
and rebuilt whenever `dataloader.cpp` is newer than it. If the build fails the
callers fall back to the pure-Python decoder, and the compiler's error is
warned about and kept in `build_error()`."""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_LIB = None
_TRIED = False
_BUILD_ERROR = None
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "libplslam_io.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "dataloader.cpp")


def _stale() -> bool:
    return (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC_PATH))


def _build() -> str | None:
    """Run native/build.sh; returns None on success, else the error text."""
    try:
        r = subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return repr(e)
    if r.returncode != 0:
        return (r.stderr or r.stdout).strip() or f"build.sh exited {r.returncode}"
    return None


def _load():
    global _LIB, _TRIED, _BUILD_ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    if _stale():
        _BUILD_ERROR = _build()
        if _BUILD_ERROR is not None:
            warnings.warn("native IO library failed to build; using the Python "
                          f"PNG decoder and CLAHE:\n{_BUILD_ERROR}")
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        _BUILD_ERROR = str(e)
        warnings.warn(f"native IO library failed to load: {e}")
        return None
    lib.plslam_load_png_gray.restype = ctypes.c_int
    lib.plslam_load_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.plslam_clahe.restype = None
    lib.plslam_clahe.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """The build or load error of the native library, None if it loaded."""
    _load()
    return _BUILD_ERROR


def load_png_gray(path: str, max_w=4096, max_h=4096) -> np.ndarray | None:
    """Native PNG → float32 [H,W] in [0,1]; None if the lib is unavailable
    or the file unsupported (caller falls back to the Python decoder)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(max_w * max_h, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.plslam_load_png_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h), max_w, max_h,
    )
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def clahe(img: np.ndarray, clip=3.0, tiles=8) -> np.ndarray | None:
    """Native CLAHE (cv::createCLAHE(3.0, 8x8) equivalent)."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    lib.plslam_clahe(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[0], img.shape[1], clip, tiles,
    )
    return out
