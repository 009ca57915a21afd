"""Native C++ IO library: build, PNG decode vs Python reference, CLAHE."""
import os
import zlib
import struct

import numpy as np
import pytest

from plslam.io import native
from plslam.io.euroc import _read_png_gray


def write_png_gray(path, img_u8):
    """Minimal PNG writer (8-bit grayscale, filter 0) for test fixtures."""
    h, w = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))
    comp = zlib.compress(raw)

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def png_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 255, (48, 64))).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("png") / "t.png")
    write_png_gray(path, img)
    return path, img


def test_native_builds():
    assert native.available(), "native/libplslam_io.so failed to build"


def test_native_png_decode(png_file):
    path, img = png_file
    out = native.load_png_gray(path)
    assert out is not None
    np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, atol=1e-6)
    # agrees with the stdlib Python reference decoder
    ref = _read_png_gray(path).astype(np.float32) / 255.0
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_native_clahe_properties():
    rng = np.random.default_rng(1)
    # low-contrast image: CLAHE must expand the histogram
    img = (rng.uniform(0.4, 0.6, (240, 320))).astype(np.float32)
    out = native.clahe(img)
    assert out is not None
    assert out.shape == img.shape
    assert out.min() < 0.2 and out.max() > 0.8  # contrast expanded
    assert np.all(np.isfinite(out)) and out.min() >= 0.0 and out.max() <= 1.0
    # monotonic within a tile: ordering of values preserved locally
    tile = img[:30, :40]
    tout = out[:30, :40]
    a, b = np.unravel_index(tile.argmin(), tile.shape), np.unravel_index(tile.argmax(), tile.shape)
    assert tout[a] <= tout[b]


def test_native_rebuilds_when_missing_or_stale(tmp_path, monkeypatch):
    """A library older than dataloader.cpp (or none at all) is rebuilt, so a
    stale or foreign build never runs in place of the source."""
    src, lib = tmp_path / "dataloader.cpp", tmp_path / "libplslam_io.so"
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    monkeypatch.setattr(native, "LIB_PATH", str(lib))
    src.write_text("//")
    assert native._stale()  # missing
    lib.write_text("")
    os.utime(src, (2000, 2000))
    os.utime(lib, (1000, 1000))
    assert native._stale()  # older than its source
    os.utime(lib, (3000, 3000))
    assert not native._stale()
