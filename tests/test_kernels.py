"""The plain-XLA forms of the frontends' two inner loops: the batched-matmul
LK tracker against the per-feature reference, and the packed Hamming
distance matrices against a numpy popcount."""
import jax.numpy as jnp
import numpy as np
import pytest

from plslam.models import frontend_lines as fl
from plslam.models import frontend_points as fp
from plslam.models import keyframe_db as kdb


def _popcount_ref(d1, d2):
    """Hamming distances of packed uint32 rows, counted bit by bit."""
    x = np.bitwise_xor(d1[:, None, :], d2[None, :, :])
    bits = np.unpackbits(x.view(np.uint8), axis=-1)
    return bits.sum(axis=-1).astype(np.int32)


@pytest.mark.parametrize("hamming", [fl._hamming_dist, kdb.hamming_matrix],
                         ids=["match_lbd_binary", "keyframe_db"])
@pytest.mark.parametrize("n1,n2", [(64, 64), (384, 256)], ids=["lines", "brief"])
def test_hamming_matches_popcount_reference(hamming, n1, n2):
    """Line widths (64 × 64 slots) and keyframe-BRIEF widths (256 keypoints
    plus 128 window points against 256), 8 words of 32 bits each."""
    rng = np.random.default_rng(n1 + n2)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    d2[0] = d1[0]  # one exact match (distance 0)
    d2[1] = ~d1[1]  # one complement (distance 256)
    out = np.asarray(hamming(jnp.asarray(d1), jnp.asarray(d2)))
    ref = _popcount_ref(d1, d2)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == 0 and out[1, 1] == 256


def test_match_lbd_binary_matches_numpy_reference():
    """Mutual-best Hamming matching with the midpoint/angle gates, against a
    numpy transcription fed by the popcount reference."""
    rng = np.random.default_rng(2)
    n = 64
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    flip = rng.integers(0, 2**32, (n, 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (n, 8), dtype=np.uint32) & rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    perm = rng.permutation(n)
    d2 = (d1 ^ flip)[perm]  # ~1/8 of the bits flipped, rows shuffled
    segs1 = rng.uniform(0, 700, (n, 4)).astype(np.float32)
    segs2 = (segs1 + rng.normal(0, 2, (n, 4)).astype(np.float32))[perm]
    v1 = (rng.random(n) > 0.1).astype(np.float32)
    v2 = np.ones(n, np.float32)
    out = np.asarray(fl.match_lbd_binary(*(jnp.asarray(a) for a in
                                           (d1, segs1, v1, d2, segs2, v2))))

    dist = _popcount_ref(d1, d2)
    mid1, mid2 = (0.5 * (s[:, :2] + s[:, 2:]) for s in (segs1, segs2))
    a1, a2 = (np.arctan2(s[:, 3] - s[:, 1], s[:, 2] - s[:, 0]) % np.pi for s in (segs1, segs2))
    d_mid = np.linalg.norm(mid1[:, None] - mid2[None], axis=-1)
    d_ang = np.abs((a1[:, None] - a2[None] + np.pi / 2) % np.pi - np.pi / 2)
    ok = (v1[:, None] > 0) & (v2[None] > 0) & (d_mid < 60) & (d_ang < 0.25)
    dist = np.where(ok, dist, 999)
    b12, b21 = dist.argmin(1), dist.argmin(0)
    good = (b21[b12] == np.arange(n)) & (dist.min(1) < 80) & (v1 > 0)
    ref = np.where(good, b12, -1)
    np.testing.assert_array_equal(out, ref)
    # the shuffled twins are found
    assert (out[v1 > 0] == np.argsort(perm)[v1 > 0]).mean() > 0.9


@pytest.mark.parametrize("dx,dy", [(2.6, 3.1), (-3.7, 1.4)])
def test_lk_fast_matches_reference(dx, dy):
    """The batched-matmul LK (production path) vs the per-feature reference."""
    from test_frontend import smooth_texture, shift_image

    rng = np.random.default_rng(5)
    img1 = smooth_texture(rng)
    img2 = shift_image(img1, dx, dy)
    pyr1 = fp.build_pyramid(jnp.asarray(img1), levels=fp.auto_levels(img1.shape))
    pyr2 = fp.build_pyramid(jnp.asarray(img2), levels=fp.auto_levels(img2.shape))
    uv, score = fp.shi_tomasi_grid(
        jnp.asarray(img1), jnp.zeros((1, 2), jnp.float32), jnp.zeros((1,), jnp.float32),
        cell=24, max_out=40,
    )
    uv = np.asarray(uv)[np.asarray(score) > 1e-5][:24]
    keep = (uv[:, 0] > 30) & (uv[:, 0] < 290) & (uv[:, 1] > 30) & (uv[:, 1] < 210)
    uv = jnp.asarray(uv[keep], jnp.float32)

    out, status = fp.lk_track_fast(pyr1, pyr2, uv, jnp.ones(len(uv), bool))
    out = np.asarray(out)
    status = np.asarray(status)
    assert status.sum() >= len(uv) * 0.8
    flow = out[status] - np.asarray(uv)[status]
    err = np.linalg.norm(flow - np.array([dx, dy]), axis=1)
    assert np.median(err) < 0.25, np.median(err)

    # agreement with the per-feature reference tracker
    out_r, status_r = fp.lk_track(pyr1, pyr2, uv, jnp.ones(len(uv), bool))
    both = status & np.asarray(status_r)
    d = np.linalg.norm(out[both] - np.asarray(out_r)[both], axis=1)
    assert np.median(d) < 0.3, np.median(d)
