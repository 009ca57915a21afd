"""Diagnostic: BRIEF match quality between rendered frames at nearby poses.

Renders pairs of frames (identical pose, small offsets, true revisit pair)
and reports Hamming statistics between window-point descriptors of one frame
and dense corners of the other — isolating the descriptor/matching stage of
the loop-closure chain from VIO drift.

Run (CPU, from the repository root): PYTHONPATH=. python scripts/exp_brief.py
"""
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from plslam.io import render, synthetic
from plslam.models import keyframe_db as kdb
from plslam.ops.cameras import PinholeRadTan, normalized_to_pixel
from plslam.runner import _clahe

H, W = 240, 376


def frame_and_pts(seq, k, cam):
    img = render.render_frame(seq, k, cam, H, W, blob_sigma=3.0, style="textured")
    img = _clahe(img)
    obs = np.asarray(seq.obs[k])
    vis = np.asarray(seq.obs_valid[k])
    uv = np.asarray(normalized_to_pixel(cam, jnp.asarray(obs, jnp.float32)), np.float64)
    inb = vis & (uv[:, 0] > 20) & (uv[:, 0] < W - 20) & (uv[:, 1] > 20) & (uv[:, 1] < H - 20)
    return img, uv, inb


def match_stats(seq, cam, ka, kb, label):
    img_a, uv_a, in_a = frame_and_pts(seq, ka, cam)
    img_b, uv_b, in_b = frame_and_pts(seq, kb, cam)
    sel = np.nonzero(in_a & in_b)[0][:60]  # common landmarks

    # "window points" of frame a: descriptors at the projected landmark pixels
    wv = jnp.ones((len(sel),), jnp.float32)
    d_a, _ = kdb.brief_descriptors(jnp.asarray(img_a, jnp.float32),
                                   jnp.asarray(uv_a[sel], jnp.float32), wv)
    # dense corners of frame b + frame b's own "window points" (what the DB
    # stores — mirrors pose_graph.add_keyframe extra_uv wiring)
    win_b = uv_b[np.nonzero(in_b)[0][:60]]
    uv_db, valid_db, desc_db, _ = kdb.extract_keyframe_features(
        jnp.asarray(img_b, jnp.float32), extra_uv=win_b)

    # corner coverage: does ANY detected corner sit near each landmark?
    dd = np.linalg.norm(uv_db[None, :, :] - uv_b[sel][:, None, :], axis=-1)
    dd[:, ~valid_db] = 999
    near = dd.min(axis=1)
    print(f"    corner coverage: {(near < 3).sum()}/{len(sel)} landmarks have a corner <3px "
          f"(median nearest {np.median(near):.1f}px, valid corners {valid_db.sum()})")

    dist = np.array(kdb.hamming_matrix(d_a, jnp.asarray(desc_db)))
    dist[:, ~valid_db] = 999
    best = dist.argmin(axis=1)
    bestd = dist.min(axis=1)
    good = bestd < 80
    # geometric correctness of the matches: matched corner near the landmark
    err = np.linalg.norm(uv_db[best] - uv_b[sel], axis=1)
    correct = good & (err < 4.0)
    print(f"{label}: {good.sum()}/{len(sel)} Hamming<80, "
          f"{correct.sum()} geometrically correct, "
          f"median d={np.median(bestd):.0f}, "
          f"median err of good={np.median(err[good]) if good.any() else -1:.1f}px")
    # same-pixel self-distance sanity for a few landmarks
    d_b_at_lm, _ = kdb.brief_descriptors(jnp.asarray(img_b, jnp.float32),
                                         jnp.asarray(uv_b[sel], jnp.float32), wv)
    self_d = np.asarray(kdb.hamming_matrix(d_a, d_b_at_lm)).diagonal()
    print(f"    landmark-to-landmark (no corner detection): median {np.median(self_d):.0f}, "
          f"<80: {(self_d < 80).sum()}/{len(sel)}")


def main():
    cam = PinholeRadTan.create(160.0, 160.0, W / 2, H / 2)
    # aligned trajectory: z/pitch/roll phases commensurate with omega so the
    # full circle is a TRUE revisit
    params = synthetic.TrajectoryParams(omega=0.5, z_omega=0.5, pitch_amp=0.05, roll_amp=0.05)
    seq = synthetic.make_sequence(duration=14.0, n_points=500, n_lines=40, seed=23,
                                  params=params)
    gt_p = np.asarray(seq.gt_p)
    period = int(round(2 * np.pi / 0.5 / (seq.frame_t[1] - seq.frame_t[0])))
    print("frames:", len(gt_p), "period(frames):", period,
          "revisit pose gap:", np.linalg.norm(gt_p[period] - gt_p[0]))

    match_stats(seq, cam, 10, 10, "identical frame")
    match_stats(seq, cam, 10, 11, "1-frame offset (~0.05s)")
    match_stats(seq, cam, 10, 12, "2-frame offset")
    match_stats(seq, cam, 10, 10 + period, "true revisit (full circle)")


if __name__ == "__main__":
    main()
