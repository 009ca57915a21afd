"""Fixed-capacity point/line feature tables (host-side bookkeeping).

JAX equivalent of the reference's
`vins_estimator/src/feature_manager.cpp` (`FeatureManager`,
`list<FeaturePerId>` / `list<lineFeaturePerId>`, `addFeatureCheckParallax`,
`triangulate`, `triangulateLine`, `removeBackShiftDepth`, `removeFront`,
`removeFailures`, `removeOutlier` — SURVEY.md §2.3). The reference's linked
-list surgery becomes slot-array updates over fixed-capacity numpy arrays on
the host; the solver sees only the packed fixed-shape device arrays
(`WindowFactors`), so window shape never changes and nothing recompiles.

Per-frame cost here is O(MAX_F·NW) numpy ops — trivial next to the device
solve; the hot math (triangulation, BA) stays on device.
"""
from __future__ import annotations

import numpy as np

from plslam.config import SolverConfig


def _quat_to_rot_np(q):
    """Rotation matrix from wxyz quaternion — pure numpy (host hot path)."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class PointTable:
    def __init__(self, cfg: SolverConfig):
        self.cfg = cfg
        nw = cfg.window_size + 1
        mf = cfg.max_features
        self.nw, self.mf = nw, mf
        self.ids = np.full(mf, -1, np.int64)  # -1 = free slot
        self.start = np.zeros(mf, np.int32)
        self.obs = np.zeros((mf, nw, 2), np.float64)
        self.vel = np.zeros((mf, nw, 2), np.float64)
        self.mask = np.zeros((mf, nw), bool)
        self.inv_depth = np.full(mf, -1.0, np.float64)  # <0 = not solved
        self.track_cnt = np.zeros(mf, np.int32)

    @property
    def active(self):
        return self.ids >= 0

    def add_frame(self, frame_idx: int, ids, pts, vels=None):
        """Insert observations of frame `frame_idx` (`addFeatureCheckParallax`
        insertion half). Returns number of tracked (pre-existing) features.

        Unlike the reference's `FeaturePerId` (contiguous by construction —
        the LK tracker never resurrects a lost id), oracle frontends whose ids
        are landmark indices produce GAPPED tracks (FOV flicker). Gaps are
        kept (every real observation constrains the solve); `slide_old`
        re-anchors gapped depths safely (ADVICE r1)."""
        ids = np.asarray(ids)
        pts = np.asarray(pts)
        vels = np.zeros_like(pts) if vels is None else np.asarray(vels)
        tracked = 0
        slot_of = {int(i): s for s, i in enumerate(self.ids) if i >= 0}
        free = list(np.nonzero(~self.active)[0])
        for k in range(len(ids)):
            fid = int(ids[k])
            s = slot_of.get(fid)
            if s is None:
                if not free:
                    continue  # table full: drop new feature (bounded capacity)
                s = free.pop(0)
                self.ids[s] = fid
                self.start[s] = frame_idx
                self.inv_depth[s] = -1.0
                self.track_cnt[s] = 0
                self.obs[s] = 0
                self.vel[s] = 0
                self.mask[s] = False
            else:
                tracked += 1
            self.obs[s, frame_idx] = pts[k]
            self.vel[s, frame_idx] = vels[k]
            self.mask[s, frame_idx] = True
            self.track_cnt[s] += 1
        return tracked

    def parallax_keyframe_decision(self, frame_idx: int) -> bool:
        """`addFeatureCheckParallax` decision half: True → marginalize old
        (current frame is a keyframe), False → marginalize second-new.
        Parallax is measured between frames `frame_idx-2` and `frame_idx-1`
        for features seen in both (compensatedParallax2; the rotation
        compensation term of the reference reduces to the plain normalized
        -coordinate displacement it also falls back to)."""
        if frame_idx < 2:
            return True
        both = self.active & self.mask[:, frame_idx - 2] & self.mask[:, frame_idx - 1]
        # require established tracks like the reference (start early enough)
        both &= self.start <= frame_idx - 2
        if not np.any(both):
            return True
        d = self.obs[both, frame_idx - 1] - self.obs[both, frame_idx - 2]
        parallax = float(np.mean(np.linalg.norm(d, axis=-1)))
        min_parallax = self.cfg.keyframe_parallax / self.cfg.focal_length
        return parallax >= min_parallax

    def long_track_count(self, frame_idx: int) -> int:
        return int(np.sum(self.active & (self.track_cnt >= 2) & self.mask[:, frame_idx]))

    def slide_old(self, p_wc_old0, q_wc_old0, p_wc_new0, q_wc_new0):
        """MARGIN_OLD slide (`removeBackShiftDepth`): drop frame-0
        observations, shift the window left, transfer anchored depths of
        frame-0-anchored features to the new first observing frame using the
        old/new anchor camera poses (world_T_cam).

        A depth transfers only when the feature IS observed in frame 1 (the
        new anchor); a gapped track (no frame-1 obs) gets inv_depth reset to
        -1 so triangulation re-anchors it — matching the reference's
        removeBackShiftDepth which walks the per-feature observation list."""
        starts_at_0 = self.active & (self.start == 0) & (self.inv_depth > 0)
        gapped = starts_at_0 & ~self.mask[:, 1]
        self.inv_depth[gapped] = -1.0
        sel = starts_at_0 & self.mask[:, 1]
        if np.any(sel):
            # 3D point in old anchor cam → world → new anchor cam (vectorized)
            uv = self.obs[sel, 0]
            depth = 1.0 / self.inv_depth[sel]
            pc0 = np.stack([uv[:, 0] * depth, uv[:, 1] * depth, depth], axis=-1)
            R_old = _quat_to_rot_np(q_wc_old0)
            R_new = _quat_to_rot_np(q_wc_new0)
            pw = pc0 @ R_old.T + np.asarray(p_wc_old0)
            pc1 = (pw - np.asarray(p_wc_new0)) @ R_new  # = R_new.T rowwise
            z = pc1[:, 2]
            self.inv_depth[sel] = np.where(z > 0.1, 1.0 / np.maximum(z, 1e-9), -1.0)

        # shift all windows left
        self.obs[:, :-1] = self.obs[:, 1:]
        self.vel[:, :-1] = self.vel[:, 1:]
        self.mask[:, :-1] = self.mask[:, 1:]
        self.obs[:, -1] = 0
        self.vel[:, -1] = 0
        self.mask[:, -1] = False
        # tracks may have gaps (oracle frontends): the anchor is the FIRST
        # observed column, not blindly start-1 (ADVICE r1)
        self._drop_empty()
        has = np.any(self.mask, axis=1)
        self.start = np.where(has, np.argmax(self.mask, axis=1), 0).astype(np.int32)
        # a depth anchored at old frame 1 (new frame 0) survived the transfer;
        # anything anchored later than its first observation is stale
        self.inv_depth = np.where(self.active & has, self.inv_depth, -1.0)

    def slide_new(self):
        """MARGIN_SECOND_NEW slide (`removeFront`): discard frame NW-2
        observations, move frame NW-1 into its place."""
        nw = self.nw
        self.obs[:, nw - 2] = self.obs[:, nw - 1]
        self.vel[:, nw - 2] = self.vel[:, nw - 1]
        self.mask[:, nw - 2] = self.mask[:, nw - 1]
        self.obs[:, nw - 1] = 0
        self.vel[:, nw - 1] = 0
        self.mask[:, nw - 1] = False
        self.start[self.start == nw - 1] = nw - 2
        self._drop_empty()

    def _clear_slots(self, slots):
        """Zero everything in freed slots: results must not depend on stale
        dead-slot memory reaching the device arrays."""
        self.ids[slots] = -1
        self.inv_depth[slots] = -1.0
        self.mask[slots] = False
        self.obs[slots] = 0
        self.vel[slots] = 0
        self.start[slots] = 0
        self.track_cnt[slots] = 0

    def _drop_empty(self):
        empty = self.active & ~np.any(self.mask, axis=1)
        if np.any(empty):
            self._clear_slots(empty)

    def drop(self, slots):
        self._clear_slots(slots)

    def solvable(self):
        """Features with ≥2 observations (triangulation candidates)."""
        return self.active & (np.sum(self.mask, axis=1) >= 2)

    def used_in_solver(self):
        return self.active & (self.inv_depth > 0) & (np.sum(self.mask, axis=1) >= 2)


class LineTable:
    def __init__(self, cfg: SolverConfig):
        self.cfg = cfg
        nw = cfg.window_size + 1
        ml = cfg.max_line_feats
        self.nw, self.ml = nw, ml
        self.ids = np.full(ml, -1, np.int64)
        self.start = np.zeros(ml, np.int32)
        self.obs = np.zeros((ml, nw, 4), np.float64)  # sx,sy,ex,ey normalized
        self.mask = np.zeros((ml, nw), bool)
        self.line_w = np.zeros((ml, 6), np.float64)  # world Plücker
        self.solved = np.zeros(ml, bool)
        self.track_cnt = np.zeros(ml, np.int32)

    @property
    def active(self):
        return self.ids >= 0

    def add_frame(self, frame_idx: int, ids, segs):
        ids = np.asarray(ids)
        segs = np.asarray(segs)
        slot_of = {int(i): s for s, i in enumerate(self.ids) if i >= 0}
        free = list(np.nonzero(~self.active)[0])
        for k in range(len(ids)):
            lid = int(ids[k])
            s = slot_of.get(lid)
            if s is None:
                if not free:
                    continue
                s = free.pop(0)
                self.ids[s] = lid
                self.start[s] = frame_idx
                self.solved[s] = False
                self.track_cnt[s] = 0
                self.obs[s] = 0
                self.mask[s] = False
            self.obs[s, frame_idx] = segs[k]
            self.mask[s, frame_idx] = True
            self.track_cnt[s] += 1

    def slide_old(self):
        self.obs[:, :-1] = self.obs[:, 1:]
        self.mask[:, :-1] = self.mask[:, 1:]
        self.obs[:, -1] = 0
        self.mask[:, -1] = False
        self._drop_empty()
        has = np.any(self.mask, axis=1)
        self.start = np.where(has, np.argmax(self.mask, axis=1), 0).astype(np.int32)

    def slide_new(self):
        nw = self.nw
        self.obs[:, nw - 2] = self.obs[:, nw - 1]
        self.mask[:, nw - 2] = self.mask[:, nw - 1]
        self.obs[:, nw - 1] = 0
        self.mask[:, nw - 1] = False
        self.start[self.start == nw - 1] = nw - 2
        self._drop_empty()

    def _clear_slots(self, slots):
        self.ids[slots] = -1
        self.solved[slots] = False
        self.mask[slots] = False
        self.obs[slots] = 0
        self.start[slots] = 0
        self.track_cnt[slots] = 0

    def _drop_empty(self):
        empty = self.active & ~np.any(self.mask, axis=1)
        if np.any(empty):
            self._clear_slots(empty)

    def drop(self, slots):
        self._clear_slots(slots)

    def usable(self):
        """Lines with ≥2 observations and triangulated (enter the solver)."""
        return self.active & self.solved & (np.sum(self.mask, axis=1) >= 2)
