"""Stereo (and RGB-D) tracking front end.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/stereo_tracking.py``
(Tracking::GrabImageStereo / GrabImageRGBD / StereoInitialization):
per-frame rectified stereo matching (``ops/stereo.match_stereo``) gives
metric depth and a right-image coordinate for a subset of keypoints;
initialization is immediate (the first frame with >= 100 depth points
becomes the origin keyframe and its points landmarks), and every new
keyframe also turns its unbound close points (depth < depth_factor *
baseline) into landmarks.  Observations with a right coordinate carry the
stereo residual row in pose optimization and BA (``cfg.bf``).

RGB-D takes the same path with the depth sampled from the depth map and a
virtual right coordinate u - bf / depth.  The right image of a stereo pair
is extracted without its pyramid: K1 runs twice per stereo frame, once per
RGB-D frame.  ``FisheyeStereoTracker`` is the non-rectified KB8 rig: its
stereo points come from ``ops/fisheye_stereo.py`` and carry no right
coordinate.
"""

import dataclasses

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.ops import fisheye_stereo, orb, stereo
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackerConfig,
                                                            TrackState, _np)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM


class StereoTracker(MonoTracker):
    """Tracker for a rectified stereo rig (or RGB-D)."""

    def __init__(self, cfg: TrackerConfig, slam_map, baseline=0.11,
                 depth_factor=40.0, **kw):
        super().__init__(cfg, slam_map, **kw)
        self.baseline = float(baseline)
        # Close-point threshold: mThDepth = fx * baseline * depth_factor / fx.
        self.th_depth = depth_factor * self.baseline

    def _image(self, img):
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.float32)
        return self._t(np.asarray(img), torch.float32)

    # ------------------------------------------------------------------
    def process_stereo(self, img_left, img_right, timestamp) -> Frame:
        cfg = self.cfg
        with self.timers.stage("track/extract"):
            frame = self._extract_frame(img_left, timestamp)
            imgR = self._image(img_right)
            fR = orb.extract_orb(imgR, cfg.orb_config)
            self._sync()
        with self.timers.stage("track/stereo_match"):
            u_r, depth, ok = stereo.match_stereo(
                frame.dev("uv_raw"), frame.dev("level"), frame.dev("desc"),
                frame.dev("valid"), fR.uv, fR.level, fR.desc, fR.valid,
                self._image(img_left), imgR, cfg.fx, self.baseline)
            ok_np = _np(ok)
            frame.depth = np.where(ok_np, _np(depth), -1.0).astype(np.float32)
            frame.u_r = np.where(ok_np, _np(u_r), -1.0).astype(np.float32)
        self._track_or_initialize(frame)
        return frame

    def process_rgbd(self, img, depth_map, timestamp) -> Frame:
        """RGB-D: depth sampled at the keypoints replaces stereo matching."""
        cfg = self.cfg
        with self.timers.stage("track/extract"):
            frame = self._extract_frame(img, timestamp)
            self._sync()
        depth_map = np.asarray(depth_map)
        uv = frame.uv_raw
        xi = np.clip(np.round(uv[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
        yi = np.clip(np.round(uv[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
        d = depth_map[yi, xi]
        frame.depth = np.where(d > 0, d, -1.0).astype(np.float32)
        # Virtual right coordinate (Frame::ComputeStereoFromRGBD).
        bf = cfg.fx * self.baseline
        frame.u_r = np.where(
            d > 0, frame.uv[:, 0] - bf / np.maximum(d, 1e-6), -1.0
        ).astype(np.float32)
        self._track_or_initialize(frame)
        return frame

    def _track_or_initialize(self, frame):
        if self.state == TrackState.NOT_INITIALIZED:
            with self.timers.stage("track/initialize"):
                self._stereo_initialization(frame)
                self._sync()
        else:
            with self.timers.stage("track/track"):
                self._track(frame)
                self._sync()
        self._record_trajectory(frame)
        self.last_frame = frame

    # ------------------------------------------------------------------
    def _backproject(self, frame, sel):
        pc = self._cheap_depth_points(frame, sel)
        R, t = frame.R_cw, frame.t_cw
        return (pc - t) @ R  # R^T (pc - t)

    def _stereo_initialization(self, frame: Frame):
        """Immediate metric initialization (StereoInitialization): the first
        frame with enough depth points becomes the origin keyframe."""
        m = self.map
        has_depth = frame.valid & (frame.depth > 0)
        if has_depth.sum() < 100:
            return
        frame.R_cw = np.eye(3, dtype=np.float32)
        frame.t_cw = np.zeros(3, np.float32)
        with m.lock:
            kf = m.add_keyframe(frame.R_cw, frame.t_cw, frame.uv, frame.level,
                                frame.angle, frame.valid, frame.desc,
                                frame.frame_id, frame.timestamp,
                                patch=frame.patch, ur=frame.u_r)
            sel = np.nonzero(has_depth)[0].astype(np.int32)
            X = self._backproject(frame, sel)
            lm_ids = m.add_landmarks(X, frame.desc[sel], kf,
                                     patches=frame.patch[sel])
            m.bind(kf, sel, lm_ids)
            m.update_landmark_stats(lm_ids)
        frame.kp_lm[sel] = lm_ids
        frame.pose_ok = True
        frame.ref_kf = kf
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackState.OK
        self.stats["n_kf"] = 1
        if self.local_mapper is not None:
            self.local_mapper.note_new_keyframe(kf)

    def _cheap_depth_points(self, frame, sel):
        """Camera-frame 3-D points of the selected stereo keypoints."""
        cfg = self.cfg
        z = frame.depth[sel]
        x = (frame.uv[sel, 0] - cfg.cx) / cfg.fx * z
        y = (frame.uv[sel, 1] - cfg.cy) / cfg.fy * z
        return np.stack([x, y, z], -1).astype(np.float32)

    def _create_keyframe(self, frame: Frame):
        """Mono keyframe creation plus the stereo branch: unbound close
        points become landmarks at once (CreateNewKeyFrame's stereo path).
        The branch mutates the map under ``m.lock``: with the background
        mapper it would otherwise race the worker."""
        super()._create_keyframe(frame)
        m = self.map
        kf = self.ref_kf
        depth = getattr(frame, "depth", None)
        if depth is None:
            return
        free = frame.valid & (frame.kp_lm == NO_LM) & (depth > 0) & (
            depth < self.th_depth)
        sel = np.nonzero(free)[0].astype(np.int32)
        if sel.size == 0:
            return
        with m.lock:
            # The pose may have been refined by mapping: use the KF pose.
            frame.R_cw = m.kf_R[kf].copy()
            frame.t_cw = m.kf_t[kf].copy()
            X = self._backproject(frame, sel)
            lm_ids = m.add_landmarks(X, frame.desc[sel], kf,
                                     patches=frame.patch[sel])
            m.bind(kf, sel, lm_ids)
            m.update_landmark_stats(lm_ids)
            frame.kp_lm[sel] = lm_ids
            if self.local_mapper is not None:
                self.local_mapper.recent.extend((int(l), kf) for l in lm_ids)


class FisheyeStereoTracker(StereoTracker):
    """Non-rectified KB8 fisheye stereo rig (the TUM-VI configuration;
    Frame::ComputeStereoFishEyeMatches): left and right keypoints are
    matched by descriptor under the epipolar-plane gate of the known
    extrinsic and triangulated from bearing rays
    (``ops/fisheye_stereo.py``).  An accepted keypoint carries its full
    left-camera point (``frame.stereo_pc``) and its range along the left
    ray (``frame.depth``); initialization is immediate and metric from
    those points.  Residuals stay per-camera KB8 reprojections: u_r = -1
    everywhere and cfg.bf must be 0 (there is no rectified row).  Both
    images are extracted with K1, the right one with ``cfg_right``.

    R_rl, t_rl: the pose of the left camera in the right camera's frame
    (p_r = R_rl p_l + t_rl); defaults identity and (-0.11, 0, 0).
    cfg_right: the right lens (defaults to the left's), run on the left
    config's device."""

    def __init__(self, cfg: TrackerConfig, slam_map, R_rl=None, t_rl=None,
                 cfg_right: TrackerConfig = None, baseline=None,
                 depth_factor=40.0, **kw):
        if not cfg.is_kb8:
            raise ValueError("FisheyeStereoTracker requires camera_model='kb8'")
        if cfg.bf != 0.0:
            raise ValueError("fisheye stereo uses per-camera residuals; "
                             "set cfg.bf = 0")
        self.cfg_right = (cfg if cfg_right is None else
                          dataclasses.replace(cfg_right, device=cfg.device))
        self.R_rl = (np.eye(3, dtype=np.float32) if R_rl is None
                     else np.asarray(R_rl, np.float32))
        self.t_rl = (np.array([-0.11, 0.0, 0.0], np.float32) if t_rl is None
                     else np.asarray(t_rl, np.float32))
        if baseline is None:
            baseline = float(np.linalg.norm(self.t_rl))
        super().__init__(cfg, slam_map, baseline=baseline,
                         depth_factor=depth_factor, **kw)
        self._R_rl = self._t(self.R_rl)
        self._t_rl = self._t(self.t_rl)

    def process_stereo(self, img_left, img_right, timestamp) -> Frame:
        cfg, cfg_r = self.cfg, self.cfg_right
        with self.timers.stage("track/extract"):
            frame = self._extract_frame(img_left, timestamp)
            fR = orb.extract_orb(self._image(img_right), cfg_r.orb_config)
            self._sync()
        with self.timers.stage("track/stereo_match"):
            out = fisheye_stereo.match_stereo_fisheye(
                cfg.project_fn, cfg_r.project_fn, cfg.focal,
                self._R_rl, self._t_rl,
                frame.dev("uv"), cfg.unproject_fn(frame.dev("uv")),
                frame.dev("level"), frame.dev("desc"), frame.dev("valid"),
                frame.dev("angle"),
                fR.uv, cfg_r.unproject_fn(fR.uv), fR.level, fR.desc,
                fR.valid, fR.angle)
            ok = _np(out["ok"])
            frame.stereo_pc = _np(out["X"]).astype(np.float32)
            frame.depth = np.where(ok, _np(out["depth"]), -1.0).astype(
                np.float32)
            frame.u_r = np.full(ok.shape[0], -1.0, np.float32)
        self._track_or_initialize(frame)
        return frame

    def _cheap_depth_points(self, frame, sel):
        return frame.stereo_pc[sel].astype(np.float32)
