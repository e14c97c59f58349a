"""Monocular tracking front end.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/tracking.py``
(``TrackerConfig``, ``MonoTracker``): host orchestration of the torch
stages, mirroring the state machine of ORB-SLAM3's Tracking — monocular
initialization, the whole-frame fused slice (flow anchor + motion model +
local-map rounds), the split fallback (motion model, reference keyframe,
local map), the keyframe decision, synchronous local mapping and the
loop-closing callback per keyframe, and localization-only mode.  Heavy
compute runs on ``cfg.device``; this file moves indices around in numpy.
"""

import enum
import functools
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.cameras.twoview import reconstruct_two_views
from orb_slam3_study_kr_tpu_torch.lie.so3 import matrix_to_quat
from orb_slam3_study_kr_tpu_torch.ops import klt, matching, orb, track_match
from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import pack_desc_np
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.fused_round import (
    fused_track_frame, fused_track_rounds)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, optimize_pose
from orb_slam3_study_kr_tpu_torch.utils import StageTimers, resolve_device


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


# Options of the reference tracker this port does not carry yet, with the
# value that keeps them off (ROADMAP.md names the item that ports each).
_NOT_PORTED = {
    "camera_model": ("pinhole", "fisheye (ROADMAP item 16)"),
    "bf": (0.0, "stereo/RGB-D (ROADMAP item 14)"),
    "klt_refine": (True, "the KLT-off tracker variant (ROADMAP item 12 knobs)"),
    "fused_rounds": (True, "the unfused split rounds (ROADMAP item 12 knobs)"),
    "refkf_anchor": (False, "refkf_anchor (ROADMAP item 12 knobs)"),
    "patch_zncc_min": (-1.0, "patch_zncc_min > -1 (ROADMAP item 12 knobs)"),
}


@dataclass
class TrackerConfig:
    width: int = 752
    height: int = 480
    fx: float = 458.0
    fy: float = 457.0
    cx: float = 376.0
    cy: float = 240.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3
    camera_model: str = "pinhole"
    fps: float = 20.0
    n_features: int = 1000
    orb_n_levels: int = 8
    orb_scale_factor: float = 1.2
    orb_ini_th_fast: int = 20
    orb_min_th_fast: int = 7
    min_init_matches: int = 100
    min_track_matches: int = 12
    min_local_inliers: int = 25
    kf_ref_ratio: float = 0.9
    kf_min_gap: int = 2
    init_min_parallax: float = 1.5
    local_map_size: int = 4096
    bf: float = 0.0
    patch_zncc_min: float = -1.0
    # KLT match verification/refinement (ops/klt.py) with the
    # distinctiveness-gated observation write-back.
    klt_refine: bool = True
    klt_zncc_min: float = 0.5
    klt_max_shift: float = 3.0
    klt_move_obs: bool = True
    klt_distinct_min: float = 0.15
    ambig_obs_weight: float = 1.0
    mm_mature_only: bool = True
    flow_anchor: bool = True
    flow_anchor_radius: float = 40.0
    refkf_anchor: bool = False
    fused_rounds: bool = True
    fused_frame: bool = True
    fused_local_rounds: int = 2
    fused_th_wide: float = 3.0
    sanity_med_mult: float = 3.0
    sanity_std_mult: float = 1.5
    seed: int = 0
    # torch device of every stage (SlamSystem sets it from SystemConfig).
    # "cuda" raises in every object built from this config when no card is
    # present; the CPU runs only when asked for with device="cpu".
    device: str = "cuda"

    def check_supported(self):
        """Raise NotImplementedError for reference options not ported yet."""
        for name, (off, what) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"TrackerConfig.{name}={getattr(self, name)!r}: {what} is "
                    "not ported to the torch package yet")
        if self.ambig_obs_weight < 1.0:
            raise NotImplementedError(
                "TrackerConfig.ambig_obs_weight < 1 is not ported to the torch "
                "package yet (ROADMAP item 12 knobs)")

    def _tensor(self, values):
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    @functools.cached_property
    def cam_params(self):
        d = tuple(self.dist) + (0.0,) * (5 - len(self.dist))
        return self._tensor([self.fx, self.fy, self.cx, self.cy, *d])

    @functools.cached_property
    def ideal_params(self):
        return self._tensor([self.fx, self.fy, self.cx, self.cy, 0, 0, 0, 0, 0])

    @functools.cached_property
    def K(self):
        return self._tensor([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                             [0, 0, 1.0]])

    @functools.cached_property
    def orb_config(self):
        return orb.OrbConfig(
            n_features=self.n_features, height=self.height, width=self.width,
            n_levels=self.orb_n_levels, scale_factor=self.orb_scale_factor,
            fast_threshold=self.orb_ini_th_fast,
            fast_min_threshold=self.orb_min_th_fast)

    @functools.cached_property
    def project_fn(self):
        return functools.partial(pinhole.project, self.ideal_params)

    @functools.cached_property
    def project_jac_fn(self):
        return functools.partial(pinhole.project_jac, self.ideal_params)

    @functools.cached_property
    def undistort_px_fn(self):
        """Raw pixel coords -> ideal undistorted pixels."""
        cam, ideal = self.cam_params, self.ideal_params

        def f(uv):
            return pinhole.project(ideal, pinhole.unproject(cam, uv))
        return f

    @functools.cached_property
    def unproject_fn(self):
        return functools.partial(pinhole.unproject, self.ideal_params)

    @property
    def focal(self):
        return float(self.fx)


def _np_se3_inverse(R, t):
    Rt = np.ascontiguousarray(R.T)
    return Rt, -(Rt @ t)


def _np_se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): apply b then a."""
    return Ra @ Rb, Ra @ tb + ta


def _pad_rows(a, n, fill=0):
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _np(t):
    return t.detach().cpu().numpy()


class MonoTracker:
    """Tracking + (synchronous) mapping driver for one monocular camera.

    ``ransac_sets_fn(mask_np, iters) -> (idx_h, idx_f)`` optionally supplies
    the two-view RANSAC minimal sets (tests reproduce the reference's
    jax.random key chain with it); by default they come from a
    torch.Generator seeded with ``cfg.seed``."""

    def __init__(self, cfg: TrackerConfig, slam_map: MapState, local_mapper=None,
                 loop_closer=None, relocalizer=None, on_tracking_lost=None,
                 ransac_sets_fn=None):
        cfg.check_supported()
        self.cfg = cfg
        self.device = resolve_device(cfg.device, "TrackerConfig.device")
        self.map = slam_map
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer          # callable(kf_id) -> bool
        self.relocalizer = relocalizer          # callable(frame) -> bool
        self.on_tracking_lost = on_tracking_lost
        self.ransac_sets_fn = ransac_sets_fn
        self.lost_counter = 0
        self.last_ok_ts = None  # timestamp of the last OK-tracked frame
        self.state = TrackState.NOT_INITIALIZED
        self.init_ref = None
        self.last_frame = None
        self.velocity = None
        self.frame_count = 0
        self.last_kf_frame_id = -1
        self.ref_kf = -1
        self.trajectory = []
        self.only_tracking = False  # localization mode: no map mutation
        self._speed_hist = []
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.stats = {"n_frames": 0, "n_kf": 0, "track_fail": 0,
                      "mm_fail": 0, "refkf_fail": 0, "local_fail": 0}
        self.timers = StageTimers()
        self._level_wh = self._t(klt.make_level_wh(cfg.orb_config))

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _extract_frame(self, img, timestamp) -> Frame:
        """ORB extraction + undistortion into a Frame (keeps the blurred
        pyramid on the device for KLT)."""
        cfg = self.cfg
        if isinstance(img, torch.Tensor):
            img_dev = img.to(self.device)
        else:
            a = np.asarray(img)
            img_dev = self._t(a if a.dtype == np.uint8 else a.astype(np.float32))
        feats, pyr = orb.extract_orb(img_dev, cfg.orb_config, with_pyramid=True)
        uv_dev = cfg.undistort_px_fn(feats.uv)

        def fetch(feats=feats, uv_dev=uv_dev):
            return dict(uv=_np(uv_dev).copy(), uv_raw=_np(feats.uv).copy(),
                        level=_np(feats.level), angle=_np(feats.angle),
                        response=_np(feats.response), desc=_np(feats.desc),
                        valid=_np(feats.valid), patch=_np(feats.patch).copy())

        frame = Frame(frame_id=self.frame_count, timestamp=timestamp,
                      n_kp=cfg.orb_config.total_slots, fetch=fetch,
                      device=self.device)
        frame.pyr = pyr
        frame.set_dev("uv", uv_dev)
        frame.set_dev("uv_raw", feats.uv)
        frame.set_dev("level", feats.level)
        frame.set_dev("desc", feats.desc)
        frame.set_dev("valid", feats.valid)
        frame.set_dev("angle", feats.angle)
        self.frame_count += 1
        self.stats["n_frames"] += 1
        return frame

    def _sync(self):
        """End a timed stage at device completion (kernels run async)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def process(self, img, timestamp) -> Frame:
        with self.timers.stage("track/extract"):
            frame = self._extract_frame(img, timestamp)
            self._sync()
        if self.state == TrackState.NOT_INITIALIZED:
            with self.timers.stage("track/initialize"):
                self._monocular_initialization(frame)
                self._sync()
        else:
            with self.timers.stage("track/track"):
                self._track(frame)
                self._sync()
        self._record_trajectory(frame)
        self.last_frame = frame
        return frame

    # ------------------------------------------------------------------
    def _ransac_sets(self, mask_np, iters=200):
        if self.ransac_sets_fn is None:
            return None
        return self.ransac_sets_fn(mask_np, iters)

    def _monocular_initialization(self, frame: Frame):
        cfg = self.cfg
        if self.init_ref is None or self.init_ref.valid.sum() < cfg.min_init_matches:
            self.init_ref = frame
            return
        ref = self.init_ref
        idx, ok, _ = matching.search_for_initialization(
            ref.dev("uv"), ref.dev("desc"), ref.dev("angle"), ref.dev("valid"),
            frame.dev("uv"), frame.dev("desc"), frame.dev("angle"),
            frame.dev("valid"))
        idx, ok = _np(idx), _np(ok)
        if ok.sum() < cfg.min_init_matches:
            self.init_ref = frame
            return
        mask = ok.astype(np.float32)
        out = reconstruct_two_views(
            self._t(ref.uv), self._t(frame.uv[idx]), self._t(mask), cfg.K,
            generator=self._gen, sets=self._ransac_sets(mask))
        if not bool(out["success"]):
            return
        if float(out["parallax_deg"]) < cfg.init_min_parallax:
            return
        R21 = _np(out["R21"])
        t21 = _np(out["t21"])
        pts = _np(out["pts3d"])
        good = _np(out["good"]) & ok

        depths = pts[good][:, 2]
        med = float(np.median(depths))
        if med <= 0:
            return
        pts = pts / med
        t21 = t21 / med

        m = self.map
        eye = np.eye(3, dtype=np.float32)
        kf0 = m.add_keyframe(eye, np.zeros(3, np.float32), ref.uv, ref.level,
                             ref.angle, ref.valid, ref.desc, ref.frame_id,
                             ref.timestamp, patch=ref.patch)
        kf1 = m.add_keyframe(R21.astype(np.float32), t21.astype(np.float32),
                             frame.uv, frame.level, frame.angle, frame.valid,
                             frame.desc, frame.frame_id, frame.timestamp,
                             patch=frame.patch)
        gi = np.nonzero(good)[0].astype(np.int32)
        lm_ids = m.add_landmarks(pts[gi].astype(np.float32), ref.desc[gi], kf0,
                                 patches=ref.patch[gi])
        m.bind(kf0, gi, lm_ids)
        m.bind(kf1, idx[gi], lm_ids)
        m.update_landmark_stats(lm_ids)

        self._initial_global_ba(kf0, kf1)

        frame.R_cw = m.kf_R[kf1].copy()
        frame.t_cw = m.kf_t[kf1].copy()
        frame.kp_lm[idx[gi]] = lm_ids
        frame.pose_ok = True
        frame.ref_kf = kf1
        self.ref_kf = kf1
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackState.OK
        self.stats["n_kf"] = 2
        if self.local_mapper is not None:
            self.local_mapper.note_new_keyframe(kf0)
            self.local_mapper.note_new_keyframe(kf1)

    def _initial_global_ba(self, kf0, kf1):
        """20-iteration BA over the two-keyframe map, kf0 fixed, then the
        median depth in kf1 is re-normalised to 1."""
        cfg, m = self.cfg, self.map
        okf, okp, olm = m.observations([kf0, kf1])
        lm_set = np.unique(olm)
        lm_index = np.full(m.max_lm, -1, np.int64)
        lm_index[lm_set] = np.arange(lm_set.size)
        O = okf.shape[0]
        R, t, X, _, _ = bundle_adjust(
            cfg.project_fn, cfg.project_jac_fn,
            self._t(m.kf_R[[kf0, kf1]]), self._t(m.kf_t[[kf0, kf1]]),
            self._t([1.0, 0.0], torch.float32),
            self._t(m.lm_pos[lm_set]),
            torch.ones(lm_set.size, device=self.device),
            self._t((okf == kf1).astype(np.int64)),
            self._t(lm_index[olm]),
            self._t(m.kf_kp_uv[okf, okp]),
            self._t(m.kf_kp_level[okf, okp]),
            torch.ones(O, device=self.device),
            n_iters=20)
        m.kf_R[[kf0, kf1]] = _np(R)
        m.kf_t[[kf0, kf1]] = _np(t)
        m.lm_pos[lm_set] = _np(X)
        p = m.lm_pos[lm_set] @ m.kf_R[kf1].T + m.kf_t[kf1]
        med = float(np.median(p[:, 2]))
        if med > 0:
            m.lm_pos[lm_set] /= med
            m.kf_t[[kf0, kf1]] /= med

    # ------------------------------------------------------------------
    def _lost_pose_estimate(self, frame: Frame):
        frame.R_cw = self.last_frame.R_cw
        frame.t_cw = self.last_frame.t_cw
        frame.pose_ok = False

    def _lost_deadline_passed(self, frame: Frame) -> bool:
        return self.lost_counter > self.cfg.fps

    def _update_last_frame(self):
        """Re-anchor the last frame's pose on its (possibly BA-moved)
        reference keyframe (Tracking::UpdateLastFrame)."""
        lf = self.last_frame
        m = self.map
        if lf is None or not lf.pose_ok or getattr(lf, "rel_ref", -1) < 0:
            return
        with m.lock:
            if m.change_idx == getattr(self, "_last_change_idx", -1):
                return
            self._last_change_idx = m.change_idx
            ref, Rrel, trel = m.resolve_kf(lf.rel_ref, lf.rel_R, lf.rel_t)
            if ref < 0:
                return
            Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
        lf.R_cw, lf.t_cw = _np_se3_compose(Rrel, trel, Rr, tr)

    def _track(self, frame: Frame):
        cfg = self.cfg
        self._update_last_frame()
        ok = False
        n_inliers = -1
        fused_frame = False
        if cfg.fused_frame and self.velocity is not None and self.last_frame.pose_ok:
            n_inliers = self._track_fused_frame(frame)
            if n_inliers is not None and n_inliers >= cfg.min_local_inliers:
                ok = True
                fused_frame = True
            else:
                if n_inliers is not None:
                    self.stats["fused_frame_fallback"] = (
                        self.stats.get("fused_frame_fallback", 0) + 1)
                n_inliers = -1
                frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM, np.int32)
        if not ok and self.velocity is not None and self.last_frame.pose_ok:
            ok = self._track_motion_model(frame)
            if not ok:
                self.stats["mm_fail"] += 1
        if not ok:
            ok = self._track_reference_kf(frame)
            if not ok:
                self.stats["refkf_fail"] += 1
        if not ok and self.relocalizer is not None:
            ok = self.relocalizer(frame)
        if not ok:
            self.state = TrackState.RECENTLY_LOST
            self.stats["track_fail"] += 1
            self.lost_counter += 1
            self._lost_pose_estimate(frame)
            self.velocity = None
            # Never spawn a map in localization-only mode: the map is
            # frozen, keep trying to relocalize against it.
            if (not self.only_tracking
                    and self._lost_deadline_passed(frame)
                    and self.on_tracking_lost is not None):
                self.state = TrackState.LOST
                self.on_tracking_lost()
                self.lost_counter = 0
            return
        self.lost_counter = 0

        if not fused_frame:
            n_inliers = self._track_local_map(frame)
        if n_inliers < cfg.min_local_inliers:
            self.stats["local_fail"] += 1
            self.state = TrackState.RECENTLY_LOST
            self.stats["track_fail"] += 1
            frame.pose_ok = False
            self.velocity = None
            return

        # Pose sanity gate: a pose jumping far beyond the recent frame-to-
        # frame speed is a coherent mis-registration, not motion.
        if self.last_frame.pose_ok:
            def _step_of(f):
                c_new = -f.R_cw.T @ f.t_cw
                c_old = -self.last_frame.R_cw.T @ self.last_frame.t_cw
                return float(np.linalg.norm(c_new - c_old))

            step = _step_of(frame)
            if len(self._speed_hist) >= 5:
                med = float(np.median(self._speed_hist))
                thresh = (cfg.sanity_med_mult * med
                          + cfg.sanity_std_mult * np.std(self._speed_hist))
                if med > 1e-9 and step > thresh:
                    self.stats["sanity_retry"] = (
                        self.stats.get("sanity_retry", 0) + 1)
                    frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM, np.int32)
                    retry_ok = False
                    if fused_frame:
                        n2 = self._track_fused_frame(
                            frame, R_pred=np.asarray(self.last_frame.R_cw),
                            t_pred=np.asarray(self.last_frame.t_cw))
                        retry_ok = n2 is not None and n2 >= cfg.min_local_inliers
                        if retry_ok:
                            n_inliers = n2
                    if not retry_ok:
                        frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM,
                                              np.int32)
                        retry_ok = self._track_reference_kf(frame)
                        if retry_ok:
                            n_inliers = self._track_local_map(frame)
                            retry_ok = n_inliers >= cfg.min_local_inliers
                    step = _step_of(frame) if retry_ok else np.inf
                    if step > thresh:
                        self.stats["sanity_fail"] = (
                            self.stats.get("sanity_fail", 0) + 1)
                        self.state = TrackState.RECENTLY_LOST
                        frame.pose_ok = False
                        frame.R_cw = self.last_frame.R_cw
                        frame.t_cw = self.last_frame.t_cw
                        self.velocity = None
                        return
            self._speed_hist.append(step)
            if len(self._speed_hist) > 10:
                self._speed_hist.pop(0)

        self.state = TrackState.OK
        frame.pose_ok = True
        frame.ref_kf = self.ref_kf
        self.last_ok_ts = frame.timestamp
        Rl, tl = self.last_frame.R_cw, self.last_frame.t_cw
        Rlw_inv, tlw_inv = _np_se3_inverse(np.asarray(Rl), np.asarray(tl))
        self.velocity = _np_se3_compose(np.asarray(frame.R_cw),
                                        np.asarray(frame.t_cw), Rlw_inv, tlw_inv)
        # Localization-only mode never inserts keyframes (mbOnlyTracking).
        if not self.only_tracking and self._need_new_keyframe(frame, n_inliers):
            self._create_keyframe(frame)

    # ------------------------------------------------------------------
    def _predict_pose(self):
        Rv, tv = self.velocity
        return _np_se3_compose(np.asarray(Rv), np.asarray(tv),
                               np.asarray(self.last_frame.R_cw),
                               np.asarray(self.last_frame.t_cw))

    def _match_against_landmarks(self, frame, lm_ids, R_pred, t_pred, th,
                                 wide_gates=False):
        """Project the given landmarks and match to the frame's keypoints."""
        cfg, m = self.cfg, self.map
        L = cfg.local_map_size if not wide_gates else 1024
        with m.lock:
            lm_ids = lm_ids[:L]
            pos = _pad_rows(m.lm_pos[lm_ids], L)
            desc = _pad_rows(m.lm_desc[lm_ids], L)
            mask = _pad_rows(np.ones(lm_ids.shape[0], np.float32), L)
            if wide_gates:
                center = -R_pred.T @ t_pred
                vec = pos - center
                normal = (vec / np.maximum(np.linalg.norm(vec, axis=1,
                                                          keepdims=True),
                                           1e-9)).astype(np.float32)
                min_d = np.zeros(L, np.float32)
                max_d = np.full(L, 1e6, np.float32)
            else:
                normal = _pad_rows(m.lm_normal[lm_ids], L)
                min_d = _pad_rows(m.lm_min_dist[lm_ids], L)
                max_d = _pad_rows(m.lm_max_dist[lm_ids], L)
        lm_slot, ok, visible = track_match.match_local_map(
            cfg.project_fn, self._t(R_pred, torch.float32),
            self._t(t_pred, torch.float32),
            self._t(pos), self._t(normal), self._t(min_d), self._t(max_d),
            self._t(desc), self._t(mask),
            frame.dev("uv"), frame.dev("level"), frame.dev("desc"),
            frame.dev("valid"),
            cfg.width, cfg.height, th=th, level_slack=7 if wide_gates else 1)
        lm_slot, ok, visible = _np(lm_slot), _np(ok), _np(visible)
        matched_lm = np.where(ok, lm_ids[np.clip(lm_slot, 0, lm_ids.size - 1)],
                              NO_LM).astype(np.int32)
        matched_lm = self._klt_refine_matches(frame, matched_lm)
        return matched_lm, visible, lm_ids

    def _klt_refine_matches(self, frame, matched_lm):
        """Photometric verification + sub-pixel refinement of descriptor
        matches against the landmarks' canonical patches."""
        cfg, m = self.cfg, self.map
        if frame.pyr is None:     # a frame built without its pyramid
            return matched_lm
        mask = (matched_lm != NO_LM) & (frame.kp_lm == NO_LM)
        if not mask.any():
            return matched_lm
        with m.lock:
            tmpl = m.lm_patch[np.clip(matched_lm, 0, m.max_lm - 1)]
        uv_ref, zncc, shift, win, distinct = klt.klt_refine(
            frame.pyr, self._level_wh, self._t(frame.uv_raw),
            frame.dev("level"), frame.dev("angle"), self._t(tmpl),
            self._t(mask), max_shift=cfg.klt_max_shift)
        zncc, shift = _np(zncc), _np(shift)
        good = mask & (zncc >= cfg.klt_zncc_min) & (shift < cfg.klt_max_shift)
        if good.any() and cfg.klt_move_obs:
            move = good & (_np(distinct) >= cfg.klt_distinct_min)
            self.stats["klt_ambiguous"] = (
                self.stats.get("klt_ambiguous", 0) + int((good & ~move).sum()))
            und = _np(cfg.undistort_px_fn(uv_ref))
            frame.uv_raw[move] = _np(uv_ref)[move]
            frame.uv[move] = und[move]
            frame.invalidate_dev("uv")
            if frame.patch is not None:
                frame.patch[move] = np.clip(_np(win), 0, 255).astype(np.uint8)[move]
        out = matched_lm.copy()
        out[mask & ~good] = NO_LM
        self.stats["klt_reject"] = (
            self.stats.get("klt_reject", 0) + int((mask & ~good).sum()))
        return out

    def _optimize_frame_pose(self, frame, R0, t0):
        cfg, m = self.cfg, self.map
        with m.lock:
            stale = (frame.kp_lm != NO_LM) & ~m.lm_valid[
                np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            frame.kp_lm = np.where(stale, NO_LM, frame.kp_lm).astype(np.int32)
            X = m.lm_pos[np.clip(frame.kp_lm, 0, m.max_lm - 1)]
        mask = (frame.kp_lm != NO_LM) & frame.valid
        R, t, inl, _ = optimize_pose(
            cfg.project_fn, cfg.project_jac_fn,
            self._t(R0, torch.float32), self._t(t0, torch.float32),
            self._t(X), frame.dev("uv"), frame.dev("level"),
            self._t(mask.astype(np.float32)))
        inl = _np(inl) & mask
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = np.where(inl, frame.kp_lm, NO_LM).astype(np.int32)
        return int(inl.sum())

    def _track_motion_model(self, frame: Frame) -> bool:
        cfg, m = self.cfg, self.map
        R_pred, t_pred = self._predict_pose()
        kp, lms = self.last_frame.bound_obs()
        if lms.size < 3:
            return False
        with m.lock:
            lm_ids = np.unique(lms)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if cfg.mm_mature_only:
                obs = m.landmark_obs_count()
                mature = lm_ids[obs[lm_ids] >= 3]
                if mature.size >= 2 * cfg.min_track_matches:
                    lm_ids = mature
            _, bound_now = frame.bound_obs()
            if bound_now.size:
                lm_ids = lm_ids[~np.isin(lm_ids, bound_now)]
        n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred, th=3.0,
                                   with_flow=True)
        if n < cfg.min_track_matches:
            n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred, th=6.0)
        return n >= cfg.min_track_matches

    def _track_reference_kf(self, frame: Frame) -> bool:
        cfg, m = self.cfg, self.map
        kf = self.ref_kf
        if kf < 0:
            return False
        with m.lock:
            lms = m.kf_kp_lm[kf]
            lm_ids = np.unique(lms[lms != NO_LM])
            lm_ids = lm_ids[self.map.lm_valid[lm_ids]]
        matched_lm = np.full(frame.uv.shape[0], NO_LM, np.int32)
        if lm_ids.size >= 3:
            R0, t0 = ((self.last_frame.R_cw, self.last_frame.t_cw)
                      if self.last_frame.pose_ok else (m.kf_R[kf], m.kf_t[kf]))
            matched_lm, _, _ = self._match_against_landmarks(
                frame, lm_ids, R0, t0, th=10.0, wide_gates=True)
        if (matched_lm != NO_LM).sum() < cfg.min_track_matches:
            bound = m.kf_kp_lm[kf] != NO_LM
            idx, ok, _ = track_match.match_by_descriptor(
                frame.dev("desc"), frame.dev("valid"), self._t(m.kf_desc[kf]),
                self._t(m.kf_kp_valid[kf] & bound))
            idx, ok = _np(idx), _np(ok)
            matched_lm = np.where(ok, m.kf_kp_lm[kf][idx], NO_LM).astype(np.int32)
        if (matched_lm != NO_LM).sum() < cfg.min_track_matches:
            return False
        frame.kp_lm = matched_lm
        if self.last_frame.pose_ok:
            R0, t0 = self.last_frame.R_cw, self.last_frame.t_cw
        else:
            R0, t0 = m.kf_R[kf], m.kf_t[kf]
        n = self._optimize_frame_pose(frame, R0, t0)
        return n >= cfg.min_track_matches

    def _track_local_map(self, frame: Frame) -> int:
        cfg, m = self.cfg, self.map
        _, lms = frame.bound_obs()
        if lms.size == 0:
            return 0
        with m.lock:
            seen = np.zeros(m.max_lm, bool)
            seen[lms] = True
            obs_count = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).sum(axis=1)
            obs_count[~m.kf_valid] = 0
            k1 = np.nonzero(obs_count > 0)[0]
            if k1.size == 0:
                return 0
            self.ref_kf = int(k1[np.argmax(obs_count[k1])])
            frame.ref_kf = self.ref_kf
            local_kfs = set(k1.tolist())
            for kf in k1[np.argsort(-obs_count[k1])][:10]:
                nb, _ = m.covisibility(int(kf), min_shared=15)
                local_kfs.update(nb[:10].tolist())
            local_kfs = np.fromiter(local_kfs, np.int32)
            order = local_kfs[np.argsort(-obs_count[local_kfs], kind="stable")]
            seen_lm = np.zeros(m.max_lm, bool)
            chunks = []
            for kf_i in order:
                c = m.kf_kp_lm[kf_i]
                c = c[c != NO_LM]
                c = c[~seen_lm[c]]
                seen_lm[c] = True
                chunks.append(c)
            cand = np.concatenate(chunks) if chunks else np.empty(0, np.int32)
            cand = cand[m.lm_valid[cand]]
            cand = cand[~np.isin(cand, lms)]
        return self._track_local_map_fused(frame, cand)

    def _build_lm_block(self, cand, L, wide_gates=False, R_pred=None,
                        t_pred=None):
        """Padded device-resident landmark block for the fused rounds; the
        descriptors are packed into K2's int32 words on the host."""
        m = self.map
        with m.lock:
            cand = cand[:L]
            pos = m.lm_pos[cand]
            if wide_gates:
                center = -R_pred.T @ t_pred
                vec = pos - center
                nrm = vec / np.maximum(np.linalg.norm(vec, axis=1, keepdims=True),
                                       1e-9)
                normal = _pad_rows(nrm.astype(np.float32), L)
                min_d = np.zeros(L, np.float32)
                max_d = np.full(L, 1e6, np.float32)
            else:
                normal = _pad_rows(m.lm_normal[cand], L)
                min_d = _pad_rows(m.lm_min_dist[cand], L)
                max_d = _pad_rows(m.lm_max_dist[cand], L)
            gid = np.full(L, NO_LM, np.int32)
            gid[: cand.size] = cand
            blk_mask = _pad_rows(np.ones(cand.shape[0], np.float32), L)
            block = dict(
                lm_pos=self._t(_pad_rows(pos, L)), lm_normal=self._t(normal),
                lm_min_dist=self._t(min_d), lm_max_dist=self._t(max_d),
                lm_words=self._t(pack_desc_np(_pad_rows(m.lm_desc[cand], L))),
                lm_patch=self._t(_pad_rows(m.lm_patch[cand], L)),
                lm_gid=self._t(gid))
        return block, blk_mask, cand

    def _refresh_fused_block(self, lm_ids, L):
        """(Re)build the cached fused-frame candidate block (called under
        the map lock).  Its device tensors are pose-free, so they stay valid
        until the next map change; the descriptors are cached as K2's int32
        words, packed once per rebuild."""
        m = self.map
        obs = m.landmark_obs_count()
        seen = np.zeros(m.max_lm, bool)
        seen[lm_ids] = True
        obs_count = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).sum(axis=1)
        obs_count[~m.kf_valid] = 0
        k1 = np.nonzero(obs_count > 0)[0]
        if k1.size == 0:
            return None
        ref_kf = int(k1[np.argmax(obs_count[k1])])
        local_kfs = set(k1.tolist())
        for kf_i in k1[np.argsort(-obs_count[k1])][:10]:
            nb, _ = m.covisibility(int(kf_i), min_shared=15)
            local_kfs.update(nb[:10].tolist())
        local_kfs = np.fromiter(local_kfs, np.int32)
        order = local_kfs[np.argsort(-obs_count[local_kfs], kind="stable")]
        seen_lm = np.zeros(m.max_lm, bool)
        seen_lm[lm_ids] = True
        chunks = [lm_ids.astype(np.int32)]   # anchor rows first
        for kf_i in order:
            c = m.kf_kp_lm[kf_i]
            c = c[c != NO_LM]
            c = c[~seen_lm[c]]
            seen_lm[c] = True
            chunks.append(c)
        cand = np.concatenate(chunks)
        cand = cand[m.lm_valid[cand]][:L]
        gid = np.full(L, NO_LM, np.int32)
        gid[: cand.size] = cand
        row_of = np.full(m.max_lm, -1, np.int32)
        row_of[cand] = np.arange(cand.size, dtype=np.int32)
        blk = dict(
            change_idx=m.change_idx, member_idx=m.member_idx, map_ref=m,
            cand=cand, ref_kf=ref_kf, row_of=row_of, obs=obs,
            pos=self._t(_pad_rows(m.lm_pos[cand], L)),
            desc_words=self._t(pack_desc_np(_pad_rows(m.lm_desc[cand], L))),
            gid=self._t(gid),
            patch=self._t(_pad_rows(m.lm_patch[cand], L)),
            normal=self._t(_pad_rows(m.lm_normal[cand], L)),
            min_d=self._t(_pad_rows(m.lm_min_dist[cand], L)),
            max_d=self._t(_pad_rows(m.lm_max_dist[cand], L)),
            mask_all=self._t(_pad_rows(np.ones(cand.size, np.float32), L)))
        self._fblk = blk
        return blk

    def _geo_refresh_fused_block(self, blk):
        """Per-change refresh when membership is unchanged: only geometry,
        validity and observation counts moved."""
        m = self.map
        cand = blk["cand"]
        L = blk["pos"].shape[0]
        blk["pos"] = self._t(_pad_rows(m.lm_pos[cand], L))
        blk["normal"] = self._t(_pad_rows(m.lm_normal[cand], L))
        blk["min_d"] = self._t(_pad_rows(m.lm_min_dist[cand], L))
        blk["max_d"] = self._t(_pad_rows(m.lm_max_dist[cand], L))
        blk["mask_all"] = self._t(_pad_rows(m.lm_valid[cand].astype(np.float32), L))
        blk["obs"] = m.landmark_obs_count()
        blk["change_idx"] = m.change_idx

    def _track_fused_frame(self, frame: Frame, R_pred=None, t_pred=None):
        """The whole per-frame tracking slice in one call of
        pipeline/fused_round.fused_track_frame.  Returns the inlier count,
        or None when the fused slice is not applicable."""
        cfg, m = self.cfg, self.map
        lf = self.last_frame
        if R_pred is None:
            R_pred, t_pred = self._predict_pose()
        L = cfg.local_map_size
        with m.lock:
            kp, lms = lf.bound_obs()
            lm_ids = np.unique(lms)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 3:
                self.stats["fused_bail_anchor"] = (
                    self.stats.get("fused_bail_anchor", 0) + 1)
                return None
            blk = getattr(self, "_fblk", None)
            if (blk is None or blk["map_ref"] is not m
                    or blk["member_idx"] != m.member_idx):
                blk = self._refresh_fused_block(lm_ids, L)
                if blk is None:
                    self.stats["fused_bail_refresh"] = (
                        self.stats.get("fused_bail_refresh", 0) + 1)
                    return None
            elif blk["change_idx"] != m.change_idx:
                self._geo_refresh_fused_block(blk)
            if cfg.mm_mature_only:
                mature = lm_ids[blk["obs"][lm_ids] >= 3]
                if mature.size >= 2 * cfg.min_track_matches:
                    lm_ids = mature
            self.ref_kf = blk["ref_kf"]
            frame.ref_kf = self.ref_kf
            cand, row_of = blk["cand"], blk["row_of"]
            wrows = row_of[lm_ids]
            if (wrows < 0).sum() * 2 > lm_ids.size:
                blk = self._refresh_fused_block(lm_ids, L)
                if blk is None:
                    self.stats["fused_bail_refresh"] = (
                        self.stats.get("fused_bail_refresh", 0) + 1)
                    return None
                self.ref_kf = blk["ref_kf"]
                frame.ref_kf = self.ref_kf
                cand, row_of = blk["cand"], blk["row_of"]
                wrows = row_of[lm_ids]
            in_wide = np.zeros(L, np.float32)
            in_wide[wrows[wrows >= 0]] = 1.0

            flow = None
            if cfg.flow_anchor:
                # Bindings only ever exist on valid keypoints; the validity
                # AND is consulted only when the host array already exists
                # (touching lf.valid would trigger the deferred fetch).
                bound = lf.kp_lm != NO_LM
                lf_valid = lf._host.get("valid")
                if lf_valid is not None:
                    bound &= lf_valid
                bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
                if bound.sum() >= 3:
                    fgid = np.where(bound, lf.kp_lm, NO_LM).astype(np.int32)
                    cl = np.clip(fgid, 0, m.max_lm - 1)
                    flow = (lf.dev("uv"), lf.dev("desc"), lf.dev("angle"),
                            self._t(bound), self._t(fgid), self._t(row_of[cl]))

            self.stats["fused_frames"] = self.stats.get("fused_frames", 0) + 1
            out = fused_track_frame(
                cfg.project_fn, cfg.project_jac_fn, cfg.undistort_px_fn,
                self._t(R_pred, torch.float32), self._t(t_pred, torch.float32),
                blk["pos"], blk["desc_words"], blk["gid"], blk["patch"],
                blk["normal"], blk["min_d"], blk["max_d"],
                blk["mask_all"], self._t(in_wide),
                self._t(frame.kp_lm),
                torch.zeros((frame.kp_lm.shape[0], 3), dtype=torch.float32,
                            device=self.device),
                frame.dev("uv"), frame.dev("level"), frame.dev("desc"),
                frame.dev("valid"), frame.dev("uv_raw"), frame.dev("angle"),
                frame.pyr, self._level_wh,
                cfg.width, cfg.height, cfg.min_track_matches,
                th_wide=cfg.fused_th_wide,
                n_local_rounds=cfg.fused_local_rounds,
                scale_factor=cfg.orb_scale_factor,
                n_levels=cfg.orb_n_levels,
                klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min,
                move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius,
                R_last=(self._t(lf.R_cw, torch.float32)
                        if flow is not None else None),
                t_last=(self._t(lf.t_cw, torch.float32)
                        if flow is not None else None))
        (R, t, kp_lm, inl, visible, n_mm, (uv_dev, uv_raw_dev, moved_dev),
         n_flow) = out
        if int(n_mm) < cfg.min_track_matches:
            self.stats["fused_bail_mm"] = self.stats.get("fused_bail_mm", 0) + 1
            return None
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = _np(kp_lm).copy()
        self._install_moves(frame, uv_dev, uv_raw_dev, moved_dev)
        inl = _np(inl)
        visible = _np(visible)
        with m.lock:
            vis = visible[: cand.size]
            m.lm_visible[cand[vis]] += 1
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return int(inl.sum())

    @staticmethod
    def _install_moves(frame, uv_dev, uv_raw_dev, moved_dev):
        """KLT-moved observations: the program returns the full updated
        coordinate arrays; install them as host copies and device mirrors."""
        if bool(moved_dev.any()):
            frame.fill_host(uv=_np(uv_dev).copy(), uv_raw=_np(uv_raw_dev).copy())
            frame.set_dev("uv", uv_dev)
            frame.set_dev("uv_raw", uv_raw_dev)

    def _exec_fused_rounds(self, frame, block, blk_mask, R0, t0, th,
                           level_slack, n_rounds=1, flow=None):
        """Run n_rounds complete rounds (optionally with the flow-anchor
        prologue) and apply pose/bindings/KLT moves on the host.  Returns
        (n_inliers, visible_round1)."""
        cfg, m = self.cfg, self.map
        with m.lock:
            stale = (frame.kp_lm != NO_LM) & ~m.lm_valid[
                np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            frame.kp_lm = np.where(stale, NO_LM, frame.kp_lm).astype(np.int32)
            kp_lm_pos = m.lm_pos[np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            out = fused_track_rounds(
                cfg.project_fn, cfg.project_jac_fn, cfg.undistort_px_fn,
                self._t(R0, torch.float32), self._t(t0, torch.float32),
                block["lm_pos"], block["lm_normal"], block["lm_min_dist"],
                block["lm_max_dist"], block["lm_words"], self._t(blk_mask),
                block["lm_gid"], block["lm_patch"],
                self._t(frame.kp_lm), self._t(kp_lm_pos),
                frame.dev("uv"), frame.dev("level"), frame.dev("desc"),
                frame.dev("valid"), frame.dev("uv_raw"), frame.dev("angle"),
                frame.pyr, self._level_wh, cfg.width, cfg.height, th=th,
                scale_factor=cfg.orb_scale_factor, n_levels=cfg.orb_n_levels,
                level_slack=level_slack, klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min,
                n_rounds=n_rounds, move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius)
        (R, t, kp_lm, inl, visible, (uv_dev, uv_raw_dev, moved_dev),
         n_flow) = out
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = _np(kp_lm).copy()
        self._install_moves(frame, uv_dev, uv_raw_dev, moved_dev)
        return int(_np(inl).sum()), _np(visible)

    def _track_local_map_fused(self, frame: Frame, cand) -> int:
        """Both local-map rounds through one fused_track_rounds call."""
        cfg, m = self.cfg, self.map
        block, blk_mask, cand = self._build_lm_block(cand, cfg.local_map_size)
        n, visible = self._exec_fused_rounds(
            frame, block, blk_mask, frame.R_cw, frame.t_cw, th=1.0,
            level_slack=1, n_rounds=2)
        with m.lock:
            vis = visible[: cand.size]
            m.lm_visible[cand[vis]] += 1
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return n

    def _fused_round_wide(self, frame: Frame, lm_ids, R_pred, t_pred, th,
                          with_flow=False) -> int:
        """Motion-model step as one fused round with wide gates; with
        ``with_flow`` the flow-anchor prologue runs in the same call."""
        cfg, m = self.cfg, self.map
        block, blk_mask, cand = self._build_lm_block(
            lm_ids, 1024, wide_gates=True, R_pred=R_pred, t_pred=t_pred)
        flow = None
        lf = self.last_frame
        if with_flow and cfg.flow_anchor and lf is not None:
            with m.lock:
                bound = (lf.kp_lm != NO_LM) & lf.valid
                bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
                if bound.sum() >= 3:
                    row_of = np.full(m.max_lm, -1, np.int32)
                    row_of[cand] = np.arange(cand.size, dtype=np.int32)
                    gid = np.where(bound, lf.kp_lm, NO_LM).astype(np.int32)
                    cl = np.clip(gid, 0, m.max_lm - 1)
                    flow = (lf.dev("uv"), lf.dev("desc"), lf.dev("angle"),
                            self._t(bound), self._t(gid), self._t(row_of[cl]))
        n, _ = self._exec_fused_rounds(frame, block, blk_mask, R_pred, t_pred,
                                       th=th, level_slack=7, flow=flow)
        return n

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame, n_inliers: int) -> bool:
        cfg, m = self.cfg, self.map
        frames_since = frame.frame_id - self.last_kf_frame_id
        with m.lock:
            obs = m.landmark_obs_count()
            ref_lms = m.kf_kp_lm[self.ref_kf]
            ref_lms = ref_lms[ref_lms != NO_LM]
            min_obs = 3 if m.n_kf > 2 else 2
            n_ref = int((obs[ref_lms] >= min_obs).sum())
        c1a = frames_since >= cfg.fps
        c2 = (n_inliers < cfg.kf_ref_ratio * max(n_ref, 1)) and n_inliers > 15
        return c1a or (frames_since >= cfg.kf_min_gap and c2)

    def _create_keyframe(self, frame: Frame):
        m = self.map
        with m.lock:
            kf = m.add_keyframe(
                frame.R_cw, frame.t_cw, frame.uv, frame.level, frame.angle,
                frame.valid, frame.desc, frame.frame_id, frame.timestamp,
                kp_lm=frame.kp_lm, patch=frame.patch, ur=frame.u_r)
            self.ref_kf = kf
            frame.ref_kf = kf
            self.last_kf_frame_id = frame.frame_id
            self.stats["n_kf"] += 1
            kp, lms = frame.bound_obs()
            m.update_landmark_stats(lms)
        if self.local_mapper is not None:
            with self.timers.stage("mapping/keyframe"):
                self.local_mapper.note_new_keyframe(kf)
                self.local_mapper.run_once()
            frame.R_cw = m.kf_R[kf].copy()
            frame.t_cw = m.kf_t[kf].copy()
        if self.loop_closer is not None:
            with self.timers.stage("loop/detect_correct"):
                loop_hit = self.loop_closer(kf)
                self._sync()
            if loop_hit:
                # Loop corrected: poses moved; refresh the frame pose and
                # drop the velocity model.
                frame.R_cw = m.kf_R[kf].copy()
                frame.t_cw = m.kf_t[kf].copy()
                self.velocity = None

    # ------------------------------------------------------------------
    def _record_trajectory(self, frame: Frame):
        if frame.R_cw is None:
            return
        m = self.map
        ref = frame.ref_kf if frame.ref_kf >= 0 else self.ref_kf
        if ref >= 0:
            with m.lock:
                Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
            Ri, ti = _np_se3_inverse(np.asarray(Rr), np.asarray(tr))
            Rrel, trel = _np_se3_compose(np.asarray(frame.R_cw),
                                         np.asarray(frame.t_cw), Ri, ti)
            frame.rel_ref = int(ref)
            frame.rel_R = Rrel
            frame.rel_t = trel
            self.trajectory.append((frame.timestamp, ref, Rrel, trel,
                                    self.state, frame.pose_ok, self.map))

    def final_trajectory(self, with_map_ids=False):
        """Replay relative poses against (possibly BA-corrected) keyframe
        poses.  Returns (T, 8): timestamp + T_wc position + quaternion
        [qw qx qy qz]."""
        rows, map_ids = [], []
        for ts, ref, Rrel, trel, state, ok, m in self.trajectory:
            if not ok:
                continue
            with m.lock:
                ref, Rrel, trel = m.resolve_kf(int(ref), Rrel, trel)
                if ref < 0:
                    continue
                Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
            R_cw, t_cw = _np_se3_compose(np.asarray(Rrel, np.float32),
                                         np.asarray(trel, np.float32), Rr, tr)
            R_wc, t_wc = _np_se3_inverse(R_cw, t_cw)
            q = matrix_to_quat(torch.as_tensor(R_wc, dtype=torch.float32)).numpy()
            rows.append([ts, *t_wc, q[0], q[1], q[2], q[3]])
            map_ids.append(m.map_id)
        rows = np.array(rows)
        if with_map_ids:
            return rows, np.array(map_ids, np.int64)
        return rows
