"""Monocular tracking front end.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/tracking.py``
(``TrackerConfig``, ``MonoTracker``): host orchestration of the torch
stages, mirroring the state machine of ORB-SLAM3's Tracking — monocular
initialization, the whole-frame fused slice (flow anchor + motion model +
local-map rounds), the split fallback (motion model, reference keyframe,
local map), the keyframe decision, local mapping and the loop-closing
callback per keyframe (in line, or handed to the background worker of
``pipeline/async_mapping.py``), and localization-only mode.  The split
rounds (flow anchor, motion-model match, two local-map match <-> solve
rounds, one K2 launch per match) replace the fused ones with
``fused_rounds=False`` and whenever a subclass solves the frame pose its
own way (``_custom_pose_opt_active``: the inertial trackers once the IMU
is initialized).  With
``cfg.bf > 0`` (stereo and RGB-D, ``pipeline/stereo_tracking.py``) every
pose solve gets the frame's right coordinates.  Heavy compute runs on
``cfg.device``; this file moves indices around in numpy.
"""

import enum
import functools
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.cameras import camera as lens
from orb_slam3_study_kr_tpu_torch.cameras import kb8, pinhole
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


@dataclass
class TrackerConfig:
    width: int = 752
    height: int = 480
    fx: float = 458.0
    fy: float = 457.0
    cx: float = 376.0
    cy: float = 240.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3
    # Lens model: "pinhole" or "kb8" (Kannala-Brandt fisheye, `dist` holds
    # k1..k4).  KB8 is fisheye-native: keypoints stay in raw fisheye
    # pixels, every projection, its Jacobian and every gate go through the
    # KB8 model, triangulation works on unprojected rays and cheirality is
    # |p| > 1e-3, so observations past 90 degrees off-axis stay live.  Only
    # the monocular two-view bootstrap restricts itself to the central
    # fov_max_deg cone, mapped onto a virtual pinhole.
    camera_model: str = "pinhole"
    fov_max_deg: float = 75.0           # mono-bootstrap central cone (kb8)
    fisheye_half_fov_deg: float = 98.0  # lens half-FOV visibility limit (kb8)
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
    bf: float = 0.0              # fx * stereo baseline; 0 = mono sensor
    patch_zncc_min: float = -1.0  # raw-patch ZNCC gate on matches; <= -1 off
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
        """Raise ValueError for a lens model the port does not know."""
        if self.camera_model not in ("pinhole", "kb8"):
            raise ValueError(f"TrackerConfig.camera_model={self.camera_model!r}:"
                             " expected 'pinhole' or 'kb8'")

    def _tensor(self, values):
        return torch.tensor(values, dtype=torch.float32, device=resolve_device(
            self.device, "TrackerConfig.device"))

    @functools.cached_property
    def cam_params(self):
        d = tuple(self.dist) + (0.0,) * (5 - len(self.dist))
        return self._tensor([self.fx, self.fy, self.cx, self.cy, *d])

    @property
    def is_kb8(self) -> bool:
        """The fisheye lens: every solver then takes ``wide_fov`` (the
        |p| > 1e-3 cheirality) and every match ``max_theta_deg``."""
        return self.camera_model == "kb8"

    def _ideal_intrinsics(self):
        """(fx, fy, cx, cy) of the ideal pinhole; for kb8 the virtual
        pinhole of the mono bootstrap, whose fov_max_deg half-angle maps to
        half the shorter image side."""
        if self.is_kb8:
            f = 0.5 * min(self.width, self.height) / np.tan(
                np.radians(self.fov_max_deg))
            return f, f, self.width / 2, self.height / 2
        return self.fx, self.fy, self.cx, self.cy

    @functools.cached_property
    def ideal_params(self):
        return self._tensor([*self._ideal_intrinsics(), 0, 0, 0, 0, 0])

    @functools.cached_property
    def K(self):
        """The matrix of ideal_params (float32, as ideal_params holds it)."""
        fx, fy, cx, cy = (float(np.float32(v)) for v in self._ideal_intrinsics())
        return self._tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    @functools.cached_property
    def orb_config(self):
        return orb.OrbConfig(
            n_features=self.n_features, height=self.height, width=self.width,
            n_levels=self.orb_n_levels, scale_factor=self.orb_scale_factor,
            fast_threshold=self.orb_ini_th_fast,
            fast_min_threshold=self.orb_min_th_fast)

    @functools.cached_property
    def camera(self):
        """The lens of the frames' pixel coords, the one place the model is
        chosen: KB8 on cam_params (fisheye-native, raw pixels), or the
        ideal pinhole of the undistorted coords."""
        if self.is_kb8:
            return lens.Camera(self.cam_params, lens.CameraKind.KB8,
                               self.width, self.height)
        return lens.Camera(self.ideal_params, lens.CameraKind.PINHOLE,
                           self.width, self.height)

    @functools.cached_property
    def project_fn(self):
        return functools.partial(lens.project, self.camera)

    @functools.cached_property
    def project_jac_fn(self):
        return functools.partial(lens.project_jac, self.camera)

    @functools.cached_property
    def undistort_px_fn(self):
        """Raw pixel coords -> the frame's matching coords: raw pixels
        themselves for fisheye-native kb8, ideal undistorted pixels for
        pinhole."""
        if self.is_kb8:
            return _identity_uv
        raw = lens.Camera(self.cam_params, lens.CameraKind.PINHOLE,
                          self.width, self.height)
        ideal = self.camera

        def f(uv):
            return lens.project(ideal, lens.unproject(raw, uv))
        return f

    @functools.cached_property
    def unproject_fn(self):
        """Frame pixel coords -> bearing rays (unit rays for kb8, z = 1
        points for pinhole)."""
        return functools.partial(lens.unproject, self.camera)

    @property
    def max_theta_deg(self):
        """Off-axis visibility limit of the projection gates (None: the
        pinhole z > 0 frustum)."""
        return float(self.fisheye_half_fov_deg) if self.is_kb8 else None

    @property
    def focal(self):
        """Representative focal length (pixels) of the angular gates."""
        return float(self.fx)


def _identity_uv(uv):
    return uv


def _ray_roundtrip_ok(cam_params, uv):
    """KB8 unprojection validity: a ray whose Newton unprojection diverged,
    or that lies outside the lens model, does not reproject within 0.5 px
    of its pixel."""
    rays = kb8.unproject(cam_params, uv)
    err = torch.linalg.norm(kb8.project(cam_params, rays) - uv, dim=-1)
    return err < 0.5


def _kb8_central_virtual(cam_params, ideal_params, uv, fov_max_deg):
    """Fisheye keypoints -> virtual ideal-pinhole coordinates and the mask
    of those inside the central fov_max_deg cone that round-trip; used only
    by the monocular two-view bootstrap, whose H/F RANSAC wants planar
    pinhole coordinates."""
    rays = kb8.unproject(cam_params, uv)
    uv_ideal = pinhole.project(ideal_params, rays)
    err = torch.linalg.norm(kb8.project(cam_params, rays) - uv, dim=-1)
    theta = torch.atan2(torch.linalg.norm(rays[..., :2], dim=-1), rays[..., 2])
    ok = (err < 0.5) & (theta < torch.deg2rad(
        torch.tensor(fov_max_deg, dtype=torch.float32, device=uv.device)))
    return uv_ideal, ok


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
    jax.random key chain with it); by default they come from a host
    torch.Generator seeded with ``cfg.seed``, so that a session draws the
    same sets on the card as on the CPU."""

    def __init__(self, cfg: TrackerConfig, slam_map: MapState, local_mapper=None,
                 loop_closer=None, relocalizer=None, on_tracking_lost=None,
                 ransac_sets_fn=None):
        cfg.check_supported()
        self.cfg = cfg
        self.device = resolve_device(cfg.device, "TrackerConfig.device")
        self.map = slam_map
        self.local_mapper = local_mapper
        self.async_map = None   # AsyncMapping worker (set by SlamSystem)
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
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self.stats = {"n_frames": 0, "n_kf": 0, "track_fail": 0,
                      "mm_fail": 0, "refkf_fail": 0, "local_fail": 0}
        self.timers = StageTimers()
        self._level_wh = self._t(klt.make_level_wh(cfg.orb_config))

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _extract_frame(self, img, timestamp) -> Frame:
        """ORB extraction + undistortion into a Frame (keeps the blurred
        pyramid on the device when KLT refinement is on)."""
        cfg = self.cfg
        if isinstance(img, torch.Tensor):
            img_dev = img.to(self.device)
        else:
            a = np.asarray(img)
            img_dev = self._t(a if a.dtype == np.uint8 else a.astype(np.float32))
        pyr = None
        if cfg.klt_refine:
            feats, pyr = orb.extract_orb(img_dev, cfg.orb_config,
                                         with_pyramid=True)
        else:
            feats = orb.extract_orb(img_dev, cfg.orb_config)
        uv_dev = cfg.undistort_px_fn(feats.uv)
        valid_dev = feats.valid
        if cfg.is_kb8:
            # Fisheye-native: only rays whose unprojection fails to round-
            # trip are dropped, not an FOV crop (> 90 degrees stays live).
            valid_dev = valid_dev & _ray_roundtrip_ok(cfg.cam_params, feats.uv)

        def fetch(feats=feats, uv_dev=uv_dev, valid_dev=valid_dev):
            return dict(uv=_np(uv_dev).copy(), uv_raw=_np(feats.uv).copy(),
                        level=_np(feats.level), angle=_np(feats.angle),
                        response=_np(feats.response), desc=_np(feats.desc),
                        valid=_np(valid_dev), patch=_np(feats.patch).copy())

        frame = Frame(frame_id=self.frame_count, timestamp=timestamp,
                      n_kp=cfg.orb_config.total_slots, fetch=fetch,
                      device=self.device)
        frame.pyr = pyr
        frame.set_dev("uv", uv_dev)
        frame.set_dev("uv_raw", feats.uv)
        frame.set_dev("level", feats.level)
        frame.set_dev("desc", feats.desc)
        frame.set_dev("valid", valid_dev)
        frame.set_dev("angle", feats.angle)
        self.frame_count += 1
        self.stats["n_frames"] += 1
        return frame

    def _sync(self):
        """End a timed stage at device completion (kernels run async).  Only
        this thread's stream: with the background mapper a device-wide sync
        would also wait for the worker's local BA."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

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
        uv1_init, uv2_init = self._t(ref.uv), self._t(frame.uv[idx])
        if cfg.is_kb8:
            # Bootstrap on the central cone mapped to a virtual pinhole (the
            # same camera centre, so pts3d stay in camera-1 coordinates).
            uv1_init, ok1 = _kb8_central_virtual(
                cfg.cam_params, cfg.ideal_params, uv1_init, cfg.fov_max_deg)
            uv2_init, ok2 = _kb8_central_virtual(
                cfg.cam_params, cfg.ideal_params, uv2_init, cfg.fov_max_deg)
            ok = ok & _np(ok1) & _np(ok2)
            if ok.sum() < cfg.min_init_matches:
                self.init_ref = frame
                return
        mask = ok.astype(np.float32)
        out = reconstruct_two_views(
            uv1_init, uv2_init, self._t(mask), cfg.K,
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
            n_iters=20, wide_fov=cfg.is_kb8)
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
        if (cfg.fused_frame and self.velocity is not None
                and self.last_frame.pose_ok and self._use_fused_rounds()):
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
            cfg.width, cfg.height, th=th, level_slack=7 if wide_gates else 1,
            max_theta_deg=cfg.max_theta_deg)
        lm_slot, ok, visible = _np(lm_slot), _np(ok), _np(visible)
        matched_lm = np.where(ok, lm_ids[np.clip(lm_slot, 0, lm_ids.size - 1)],
                              NO_LM).astype(np.int32)
        # Appearance gate: the match's oriented raw patch must correlate
        # with the landmark's reference patch.
        if cfg.patch_zncc_min > -1 and frame.patch is not None:
            sel = np.nonzero(matched_lm != NO_LM)[0]
            if sel.size:
                p1 = frame.patch[sel].astype(np.float32).reshape(sel.size, -1)
                p2 = m.lm_patch[matched_lm[sel]].astype(np.float32).reshape(
                    sel.size, -1)

                def _norm(p):
                    p = p - p.mean(1, keepdims=True)
                    return p / np.maximum(
                        np.linalg.norm(p, axis=1, keepdims=True), 1e-6)

                z = (_norm(p1) * _norm(p2)).sum(1)
                matched_lm[sel[z < cfg.patch_zncc_min]] = NO_LM
        matched_lm = self._klt_refine_matches(frame, matched_lm)
        return matched_lm, visible, lm_ids

    def _klt_refine_matches(self, frame, matched_lm):
        """Photometric verification + sub-pixel refinement of descriptor
        matches against the landmarks' canonical patches."""
        cfg, m = self.cfg, self.map
        if not cfg.klt_refine or frame.pyr is None:
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
            uv_ref_np = _np(uv_ref)
            und = _np(cfg.undistort_px_fn(uv_ref))
            du = uv_ref_np[:, 0] - frame.uv_raw[:, 0]
            frame.uv_raw[move] = uv_ref_np[move]
            frame.uv[move] = und[move]
            frame.invalidate_dev("uv")
            # Stereo: the right coordinate follows the left one (the
            # disparity was measured at the pre-refinement position).
            if frame.u_r is not None:
                has_r = move & (frame.u_r >= 0)
                frame.u_r[has_r] += du[has_r]
            if frame.patch is not None:
                frame.patch[move] = np.clip(_np(win), 0, 255).astype(np.uint8)[move]
        out = matched_lm.copy()
        out[mask & ~good] = NO_LM
        self.stats["klt_reject"] = (
            self.stats.get("klt_reject", 0) + int((mask & ~good).sum()))
        return out

    def _stereo_kw(self, frame):
        """The stereo row's inputs for a frame with right coordinates."""
        if self.cfg.bf > 0 and frame.u_r is not None:
            return dict(ur_obs=self._t(frame.u_r), bf=self.cfg.bf)
        return {}

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
            self._t(mask.astype(np.float32)), wide_fov=cfg.is_kb8,
            **self._stereo_kw(frame))
        inl = _np(inl) & mask
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = np.where(inl, frame.kp_lm, NO_LM).astype(np.int32)
        return int(inl.sum())

    def _flow_anchor_matches(self, frame: Frame):
        """Pose-free association: windowed descriptor matching centred at
        each bound feature's position in the last frame (image continuity),
        not at its pose-projected position, then the KLT verification.  The
        fused rounds run this as their prologue; the split rounds call it
        before the motion-model match."""
        cfg, m = self.cfg, self.map
        lf = self.last_frame
        if not cfg.flow_anchor or lf is None:
            return
        with m.lock:
            bound = (lf.kp_lm != NO_LM) & lf.valid
            bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
        if bound.sum() < 3:
            return
        idx, ok, _ = matching.search_for_initialization(
            lf.dev("uv"), lf.dev("desc"), lf.dev("angle"), self._t(bound),
            frame.dev("uv"), frame.dev("desc"), frame.dev("angle"),
            frame.dev("valid"), window_radius=cfg.flow_anchor_radius,
            nn_ratio=0.8)
        idx, ok = _np(idx), _np(ok)
        sel = np.nonzero(ok & bound)[0]
        if sel.size == 0:
            return
        # First wins on contested current keypoints.
        new_kp, first = np.unique(idx[sel], return_index=True)
        cand = np.full(frame.uv.shape[0], NO_LM, np.int32)
        cand[new_kp] = lf.kp_lm[sel[first]]
        cand = self._klt_refine_matches(frame, cand)
        take = (cand != NO_LM) & (frame.kp_lm == NO_LM)
        frame.kp_lm = np.where(take, cand, frame.kp_lm).astype(np.int32)
        self.stats["flow_anchor_matches"] = (
            self.stats.get("flow_anchor_matches", 0) + int(take.sum()))

    def _track_motion_model(self, frame: Frame) -> bool:
        cfg, m = self.cfg, self.map
        R_pred, t_pred = self._predict_pose()
        kp, lms = self.last_frame.bound_obs()
        if lms.size < 3:
            return False
        use_fused = self._use_fused_rounds()
        if not use_fused:
            # The fused round runs the flow anchor as its prologue.
            self._flow_anchor_matches(frame)
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
        if use_fused:
            n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred, th=3.0,
                                       with_flow=True)
            if n < cfg.min_track_matches:
                n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred,
                                           th=6.0)
            return n >= cfg.min_track_matches
        # Split rounds: K2 matches on the host's free keypoints, widened
        # once, then the frame's pose solve (pose-inertial once the IMU is
        # initialized).
        for th in (3.0, 6.0):
            matched_lm, _, _ = self._match_against_landmarks(
                frame, lm_ids, R_pred, t_pred, th=th, wide_gates=True)
            free = frame.kp_lm == NO_LM
            frame.kp_lm = np.where(free, matched_lm,
                                   frame.kp_lm).astype(np.int32)
            if (frame.kp_lm != NO_LM).sum() >= cfg.min_track_matches:
                break
        if (frame.kp_lm != NO_LM).sum() < cfg.min_track_matches:
            return False
        n = self._optimize_frame_pose(frame, R_pred, t_pred)
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
        if self._use_fused_rounds():
            return self._track_local_map_fused(frame, cand)
        return self._track_local_map_split(frame, cand)

    def _track_local_map_split(self, frame: Frame, cand) -> int:
        """Two match <-> solve rounds: with the refined pose the search
        windows re-centre, so true matches the first prediction pushed out
        of the gates re-enter."""
        m = self.map
        self.stats["split_frames"] = self.stats.get("split_frames", 0) + 1
        matched_lm, visible, used_ids = self._match_against_landmarks(
            frame, cand, frame.R_cw, frame.t_cw, th=1.0)
        with m.lock:
            m.lm_visible[used_ids[visible[: used_ids.size]]] += 1
        free = frame.kp_lm == NO_LM
        frame.kp_lm = np.where(free, matched_lm, frame.kp_lm).astype(np.int32)
        n = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
        _, lms_now = frame.bound_obs()
        cand2 = cand[~np.isin(cand, lms_now)]
        matched2, _, _ = self._match_against_landmarks(
            frame, cand2, frame.R_cw, frame.t_cw, th=1.0)
        add = (frame.kp_lm == NO_LM) & (matched2 != NO_LM)
        if add.any():
            frame.kp_lm = np.where(add, matched2, frame.kp_lm).astype(np.int32)
            n = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
        with m.lock:
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return n

    def _custom_pose_opt_active(self) -> bool:
        """True when a subclass replaces the visual pose solve with its own
        (the pose-inertial solves after IMU init): the fused rounds' visual
        Gauss-Newton must then give way to the split rounds."""
        return False

    def _use_fused_rounds(self) -> bool:
        """The fused rounds cover the split rounds' semantics except the
        raw-patch ZNCC gate: with that gate on, the split rounds run."""
        return (self.cfg.fused_rounds and self.cfg.patch_zncc_min <= -1
                and not self._custom_pose_opt_active())

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
        use_klt = cfg.klt_refine and frame.pyr is not None
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
                max_theta_deg=cfg.max_theta_deg,
                klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min,
                wide_fov=cfg.is_kb8, use_klt=use_klt,
                move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius,
                R_last=(self._t(lf.R_cw, torch.float32)
                        if flow is not None else None),
                t_last=(self._t(lf.t_cw, torch.float32)
                        if flow is not None else None),
                ambig_w=(cfg.ambig_obs_weight
                         if use_klt and cfg.ambig_obs_weight < 1.0 else None),
                **self._stereo_kw(frame))
        (R, t, kp_lm, inl, visible, n_mm, moves, n_flow) = out
        if int(n_mm) < cfg.min_track_matches:
            self.stats["fused_bail_mm"] = self.stats.get("fused_bail_mm", 0) + 1
            return None
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = _np(kp_lm).copy()
        self._install_moves(frame, *moves)
        inl = _np(inl)
        visible = _np(visible)
        with m.lock:
            vis = visible[: cand.size]
            m.lm_visible[cand[vis]] += 1
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return int(inl.sum())

    @staticmethod
    def _install_moves(frame, uv_dev, uv_raw_dev, ur_dev, moved_dev):
        """KLT-moved observations: the program returns the full updated
        coordinate arrays; install them as host copies and device mirrors
        (and a stereo frame's shifted right coordinates)."""
        if bool(moved_dev.any()):
            frame.fill_host(uv=_np(uv_dev).copy(), uv_raw=_np(uv_raw_dev).copy())
            frame.set_dev("uv", uv_dev)
            frame.set_dev("uv_raw", uv_raw_dev)
            if frame.u_r is not None and ur_dev is not None:
                frame.u_r[:] = _np(ur_dev)

    def _exec_fused_rounds(self, frame, block, blk_mask, R0, t0, th,
                           level_slack, n_rounds=1, flow=None):
        """Run n_rounds complete rounds (optionally with the flow-anchor
        prologue) and apply pose/bindings/KLT moves on the host.  Returns
        (n_inliers, visible_round1)."""
        cfg, m = self.cfg, self.map
        use_klt = cfg.klt_refine and frame.pyr is not None
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
                level_slack=level_slack, max_theta_deg=cfg.max_theta_deg,
                klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min, wide_fov=cfg.is_kb8,
                use_klt=use_klt, n_rounds=n_rounds, move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius,
                **self._stereo_kw(frame))
        (R, t, kp_lm, inl, visible, moves, n_flow) = out
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = _np(R).copy()
        frame.t_cw = _np(t).copy()
        frame.kp_lm = _np(kp_lm).copy()
        self._install_moves(frame, *moves)
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
                    src = [lf.dev("uv"), lf.dev("desc"), lf.dev("angle"),
                           self._t(bound), self._t(gid), self._t(row_of[cl])]
                    if cfg.refkf_anchor and self.ref_kf >= 0:
                        # The reference keyframe's bound observations join
                        # the pose-free source set, after the last frame's
                        # rows: first wins keeps image continuity primary.
                        rk = self.ref_kf
                        kb = m.kf_kp_valid[rk] & (m.kf_kp_lm[rk] != NO_LM)
                        kgid = np.where(kb, m.kf_kp_lm[rk],
                                        NO_LM).astype(np.int32)
                        kb &= m.lm_valid[np.clip(kgid, 0, m.max_lm - 1)]
                        kcl = np.clip(kgid, 0, m.max_lm - 1)
                        extra = (m.kf_kp_uv[rk], m.kf_desc[rk],
                                 m.kf_kp_angle[rk], kb, kgid, row_of[kcl])
                        src = [torch.cat([a, self._t(b).to(a.dtype)])
                               for a, b in zip(src, extra)]
                    flow = tuple(src)
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
        # With the background mapper busy, defer non-urgent keyframes (the
        # reference's bLocalMappingIdle gate): only the max-interval
        # condition forces an insertion.
        if self.async_map is not None and self.async_map.busy and not c1a:
            return False
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
        if self.async_map is not None:
            # Hand-off (LocalMapping::InsertKeyFrame): mapping and the loop
            # cascade run on the worker and tracking continues at once.
            # Pose refinements land in the map arrays; loop effects on the
            # tracker arrive as events (SlamSystem._drain_async_events).
            if self.local_mapper is not None:
                self.local_mapper.note_new_keyframe(kf)
                self.async_map.submit(functools.partial(
                    self._background_kf_task, self.local_mapper,
                    self.loop_closer, m, kf))
            return
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

    def _background_kf_task(self, mapper, loop_cb, m, kf):
        """One keyframe's mapping and loop work, run on the worker thread
        (the loop cascade takes the map lock only for its mutations)."""
        with self.timers.stage("mapping/keyframe_bg"):
            mapper.run_once()
        if loop_cb is not None and m is self.map:
            with self.timers.stage("loop/detect_correct_bg"):
                hit = loop_cb(kf)
            if hit:
                self.async_map.post_event("loop", kf)

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
