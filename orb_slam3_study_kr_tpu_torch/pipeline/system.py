"""Public session API: monocular, stereo (rectified, or a non-rectified
KB8 fisheye rig) and RGB-D, each also with an IMU.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/system.py``
(``SystemConfig``, ``SlamSystem``): builds the map and the pipeline stages,
routes frames through ``track_monocular``, ``track_stereo`` or
``track_rgbd`` (with ``imu=`` rows for the ``-inertial`` sensors, the
bad-IMU watchdog after each such frame), bootstraps the vocabulary and the
keyframe database, runs loop closing per keyframe, relocalizes lost frames
by BoW + RANSAC PnP with the widening re-search cascade, handles sustained
tracking loss (reset or new map) and the timestamp-jump guard, welds the
active map into a stored map it recognises (``pipeline/map_merging.py`` and
the welding BA, inertial on IMU-initialized maps), saves and loads the
Atlas (``save_atlas`` / ``load_atlas``, the reference's npz layout, the
inertial session state included) and saves trajectories.  With
``async_mapping=True`` mapping and loop closing run on a background worker
(``pipeline/async_mapping.py``) whose events the tracker thread applies at
the next frame boundary; ``flush()`` waits for it and ``shutdown()`` stops
it.  Every stage runs on ``SystemConfig.device``; "cuda" (the default)
raises when no card is present instead of running on the CPU.

The relocalization PnP draws come from ``uniforms_fn(iters, n)`` when given
(tests inject the reference's jax.random stream), else from a
torch.Generator seeded 99, the reference's session PRNGKey.  The loop
closer's and the map merger's Sim3 RANSAC draws come from their own
``uniforms_fn`` (``loop_uniforms_fn``, ``merge_uniforms_fn``) or their own
seeded generators.  Every such generator lives on the host and its draws
move to the device, so that a seed gives the same session on the card as
on the CPU (as a jax.random key does on every backend).
"""

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.bow import (KeyframeDatabase, load_dbow2_text,
                                              load_vocabulary, train_vocabulary)
from orb_slam3_study_kr_tpu_torch.bow.vocabulary import (vocabulary_arrays,
                                                         vocabulary_checksum,
                                                         vocabulary_from_arrays)
from orb_slam3_study_kr_tpu_torch.imu.preintegration import ImuCalib
from orb_slam3_study_kr_tpu_torch.lie.so3 import matrix_to_quat, quat_to_matrix
from orb_slam3_study_kr_tpu_torch.ops.track_match import match_by_descriptor
from orb_slam3_study_kr_tpu_torch.pipeline.async_mapping import AsyncMapping
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.inertial_tracking import (
    FisheyeStereoInertialTracker, InertialTracker, RgbdInertialTracker,
    StereoInertialTracker)
from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.pipeline.map_merging import MapMerger
from orb_slam3_study_kr_tpu_torch.pipeline.stereo_tracking import (
    FisheyeStereoTracker, StereoTracker)
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackerConfig,
                                                            TrackState)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, Atlas, MapState
from orb_slam3_study_kr_tpu_torch.solvers.pnp import ransac_pnp
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

PNP_ITERS = 256
SENSORS = ("mono", "stereo", "rgbd", "mono-inertial", "stereo-inertial",
           "rgbd-inertial")
NO_IMU = np.zeros((0, 7), np.float32)
WELD_WINDOW = 25      # keyframes per side of the welding BA (numTemporalKFs)


@dataclass
class SystemConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    # "mono" | "stereo" (rectified) | "rgbd" | "mono-inertial" |
    # "stereo-inertial" | "rgbd-inertial"
    sensor: str = "mono"
    baseline: float = 0.11      # stereo baseline [m]; bf = fx * baseline
    depth_factor: float = 40.0  # close-point threshold = factor * baseline
    # A fisheye (kb8) stereo rig is not rectified: the full extrinsic
    # p_right = R_rl p_left + t_rl replaces the baseline, and the right lens
    # may differ from the left.
    stereo_R_rl: tuple = None    # 3x3; None = identity
    stereo_t_rl: tuple = None    # 3; None = (-0.11, 0, 0)
    tracker_right: TrackerConfig = None  # None = the left lens
    # IMU (the inertial sensors only): noise densities, bias random walk,
    # rate, body <- camera extrinsic and the t1/t2/t3 init schedule.
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3e-3
    imu_freq: float = 200.0
    imu_R_bc: tuple = None   # 3x3 body <- camera rotation (None = identity)
    imu_t_bc: tuple = None
    imu_init_times: tuple = (2.0, 5.0, 15.0)
    max_kf: int = 300
    max_lm: int = 80000
    enable_loop_closing: bool = True
    # Sustained loss: maps with fewer KFs than this are reset in place,
    # larger maps are stored and a fresh one spawned.
    min_kf_spawn: int = 10
    vocab_k: int = 8
    vocab_L: int = 3
    vocab_min_kfs: int = 5   # train the vocabulary once this many KFs exist
    # Pre-built vocabulary: a DBoW2 text file (.txt, ORBvoc format) or a
    # cached .npz from bow.vocabulary.save_vocabulary.  None = train on this
    # session's descriptors once vocab_min_kfs keyframes exist.
    vocabulary_path: str = None
    # > 1: landmark-sharded global BA over the first ba_devices devices
    # (0/1 = single device; no mesh where fewer exist).  On "cuda" these
    # are the visible cards; on "cpu", ba_devices CPU shards (the
    # counterpart of the reference's virtual host devices).
    ba_devices: int = 0
    # Background mapping/loop worker (the reference's LocalMapping and
    # LoopClosing threads); off = synchronous, deterministic orchestration.
    async_mapping: bool = False
    async_max_pending: int = 3
    device: str = "cuda"

    def check_supported(self):
        """Raise ValueError for a sensor the session does not know."""
        if self.sensor not in SENSORS:
            raise ValueError(f"SystemConfig.sensor={self.sensor!r}: expected "
                             f"one of {SENSORS}")


def _np(t):
    return t.detach().cpu().numpy()


class SlamSystem:
    """SLAM session (System::TrackMonocular / TrackStereo / TrackRGBD)."""

    def __init__(self, cfg: SystemConfig = None, ransac_sets_fn=None,
                 uniforms_fn=None, loop_uniforms_fn=None,
                 merge_uniforms_fn=None):
        self.cfg = cfg or SystemConfig()
        self.cfg.check_supported()
        self.device = resolve_device(self.cfg.device, "SystemConfig.device")
        bf = self.cfg.tracker.bf
        if (not self.cfg.sensor.startswith("mono") and bf == 0.0
                and not self.cfg.tracker.is_kb8):
            # A fisheye rig keeps bf = 0: its residuals stay per-camera KB8
            # projections, never the rectified u_r row.
            bf = self.cfg.tracker.fx * self.cfg.baseline
        # The tracker, the mapper and the loop closer share this config.
        self.cfg.tracker = dataclasses.replace(self.cfg.tracker, bf=bf,
                                               device=str(self.device))
        if self.cfg.tracker_right is not None:
            self.cfg.tracker_right = dataclasses.replace(
                self.cfg.tracker_right, device=str(self.device))
        self.ba_mesh = self._ba_mesh()
        self.ransac_sets_fn = ransac_sets_fn
        self.uniforms_fn = uniforms_fn
        self.loop_uniforms_fn = loop_uniforms_fn
        self._gen = torch.Generator().manual_seed(99)
        self.atlas = Atlas()
        self.voc = None
        self.db = None
        self.loop_closer = None
        self.map_dbs = {}        # map_id -> KeyframeDatabase
        self.merger = MapMerger(cfg=self.cfg.tracker,
                                uniforms_fn=merge_uniforms_fn)
        self.timings = []
        self.sys_stats = {}
        self.async_map = None
        if self.cfg.async_mapping:
            self.async_map = AsyncMapping(
                max_pending=self.cfg.async_max_pending, device=self.device)
        self._new_active_map()

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _ba_mesh(self):
        """The reference's rule: a mesh over the first ba_devices devices,
        none where fewer exist.  On the CPU the devices are CPU shards."""
        n = self.cfg.ba_devices
        if n <= 1:
            return None
        from orb_slam3_study_kr_tpu_torch.parallel import make_ba_mesh
        if self.device.type == "cpu":
            return make_ba_mesh([self.device] * n)
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return make_ba_mesh(devs[:n]) if len(devs) >= n else None

    # ------------------------------------------------------------------
    def _new_active_map(self):
        m = self.atlas.create_map(
            max_kf=self.cfg.max_kf,
            max_kp=self.cfg.tracker.orb_config.total_slots,
            max_lm=self.cfg.max_lm)
        old_tracker = getattr(self, "tracker", None)
        self._build_stages(m)
        if old_tracker is not None:
            # The relative-pose log spans map spawns; frame ids stay monotonic.
            self.tracker.trajectory = old_tracker.trajectory
            self.tracker.frame_count = old_tracker.frame_count
            self.tracker.only_tracking = old_tracker.only_tracking
        if self.db is not None:
            # Fresh map, fresh recognition index; the previous map's index
            # is kept for merge detection.
            self.db = KeyframeDatabase(self.voc)
            self.map_dbs[m.map_id] = self.db
            self.loop_closer = self._loop_closer(m, self.db)

    @property
    def inertial(self):
        return self.cfg.sensor.endswith("-inertial")

    def _build_stages(self, m):
        """The mapper and the tracker of map m; in an inertial session the
        inertial local BA replaces the visual one once the map is
        IMU-initialized."""
        self.local_mapper = LocalMapper(cfg=self.cfg.tracker, map=m,
                                        inertial_mode=self.inertial,
                                        on_kf_culled=self._on_kf_culled)
        self.tracker = self._build_tracker(m)
        self.local_mapper.timers = self.tracker.timers
        self.tracker.async_map = self.async_map
        if self.inertial:
            self.local_mapper.inertial_ba = self.tracker.local_inertial_ba

    def _loop_closer(self, m, db):
        return LoopCloser(cfg=self.cfg.tracker, map=m, db=db,
                          ba_mesh=self.ba_mesh, inertial=self.inertial,
                          uniforms_fn=self.loop_uniforms_fn)

    def _build_tracker(self, m):
        c = self.cfg
        kw = dict(local_mapper=self.local_mapper,
                  loop_closer=self._on_keyframe_for_loops,
                  relocalizer=self._relocalize,
                  on_tracking_lost=self._on_tracking_lost,
                  ransac_sets_fn=self.ransac_sets_fn)
        stereo_kw = dict(baseline=c.baseline, depth_factor=c.depth_factor)
        fisheye_kw = dict(R_rl=c.stereo_R_rl, t_rl=c.stereo_t_rl,
                          cfg_right=c.tracker_right,
                          depth_factor=c.depth_factor)
        if self.inertial:
            kw.update(calib=ImuCalib.make(
                noise_gyro=c.imu_noise_gyro, noise_acc=c.imu_noise_acc,
                walk_gyro=c.imu_walk_gyro, walk_acc=c.imu_walk_acc,
                freq=c.imu_freq, R_bc=c.imu_R_bc, t_bc=c.imu_t_bc,
                device=self.device), imu_init_times=c.imu_init_times)
        if c.sensor == "mono":
            return MonoTracker(c.tracker, m, **kw)
        if c.sensor == "mono-inertial":
            return InertialTracker(c.tracker, m, **kw)
        if c.sensor == "rgbd-inertial":
            return RgbdInertialTracker(c.tracker, m, **stereo_kw, **kw)
        if c.sensor == "stereo-inertial" and c.tracker.is_kb8:
            return FisheyeStereoInertialTracker(c.tracker, m, **fisheye_kw,
                                                **kw)
        if c.sensor == "stereo-inertial":
            return StereoInertialTracker(c.tracker, m, **stereo_kw, **kw)
        if c.sensor == "stereo" and c.tracker.is_kb8:
            return FisheyeStereoTracker(c.tracker, m, **fisheye_kw, **kw)
        return StereoTracker(c.tracker, m, **stereo_kw, **kw)

    # ------------------------------------------------------------------
    def _ensure_vocabulary(self):
        if self.voc is not None or not self.cfg.enable_loop_closing:
            return
        m = self.atlas.active_map
        if self.cfg.vocabulary_path is None and m.n_kf < self.cfg.vocab_min_kfs:
            return
        kfs = np.nonzero(m.kf_valid)[0]
        if self.cfg.vocabulary_path is not None:
            # Pre-built vocabulary, shared across every map of the session.
            p = str(self.cfg.vocabulary_path)
            voc = (load_dbow2_text(p, device=self.device) if p.endswith(".txt")
                   else load_vocabulary(p, device=self.device))
        else:
            descs = np.concatenate([m.kf_desc[k][m.kf_kp_valid[k]] for k in kfs])
            voc = train_vocabulary(descs, k=self.cfg.vocab_k,
                                   L=self.cfg.vocab_L, seed=0,
                                   device=self.device)
        db = KeyframeDatabase(voc)
        for k in kfs:
            db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])
        if self.device.type == "cuda":
            # With the background worker this runs on its stream: the
            # vocabulary's tensors must be complete before the tracker
            # thread can reach them through self.voc / self.db.
            torch.cuda.current_stream(self.device).synchronize()
        self.voc = voc
        self.db = db
        self.map_dbs[m.map_id] = db
        self.loop_closer = self._loop_closer(m, db)

    def _on_keyframe_for_loops(self, kf: int) -> bool:
        self._ensure_vocabulary()
        if self.loop_closer is None:
            return False
        hit = self.loop_closer.process_keyframe(kf)
        if not hit and len(self.atlas.maps) > 1:
            hit = self._try_merge(kf)
        return hit

    def _try_merge(self, kf: int) -> bool:
        """Place recognition of keyframe kf of the active map against every
        stored map with a recognition index; a verified hit welds the active
        map into the stored one (LoopClosing::MergeLocal / MergeLocal2).
        With the background worker the verified merge is posted as an event
        and applied on the tracker thread (_drain_async_events)."""
        mA = self.atlas.active_map
        fix_scale = self.cfg.sensor != "mono"
        stage = self.tracker.timers.stage
        for mB in self.atlas.maps:
            if mB is mA:
                continue
            db = self.map_dbs.get(mB.map_id)
            if db is None or mB.n_kf == 0:
                continue
            cands = db.detect_relocalization_candidates(
                mA.kf_desc[kf], mA.kf_kp_valid[kf], n_best=3)
            for cand in cands:
                with stage("atlas/verify"):
                    sim3 = self.merger.verify(mA, kf, mB, int(cand),
                                              fix_scale=fix_scale)
                if sim3 is None:
                    continue
                if self.async_map is not None:
                    self.async_map.post_event("merge",
                                              (mA, kf, mB, int(cand), sim3))
                    return True
                with stage("atlas/merge"):
                    self._apply_merge(mA, self.merger.merge(mA, kf, mB, int(cand),
                                                            sim3))
                return True
        return False

    def _apply_merge(self, old_map, res):
        """Move the session onto the merged map: drop the absorbed map,
        rebind the pipeline stages, remap the tracker's frames, scale the
        kinematics by sigma, rewrite the trajectory rows and run the
        welding BA."""
        mB = res.target_map
        tr = self.tracker
        self.atlas.maps.remove(old_map)
        self.atlas.active = self.atlas.maps.index(mB)
        self.map_dbs.pop(old_map.map_id, None)

        # The target map's recognition index gains the transferred keyframes.
        self.db = self.map_dbs.get(mB.map_id)
        if self.db is not None:
            for j in res.kf_map.values():
                self.db.add(int(j), mB.kf_desc[j], mB.kf_kp_valid[j])
            self.loop_closer = self._loop_closer(mB, self.db)

        # The stages follow the new map.  The tracker's cached candidate
        # block is keyed on its map and rebuilt for map B.
        self.local_mapper.map = mB
        tr.map = mB

        def remap_lm(arr):
            ok = arr != NO_LM
            out = arr.copy()
            out[ok] = res.lm_map[np.clip(arr[ok], 0, old_map.max_lm - 1)]
            return out.astype(np.int32)

        # As in the reference, a frame's rel_ref (an id of map A) is left as
        # it is: _update_last_frame may resolve it in map B (ROADMAP §3).
        for f in (tr.last_frame, tr.init_ref):
            if f is not None and f.kp_lm is not None:
                f.kp_lm = remap_lm(f.kp_lm)
                if f.R_cw is not None:
                    f.R_cw = f.R_cw @ res.R_BA.T
                    f.t_cw = (res.sigma * f.t_cw - f.R_cw @ res.t_BA).astype(
                        np.float32)
                f.ref_kf = res.kf_map.get(f.ref_kf, -1)
        tr.ref_kf = res.kf_map.get(tr.ref_kf, max(res.kf_map.values()))
        if tr.velocity is not None:
            Rv, tv = tr.velocity
            tr.velocity = (Rv, (res.sigma * tv).astype(np.float32))
        tr._speed_hist = [v * res.sigma for v in tr._speed_hist]

        # The absorbed map's rows replay against the target map under the
        # merge transform: relative rotations are invariant, relative
        # translations scale by sigma.  Culled references climb their
        # redirect chain in the old map first (kf_map has live keyframes).
        rows = []
        for (ts, ref, Rrel, trel, state, ok, m) in tr.trajectory:
            if m is old_map:
                ref, Rrel, trel = old_map.resolve_kf(int(ref), Rrel, trel)
                if ref < 0:
                    continue
                rows.append((ts, res.kf_map.get(int(ref), 0), Rrel,
                             (res.sigma * trel).astype(np.float32), state, ok,
                             mB))
            else:
                rows.append((ts, ref, Rrel, trel, state, ok, m))
        tr.trajectory = rows

        # Welding BA (MergeLocal's welding window): the re-entry keyframe's
        # neighbourhood and the matched keyframe's, every far-side observer
        # fixed.  On an IMU-initialized merged map the inertial seam solve
        # (local inertial BA) runs first and the welding window then holds
        # the target side rigid, keeping its gravity-consistent structure.
        kf_new = tr.ref_kf
        nb_a, _ = mB.covisibility(kf_new, min_shared=1)
        window_a = np.concatenate([[kf_new], nb_a[: WELD_WINDOW - 1]])
        nb_b, _ = mB.covisibility(int(res.target_kf), min_shared=1)
        window_b = np.concatenate([[res.target_kf], nb_b[: WELD_WINDOW - 1]])
        inertial_weld = self.inertial and mB.imu_initialized
        with tr.timers.stage("atlas/welding_ba"):
            if inertial_weld:
                tr.local_inertial_ba(tr.ref_kf)
            self.local_mapper.welding_ba(window_a, window_b,
                                         fix_b=inertial_weld)

    # ------------------------------------------------------------------
    def _on_kf_culled(self, kf: int):
        """A keyframe was erased by LocalMapping: drop it from the
        recognition index and re-point the tracker if it was the reference."""
        if self.db is not None:
            self.db.erase(kf)
        tr = self.tracker
        m = self.atlas.active_map
        if tr.ref_kf == kf:
            live, _, _ = m.resolve_kf(kf, np.eye(3, dtype=np.float32),
                                      np.zeros(3, np.float32))
            tr.ref_kf = live if live >= 0 else int(np.nonzero(m.kf_valid)[0][-1])

    # ------------------------------------------------------------------
    # Relocalization cascade acceptance (Tracking.cc:3775,3797,3819):
    RELOC_ACCEPT = 50        # nGood for acceptance
    RELOC_RETRY_MIN = 30     # narrow re-search only when 30 < nGood < 50

    def _pnp_uniforms(self, n):
        if self.uniforms_fn is not None:
            return self._t(self.uniforms_fn(PNP_ITERS, n), torch.float32)
        return torch.rand((PNP_ITERS, n), generator=self._gen).to(self.device)

    def _relocalize(self, frame) -> bool:
        """BoW candidates + RANSAC PnP + the reference's widening
        refinement cascade (Tracking::Relocalization): PnP seeds a pose,
        PoseOptimization counts inliers; below 50 a wide guided search
        (th=10) adds matches and re-optimizes; if that lands in (30, 50) a
        narrow pass (th=3) runs once more.  A thinner PnP-only pose (>= 15)
        is the fallback when no candidate reaches 50."""
        if self.db is None:
            return False
        m = self.atlas.active_map
        cfg = self.cfg.tracker
        tr = self.tracker
        t = self._t
        with m.lock:
            cands = self.db.detect_relocalization_candidates(frame.desc,
                                                             frame.valid)
        self._reloc_best = 0
        for kf in cands:
            self.sys_stats["n_reloc_searched"] = (
                self.sys_stats.get("n_reloc_searched", 0) + 1)
            with m.lock:
                bound = m.kf_kp_lm[kf] != NO_LM
                idx, ok, _ = match_by_descriptor(
                    frame.dev("desc"), frame.dev("valid"), t(m.kf_desc[kf]),
                    t(m.kf_kp_valid[kf] & bound))
                idx, ok = _np(idx), _np(ok)
                if ok.sum() < 15:
                    continue
                lm = np.where(ok, m.kf_kp_lm[kf][idx], NO_LM)
                X = m.lm_pos[np.clip(lm, 0, m.max_lm - 1)]
                mask = (lm != NO_LM) & m.lm_valid[np.clip(lm, 0, m.max_lm - 1)]
                kf_lms = m.kf_kp_lm[kf]
                kf_lms = np.unique(kf_lms[kf_lms != NO_LM])
                kf_lms = kf_lms[m.lm_valid[kf_lms]]
            # A fisheye frame gives PnP its unprojected rays.
            out = ransac_pnp(
                cfg.project_fn, cfg.project_jac_fn, cfg.K, t(X),
                frame.dev("uv"), frame.dev("level"),
                t(mask.astype(np.float32)), self._pnp_uniforms(X.shape[0]),
                bearings=(cfg.unproject_fn(frame.dev("uv")) if cfg.is_kb8
                          else None))
            if not bool(out["success"].cpu()):
                continue
            frame.R_cw = _np(out["R"])
            frame.t_cw = _np(out["t"])
            inl = _np(out["inliers"]) & mask
            frame.kp_lm = np.where(inl, lm, NO_LM).astype(np.int32)
            n_good = tr._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
            if n_good < self.RELOC_ACCEPT and kf_lms.size >= 3:
                # Wide guided re-search around the optimized pose.
                self.sys_stats["n_reloc_research"] = (
                    self.sys_stats.get("n_reloc_research", 0) + 1)
                matched, _, _ = tr._match_against_landmarks(
                    frame, kf_lms, frame.R_cw, frame.t_cw, th=10.0,
                    wide_gates=True)
                free = frame.kp_lm == NO_LM
                frame.kp_lm = np.where(free, matched,
                                       frame.kp_lm).astype(np.int32)
                n_good = tr._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
                if self.RELOC_RETRY_MIN < n_good < self.RELOC_ACCEPT:
                    # Narrow final pass with the twice-refined pose.
                    self.sys_stats["n_reloc_narrow"] = (
                        self.sys_stats.get("n_reloc_narrow", 0) + 1)
                    matched, _, _ = tr._match_against_landmarks(
                        frame, kf_lms, frame.R_cw, frame.t_cw, th=3.0,
                        wide_gates=True)
                    free = frame.kp_lm == NO_LM
                    frame.kp_lm = np.where(free, matched,
                                           frame.kp_lm).astype(np.int32)
                    n_good = tr._optimize_frame_pose(frame, frame.R_cw,
                                                     frame.t_cw)
            if n_good >= self.RELOC_ACCEPT:
                frame.pose_ok = True
                self.sys_stats["n_reloc"] = self.sys_stats.get("n_reloc", 0) + 1
                return True
            if n_good >= 15 and self._reloc_best < n_good:
                self._reloc_best = n_good
                self._reloc_pose = (frame.R_cw.copy(), frame.t_cw.copy(),
                                    frame.kp_lm.copy())
        if self._reloc_best >= 15:
            frame.R_cw, frame.t_cw, frame.kp_lm = self._reloc_pose
            frame.pose_ok = True
            self._reloc_best = 0
            self.sys_stats["n_reloc_weak"] = (
                self.sys_stats.get("n_reloc_weak", 0) + 1)
            return True
        self._reloc_best = 0
        return False

    # ------------------------------------------------------------------
    def _on_tracking_lost(self):
        """Sustained loss: small maps reset in place, established maps are
        stored and a new one spawned (Tracking::CreateMapInAtlas)."""
        if self.async_map is not None:
            # The worker may still hold tasks against the outgoing map.
            self.async_map.flush()
        m = self.atlas.active_map
        if m.n_kf < self.cfg.min_kf_spawn:
            self.atlas.maps.remove(m)
            self.atlas.active = len(self.atlas.maps) - 1
            self.map_dbs.pop(m.map_id, None)
            # The discarded map's trajectory rows must not replay.
            m.kf_valid[:] = False
        self._new_active_map()

    MAX_TS_GAP = 1.0
    BAD_IMU_KFS = 20     # keyframes without IMU init => bad-IMU reset

    def _check_timestamp(self, timestamp) -> None:
        """A backward step or a forward gap > MAX_TS_GAP breaks the stream:
        store the map and spawn a fresh one; in localization-only mode drop
        the motion model and relocalize against the frozen map instead."""
        last = getattr(self, "_last_frame_ts", None)
        self._last_frame_ts = timestamp
        if last is None:
            return
        gap = timestamp - last
        if gap < 0 or gap > self.MAX_TS_GAP:
            tr = self.tracker
            if tr.state == TrackState.NOT_INITIALIZED:
                return
            self.sys_stats["n_ts_resets"] = self.sys_stats.get("n_ts_resets", 0) + 1
            if tr.only_tracking:
                tr.velocity = None
                tr.state = TrackState.RECENTLY_LOST
                tr.last_ok_ts = timestamp   # fresh grace period
                if self.inertial:
                    tr._pre_frame = None
                    tr._imu_log = []
                return
            self._on_tracking_lost()

    def _check_bad_imu(self, frame) -> None:
        """Bad-IMU watchdog: a map that keeps failing IMU initialization
        long past the point it should have succeeded has an unobservable
        scale; it is reset rather than left to grow unaligned."""
        if not self.inertial:
            return
        m = self.atlas.active_map
        tr = self.tracker
        if m.imu_initialized or tr.state != TrackState.OK:
            return
        first = tr._first_kf_ts
        if first is None:
            return
        if m.n_kf >= self.BAD_IMU_KFS and frame.timestamp - first > 10.0:
            self.sys_stats["n_bad_imu_resets"] = (
                self.sys_stats.get("n_bad_imu_resets", 0) + 1)
            self._on_tracking_lost()

    def _drain_async_events(self):
        """Apply the worker's effects on the tracker thread at a frame
        boundary; a crashed worker task raises here, within one frame."""
        if self.async_map is None:
            return
        errs = self.async_map.pop_errors()
        if errs:
            raise errs[0]
        for kind, payload in self.async_map.drain_events():
            if kind == "loop":
                # Poses moved under the corrected essential graph; the stale
                # velocity model would fight the corrected map.
                self.tracker.velocity = None
            elif kind == "merge":
                self._apply_async_merge(*payload)
            else:
                raise RuntimeError(f"unexpected mapping event {kind!r}")

    def _apply_async_merge(self, mA, kf, mB, cand, sim3):
        """A merge the worker verified.  Local BA and new keyframes may
        have moved both maps since, so the Sim3 is verified again against
        the current poses, under both maps' locks; a failed re-verify drops
        the merge (n_stale_merges).  As in the reference, the re-verify
        fixes the scale only for two IMU-initialized maps, where the
        synchronous path fixes it for every sensor but mono (ROADMAP §3)."""
        if mA is not self.atlas.active_map or mB not in self.atlas.maps:
            return
        self.async_map.flush()
        with mA.lock, mB.lock:
            fresh = self.merger.verify(
                mA, kf, mB, cand,
                fix_scale=mA.imu_initialized and mB.imu_initialized)
            if fresh is None:
                self.sys_stats["n_stale_merges"] = (
                    self.sys_stats.get("n_stale_merges", 0) + 1)
                return
            with self.tracker.timers.stage("atlas/merge"):
                self._apply_merge(mA, self.merger.merge(mA, kf, mB, cand, fresh))
            self.tracker.velocity = None

    def _timed(self, process, timestamp, *args):
        """One frame through the tracker: the worker's events first, the
        timestamp guard, then the frame's wall time, which ends when this
        thread's stream is done (not the worker's); then the bad-IMU
        watchdog of an inertial session."""
        self._drain_async_events()
        self._check_timestamp(timestamp)
        t0 = time.perf_counter()
        frame = process(*args, timestamp)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.timings.append(time.perf_counter() - t0)
        self._check_bad_imu(frame)
        return frame

    def _entry(self, visual, inertial, imu):
        """The tracker's entry point, looked up when the frame runs (the
        timestamp guard may have spawned a map and its tracker); an
        inertial sensor's takes the frame's IMU rows."""
        if not self.inertial:
            return lambda *a: getattr(self.tracker, visual)(*a)
        rows = NO_IMU if imu is None else imu
        return lambda *a: getattr(self.tracker, inertial)(*a, rows)

    def track_monocular(self, img, timestamp, imu=None):
        """System::TrackMonocular: one image (numpy uint8/float32 array or a
        tensor) at `timestamp` seconds; for mono-inertial, imu = the (M, 7)
        rows [dt, ax ay az, gx gy gz] covering (t_prev, t].  Returns the
        Frame."""
        return self._timed(self._entry("process", "process_inertial", imu),
                           timestamp, img)

    def track_stereo(self, img_left, img_right, timestamp, imu=None):
        """System::TrackStereo: a left/right pair, rectified or, with a kb8
        lens, a non-rectified fisheye pair (and the IMU rows for
        stereo-inertial)."""
        return self._timed(self._entry("process_stereo",
                                       "process_stereo_inertial", imu),
                           timestamp, img_left, img_right)

    def track_rgbd(self, img, depth_map, timestamp, imu=None):
        """System::TrackRGBD: an image and its registered metric depth map
        (values <= 0 = no depth), and the IMU rows for rgbd-inertial."""
        return self._timed(self._entry("process_rgbd", "process_rgbd_inertial",
                                       imu), timestamp, img, depth_map)

    def flush(self):
        """Wait for the background worker to drain and apply its events (a
        no-op in synchronous mode).  Call before reading final state."""
        if self.async_map is not None:
            self.async_map.flush()
            self._drain_async_events()
            self.async_map.flush()

    def shutdown(self):
        """System::Shutdown: drain and stop the background worker."""
        if self.async_map is not None:
            self.flush()
            self.async_map.shutdown()

    def activate_localization_mode(self):
        """Track against the frozen map without mutating it
        (System::ActivateLocalizationMode)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode)."""
        self.tracker.only_tracking = False

    @property
    def state(self):
        return self.tracker.state

    def trajectory(self, with_map_ids=False):
        return self.tracker.final_trajectory(with_map_ids=with_map_ids)

    def save_trajectory_tum(self, path):
        """TUM format: ts tx ty tz qx qy qz qw."""
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                ts, x, y, z, qw, qx, qy, qz = r
                f.write(f"{ts:.6f} {x:.7f} {y:.7f} {z:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_euroc(self, path):
        """EuRoC format (System::SaveTrajectoryEuRoC): the TUM fields with
        integer-nanosecond stamps."""
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                ts, x, y, z, qw, qx, qy, qz = r
                f.write(f"{int(round(ts * 1e9))} {x:.7f} {y:.7f} {z:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_kitti(self, path):
        """KITTI format (System::SaveTrajectoryKITTI): per frame the 3x4
        T_wc row-major, no timestamps; the rotation in float32."""
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                _, x, y, z, qw, qx, qy, qz = r
                R = quat_to_matrix(torch.tensor([qw, qx, qy, qz],
                                                dtype=torch.float32)).numpy()
                vals = np.concatenate(
                    [np.concatenate([R[i], [(x, y, z)[i]]]) for i in range(3)])
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    def save_keyframe_trajectory_tum(self, path):
        """The active map's keyframe poses in TUM format, by timestamp
        (System::SaveKeyFrameTrajectoryTUM)."""
        m = self.atlas.active_map
        kfs = np.nonzero(m.kf_valid)[0]
        order = np.argsort(m.kf_timestamp[kfs])
        with open(path, "w") as f:
            for k in kfs[order]:
                R_wc = np.ascontiguousarray(np.asarray(m.kf_R[k], np.float32).T)
                t = -(R_wc @ np.asarray(m.kf_t[k], np.float32))
                q = matrix_to_quat(torch.as_tensor(R_wc)).numpy()
                f.write(f"{m.kf_timestamp[k]:.6f} "
                        f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def upload_image(self, img):
        """A camera image as a tensor on the session's device, accepted by
        every track_* entry in place of the host array: uint8 stays uint8,
        any other dtype becomes float32.  On the card the copy goes through
        pinned host memory, non-blocking, on the calling thread's current
        stream, the stream the tracker extracts on, so that it overlaps host
        work (decoding the next image) and is ordered before the extraction
        that reads it.  A tensor moves to the device as it is (the same
        tensor when it is there already)."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        a = np.asarray(img)
        host = torch.from_numpy(np.array(
            a, np.uint8 if a.dtype == np.uint8 else np.float32))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def print_time_stats(self):
        """The per-stage timing table (Tracking::PrintTimeStats)."""
        print(self.tracker.timers.report())

    # ------------------------------------------------------------------
    # The npz layout of the reference's checkpoint, key for key, so that a
    # checkpoint written by either package loads in the other.
    ATLAS_ARRAY_FIELDS = [
        "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp",
        "kf_kp_uv", "kf_kp_level", "kf_kp_angle", "kf_kp_valid",
        "kf_desc", "kf_kp_patch", "kf_kp_ur", "kf_kp_lm", "lm_pos",
        "lm_valid", "lm_desc", "lm_patch", "lm_normal", "lm_min_dist",
        "lm_max_dist", "lm_first_kf", "lm_visible", "lm_found",
        "kf_redirect", "kf_redirect_R", "kf_redirect_t",
        "kf_v", "kf_bias",
    ]

    def save_atlas(self, path):
        """Whole-session checkpoint (System::SaveAtlas): every map's tables
        (``map{i}/<field>``, ``map{i}/scalars``), the vocabulary with its
        checksum (``voc/*``, ``voc/md5``), the active map's loop edges and,
        in an inertial session, the tracker's IMU state (``imu/*``: bias,
        stage, the keyframe interval chain and the raw log), so that a
        reloaded session continues IMU-initialized."""
        self.flush()
        payload = {"n_maps": np.int64(len(self.atlas.maps)),
                   "active": np.int64(self.atlas.active)}
        for i, m in enumerate(self.atlas.maps):
            for f_ in self.ATLAS_ARRAY_FIELDS:
                payload[f"map{i}/{f_}"] = getattr(m, f_)
            payload[f"map{i}/scalars"] = np.asarray(
                [m.n_kf, m.n_lm, m.next_lm, m.change_idx, m.map_id,
                 m.next_kf, int(m.imu_initialized), int(m.imu_ba2)])
        # The inverted file is rebuilt at load from the vocabulary and the
        # keyframe descriptors; what persists and binds is the vocabulary.
        if self.voc is not None:
            for k, v in vocabulary_arrays(self.voc).items():
                payload[f"voc/{k}"] = v
            payload["voc/md5"] = np.frombuffer(
                vocabulary_checksum(self.voc).encode(), np.uint8)
        if self.loop_closer is not None and self.loop_closer.loop_edges:
            payload["loop_edges"] = np.asarray(self.loop_closer.loop_edges,
                                               np.int64)
        if self.inertial:
            payload.update(self._imu_payload())
        np.savez_compressed(path, **payload)

    def _imu_payload(self):
        tr = self.tracker
        out = {"imu/bias": np.asarray(tr.bias, np.float32),
               "imu/stage": np.int64(tr.imu_stage)}

        def ragged(name, keys, chunks):
            chunks = [np.asarray(c, np.float32).reshape(-1, 7) for c in chunks]
            offs = np.cumsum([0] + [c.shape[0] for c in chunks])
            out[f"imu/{name}_rows"] = (np.concatenate(chunks) if chunks
                                       else np.zeros((0, 7), np.float32))
            out[f"imu/{name}_offs"] = offs.astype(np.int64)
            return keys

        if tr.kf_imu:
            kf_ids = np.asarray(sorted(tr.kf_imu), np.int64)
            out["imu/chain_kf"] = ragged("chain", kf_ids,
                                         [tr.kf_imu[k][1] for k in kf_ids])
            out["imu/chain_prev"] = np.asarray([tr.kf_imu[k][0]
                                                for k in kf_ids], np.int64)
        if tr._imu_log:
            out["imu/log_ts"] = ragged(
                "log", np.asarray([t for t, _ in tr._imu_log], np.float64),
                [r for _, r in tr._imu_log])
        return out

    def load_atlas(self, path):
        """Rebuild the Atlas from a checkpoint; the active map resumes by
        relocalization (System::LoadAtlas).  The stored vocabulary is
        restored, never retrained, and bound by checksum to a configured
        vocabulary file; the recognition index is rebuilt from it."""
        data = np.load(path, allow_pickle=False)
        self.atlas = Atlas()
        for i in range(int(data["n_maps"])):
            m = MapState(max_kf=data[f"map{i}/kf_valid"].shape[0],
                         max_kp=data[f"map{i}/kf_desc"].shape[1],
                         max_lm=data[f"map{i}/lm_pos"].shape[0])
            for f_ in self.ATLAS_ARRAY_FIELDS:
                key = f"map{i}/{f_}"
                if key in data:
                    setattr(m, f_, data[key].copy())
            sc = data[f"map{i}/scalars"]
            m.n_kf, m.n_lm, m.next_lm, m.change_idx, m.map_id = (
                int(sc[0]), int(sc[1]), int(sc[2]), int(sc[3]), int(sc[4]))
            m.next_kf = int(sc[5]) if sc.size > 5 else int(m.n_kf)
            if sc.size > 7:
                m.imu_initialized = bool(sc[6])
                m.imu_ba2 = bool(sc[7])
            self.atlas.maps.append(m)
        self.atlas.active = int(data["active"])
        m = self.atlas.active_map
        self._build_stages(m)
        if self.inertial:
            self._restore_imu_state(data)
        self.tracker.state = (TrackState.NOT_INITIALIZED if m.n_kf == 0
                              else TrackState.RECENTLY_LOST)
        if not m.n_kf:
            return
        self.tracker.ref_kf = int(np.nonzero(m.kf_valid)[0][-1])
        self.voc = None
        self.db = None
        self.loop_closer = None
        if "voc/kind" in data:
            self._restore_vocabulary(data)
        else:
            self._ensure_vocabulary()
        if self.loop_closer is not None and "loop_edges" in data:
            self.loop_closer.loop_edges = [(int(a), int(b))
                                           for a, b in data["loop_edges"]]
        # A last frame at the newest keyframe, so that tracking has a pose.
        ref = self.tracker.ref_kf
        lf = Frame(frame_id=-1, timestamp=float(m.kf_timestamp[ref]),
                   uv=m.kf_kp_uv[ref].copy(), level=m.kf_kp_level[ref].copy(),
                   angle=m.kf_kp_angle[ref].copy(),
                   response=np.zeros(m.max_kp, np.float32),
                   desc=m.kf_desc[ref].copy(), valid=m.kf_kp_valid[ref].copy(),
                   device=self.device)
        lf.R_cw = m.kf_R[ref].copy()
        lf.t_cw = m.kf_t[ref].copy()
        lf.pose_ok = True
        self.tracker.last_frame = lf

    def _restore_imu_state(self, data):
        """The tracker's inertial state from the checkpoint's imu/* keys."""
        tr = self.tracker
        if "imu/bias" in data:
            tr.bias = data["imu/bias"].copy()
        if "imu/stage" in data:
            tr.imu_stage = int(data["imu/stage"])
        if "imu/chain_kf" in data:
            prev, rows, offs = (data[f"imu/chain_{k}"]
                                for k in ("prev", "rows", "offs"))
            tr.kf_imu = {int(k): (int(prev[i]), rows[offs[i]:offs[i + 1]].copy())
                         for i, k in enumerate(data["imu/chain_kf"])}
        if "imu/log_ts" in data:
            rows, offs = data["imu/log_rows"], data["imu/log_offs"]
            tr._imu_log = [(float(t), rows[offs[i]:offs[i + 1]].copy())
                           for i, t in enumerate(data["imu/log_ts"])]

    def _restore_vocabulary(self, data):
        """Vocabulary, database and loop closer from the checkpoint's
        stored vocabulary, with the checksum binding (System.cc:1508): a
        corrupt copy, or a configured vocabulary file with other content,
        raises ValueError."""
        z = {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith("voc/")}
        stored_md5 = bytes(z.pop("md5")).decode() if "md5" in z else None
        self.voc = vocabulary_from_arrays(z, device=self.device)
        if stored_md5 and vocabulary_checksum(self.voc) != stored_md5:
            raise ValueError("atlas checkpoint is corrupt: vocabulary content "
                             "does not match its stored checksum")
        if self.cfg.vocabulary_path is not None and stored_md5:
            p = str(self.cfg.vocabulary_path)
            cur = (load_dbow2_text(p, device=self.device) if p.endswith(".txt")
                   else load_vocabulary(p, device=self.device))
            if vocabulary_checksum(cur) != stored_md5:
                raise ValueError(
                    "vocabulary checksum mismatch: the checkpoint was built "
                    f"with a different vocabulary than {p}")
        m = self.atlas.active_map
        self.db = KeyframeDatabase(self.voc)
        self.map_dbs = {m.map_id: self.db}
        self.loop_closer = self._loop_closer(m, self.db)
        for k in np.nonzero(m.kf_valid)[0]:
            self.db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])

    def stats(self):
        m = self.atlas.active_map
        return dict(
            n_frames=self.tracker.stats["n_frames"],
            n_maps=len(self.atlas.maps),
            n_kf=int(m.kf_valid.sum()),
            n_lm=int(m.lm_valid.sum()),
            track_fail=self.tracker.stats["track_fail"],
            mapper=self.local_mapper.stats,
            loops=self.loop_closer.stats if self.loop_closer else {},
            mean_frame_ms=1e3 * float(np.mean(self.timings)) if self.timings else 0.0,
            stages=self.tracker.timers.summary())
