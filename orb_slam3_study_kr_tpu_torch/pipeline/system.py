"""Public session API, monocular route.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/system.py``
(``SystemConfig``, ``SlamSystem``): builds the map and the pipeline stages,
routes frames through ``track_monocular``, bootstraps the vocabulary and
the keyframe database, runs loop closing per keyframe, relocalizes lost
frames by BoW + RANSAC PnP with the widening re-search cascade, handles
sustained tracking loss (reset or new map) and the timestamp-jump guard,
and saves trajectories.  Every stage runs on ``SystemConfig.device``;
"cuda" (the default) raises when no card is present instead of running on
the CPU.

The relocalization PnP draws come from ``uniforms_fn(iters, n)`` when given
(tests inject the reference's jax.random stream), else from a
torch.Generator seeded 99, the reference's session PRNGKey.
"""

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.bow import (KeyframeDatabase, load_dbow2_text,
                                              load_vocabulary, train_vocabulary)
from orb_slam3_study_kr_tpu_torch.ops.track_match import match_by_descriptor
from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackerConfig,
                                                            TrackState)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, Atlas
from orb_slam3_study_kr_tpu_torch.solvers.pnp import ransac_pnp
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

PNP_ITERS = 256


@dataclass
class SystemConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    sensor: str = "mono"
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
    ba_devices: int = 0      # > 1: landmark-sharded global BA (not ported)
    async_mapping: bool = False
    device: str = "cuda"

    def check_supported(self):
        """Raise NotImplementedError for reference routes not ported yet."""
        if self.async_mapping:
            raise NotImplementedError(
                "SystemConfig.async_mapping=True: the background mapping "
                "worker is not ported yet (ROADMAP item 13a)")
        if self.ba_devices > 1:
            raise NotImplementedError(
                "SystemConfig.ba_devices > 1: the multi-device global BA is "
                "not ported yet (ROADMAP item 19)")
        if self.sensor != "mono":
            raise NotImplementedError(
                f"SystemConfig.sensor={self.sensor!r}: only 'mono' is ported; "
                "stereo/RGB-D is ROADMAP item 14, inertial item 15")
        if self.tracker.camera_model == "kb8":
            raise NotImplementedError(
                "camera_model='kb8': the fisheye model is not ported yet "
                "(ROADMAP item 16)")


def _np(t):
    return t.detach().cpu().numpy()


class SlamSystem:
    """SLAM session (System::TrackMonocular path)."""

    def __init__(self, cfg: SystemConfig = None, ransac_sets_fn=None,
                 uniforms_fn=None):
        self.cfg = cfg or SystemConfig()
        self.cfg.check_supported()
        self.device = resolve_device(self.cfg.device, "SystemConfig.device")
        self.cfg.tracker = dataclasses.replace(self.cfg.tracker,
                                               device=str(self.device))
        self.ransac_sets_fn = ransac_sets_fn
        self.uniforms_fn = uniforms_fn
        self._gen = torch.Generator(device=self.device).manual_seed(99)
        self.atlas = Atlas()
        self.voc = None
        self.db = None
        self.loop_closer = None
        self.map_dbs = {}        # map_id -> KeyframeDatabase
        self.timings = []
        self.sys_stats = {}
        self._new_active_map()

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _new_active_map(self):
        m = self.atlas.create_map(
            max_kf=self.cfg.max_kf,
            max_kp=self.cfg.tracker.orb_config.total_slots,
            max_lm=self.cfg.max_lm)
        old_tracker = getattr(self, "tracker", None)
        self.local_mapper = LocalMapper(cfg=self.cfg.tracker, map=m,
                                        on_kf_culled=self._on_kf_culled)
        self.tracker = self._build_tracker(m)
        self.local_mapper.timers = self.tracker.timers
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
            self.loop_closer = LoopCloser(cfg=self.cfg.tracker, map=m,
                                          db=self.db)

    def _build_tracker(self, m):
        return MonoTracker(self.cfg.tracker, m, local_mapper=self.local_mapper,
                           loop_closer=self._on_keyframe_for_loops,
                           relocalizer=self._relocalize,
                           on_tracking_lost=self._on_tracking_lost,
                           ransac_sets_fn=self.ransac_sets_fn)

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
            self.voc = (load_dbow2_text(p, device=self.device)
                        if p.endswith(".txt")
                        else load_vocabulary(p, device=self.device))
        else:
            descs = np.concatenate([m.kf_desc[k][m.kf_kp_valid[k]] for k in kfs])
            self.voc = train_vocabulary(descs, k=self.cfg.vocab_k,
                                        L=self.cfg.vocab_L, seed=0,
                                        device=self.device)
        self.db = KeyframeDatabase(self.voc)
        self.map_dbs[m.map_id] = self.db
        self.loop_closer = LoopCloser(cfg=self.cfg.tracker, map=m, db=self.db)
        for k in kfs:
            self.db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])

    def _on_keyframe_for_loops(self, kf: int) -> bool:
        self._ensure_vocabulary()
        if self.loop_closer is None:
            return False
        hit = self.loop_closer.process_keyframe(kf)
        if not hit and len(self.atlas.maps) > 1:
            hit = self._try_merge(kf)
        return hit

    def _try_merge(self, kf: int) -> bool:
        """Place recognition against stored maps (LoopClosing::MergeLocal)
        is not ported.  A stored map with a recognition index is where the
        reference would search for a merge, so that raises; stored maps
        without one (built before the vocabulary existed, or empty) give
        nothing to merge, as in the reference."""
        mA = self.atlas.active_map
        for mB in self.atlas.maps:
            if mB is mA or self.map_dbs.get(mB.map_id) is None or mB.n_kf == 0:
                continue
            raise NotImplementedError(
                "map merging against a stored map (pipeline/map_merging.py) "
                "is not ported yet (ROADMAP item 17)")
        return False

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
        return torch.rand((PNP_ITERS, n), generator=self._gen,
                          device=self.device)

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
            out = ransac_pnp(
                cfg.project_fn, cfg.project_jac_fn, cfg.K, t(X),
                frame.dev("uv"), frame.dev("level"),
                t(mask.astype(np.float32)), self._pnp_uniforms(X.shape[0]))
            if not bool(out["success"].cpu()):
                continue
            frame.R_cw = _np(out["R"])
            frame.t_cw = _np(out["t"])
            inl = _np(out["inliers"]) & mask
            frame.kp_lm = np.where(inl, lm, NO_LM).astype(np.int32)
            n_good = tr._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
            if n_good < self.RELOC_ACCEPT and kf_lms.size >= 3:
                # Wide guided re-search around the optimized pose.
                matched, _, _ = tr._match_against_landmarks(
                    frame, kf_lms, frame.R_cw, frame.t_cw, th=10.0,
                    wide_gates=True)
                free = frame.kp_lm == NO_LM
                frame.kp_lm = np.where(free, matched,
                                       frame.kp_lm).astype(np.int32)
                n_good = tr._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
                if self.RELOC_RETRY_MIN < n_good < self.RELOC_ACCEPT:
                    # Narrow final pass with the twice-refined pose.
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
        m = self.atlas.active_map
        if m.n_kf < self.cfg.min_kf_spawn:
            self.atlas.maps.remove(m)
            self.atlas.active = len(self.atlas.maps) - 1
            self.map_dbs.pop(m.map_id, None)
            # The discarded map's trajectory rows must not replay.
            m.kf_valid[:] = False
        self._new_active_map()

    MAX_TS_GAP = 1.0

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
                return
            self._on_tracking_lost()

    def track_monocular(self, img, timestamp):
        """System::TrackMonocular: one image (numpy uint8/float32 array or a
        tensor) at `timestamp` seconds.  Returns the Frame."""
        self._check_timestamp(timestamp)
        t0 = time.perf_counter()
        frame = self.tracker.process(img, timestamp)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings.append(time.perf_counter() - t0)
        return frame

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
