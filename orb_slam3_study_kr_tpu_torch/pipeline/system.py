"""Public session API, monocular route.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/system.py``
(``SystemConfig``, ``SlamSystem``): builds the map and the pipeline stages,
routes frames through ``track_monocular``, handles sustained tracking loss
(reset or new map) and the timestamp-jump guard, and saves trajectories.
Every stage runs on ``SystemConfig.device``; "cuda" (the default) raises
when no card is present instead of running on the CPU.
"""

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackerConfig,
                                                            TrackState)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import Atlas


@dataclass
class SystemConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    sensor: str = "mono"
    max_kf: int = 300
    max_lm: int = 80000
    enable_loop_closing: bool = True
    min_kf_spawn: int = 10
    async_mapping: bool = False
    device: str = "cuda"

    def check_supported(self):
        """Raise NotImplementedError for reference routes not ported yet."""
        if self.enable_loop_closing:
            raise NotImplementedError(
                "SystemConfig.enable_loop_closing=True: BoW place recognition "
                "and loop closing are not ported to the torch package yet "
                "(ROADMAP item 13); pass enable_loop_closing=False")
        if self.async_mapping:
            raise NotImplementedError(
                "SystemConfig.async_mapping=True: the background mapping "
                "worker is not ported yet (ROADMAP item 13)")
        if self.sensor != "mono":
            raise NotImplementedError(
                f"SystemConfig.sensor={self.sensor!r}: only 'mono' is ported; "
                "stereo/RGB-D is ROADMAP item 14, inertial item 15")
        if self.tracker.camera_model == "kb8":
            raise NotImplementedError(
                "camera_model='kb8': the fisheye model is not ported yet "
                "(ROADMAP item 16)")


def _resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SystemConfig.device={name!r} but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


class SlamSystem:
    """SLAM session (System::TrackMonocular path)."""

    def __init__(self, cfg: SystemConfig = None, ransac_sets_fn=None):
        self.cfg = cfg or SystemConfig()
        self.cfg.check_supported()
        self.device = _resolve_device(self.cfg.device)
        self.cfg.tracker = dataclasses.replace(self.cfg.tracker,
                                               device=str(self.device))
        self.ransac_sets_fn = ransac_sets_fn
        self.atlas = Atlas()
        self.timings = []
        self.sys_stats = {}
        self._new_active_map()

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

    def _build_tracker(self, m):
        return MonoTracker(self.cfg.tracker, m, local_mapper=self.local_mapper,
                           relocalizer=self._relocalize,
                           on_tracking_lost=self._on_tracking_lost,
                           ransac_sets_fn=self.ransac_sets_fn)

    def _on_kf_culled(self, kf: int):
        """Re-point the tracker if its reference keyframe was erased."""
        tr = self.tracker
        m = self.atlas.active_map
        if tr.ref_kf == kf:
            live, _, _ = m.resolve_kf(kf, np.eye(3, dtype=np.float32),
                                      np.zeros(3, np.float32))
            tr.ref_kf = live if live >= 0 else int(np.nonzero(m.kf_valid)[0][-1])

    def _relocalize(self, frame) -> bool:
        """BoW relocalization needs the place-recognition index, which the
        reference builds only with loop closing on; with it off (the only
        ported route) relocalization finds nothing, as in the reference."""
        return False

    def _on_tracking_lost(self):
        """Sustained loss: small maps reset in place, established maps are
        stored and a new one spawned."""
        m = self.atlas.active_map
        if m.n_kf < self.cfg.min_kf_spawn:
            self.atlas.maps.remove(m)
            self.atlas.active = len(self.atlas.maps) - 1
            m.kf_valid[:] = False
        self._new_active_map()

    MAX_TS_GAP = 1.0

    def _check_timestamp(self, timestamp) -> None:
        """A backward step or a forward gap > MAX_TS_GAP breaks the stream:
        store the map and spawn a fresh one."""
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
            loops={},
            mean_frame_ms=1e3 * float(np.mean(self.timings)) if self.timings else 0.0,
            stages=self.tracker.timers.summary())
