"""The port's RGB-D-inertial session against the JAX reference.

``test_rgbd_inertial_pipeline``'s trajectory and world (seed 13) cut to 11
frames: with ``TrackerConfig(fps=3)``, the init schedule (0.6, 0.9, 1.2) s
and a 0.25 s keyframe spacing the fixed-scale IMU init runs at frame 9, so
frame 10 is a pose-inertial split frame.  RGB-D initialization
draws no RANSAC sets: nothing is injected.
"""

import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_inertial_pipeline import (assert_sessions_agree,
                                          inertial_scenario, run_session)

torch.set_num_threads(2)

N = 11
TIMES = (0.6, 0.9, 1.2)
SPACING = 0.25


def test_rgbd_inertial_session_matches_reference():
    """Per frame: the same state and IMU stage, camera centres within 2e-3
    m, bias within 1e-4 and the init scale (fixed: 1) within 1e-6; the IMU
    is initialized and split frames follow in both."""
    frames, traj = inertial_scenario(13, N, "rgbd-inertial")
    kw = dict(sensor="rgbd-inertial", imu_init_times=TIMES,
              enable_loop_closing=False)
    ref = run_session(JSlamSystem(JSystemConfig(
        tracker=JTrackerConfig(fps=3), **kw)), frames, traj, "rgbd-inertial",
        spacing=SPACING)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=3), device="cpu",
                                   **kw))
    port = run_session(slam, frames, traj, "rgbd-inertial", spacing=SPACING)
    assert ref[-1]["stage"] >= 1 and ref[-1]["scale"] == 1.0
    assert_sessions_agree(port, ref, scale_rtol=1e-6)
    assert slam.tracker.stats.get("split_frames", 0) >= 1
