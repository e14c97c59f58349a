"""The port's fisheye stereo-inertial session (the TUM-VI rig) against the
JAX reference: both packages' ``SlamSystem`` on the same frames and IMU
rows (the port on the CPU), held frame by frame.  The stereo rig
initializes from triangulated stereo points and draws no RANSAC sets:
nothing is injected.
"""

import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_fisheye_cuda import T_RL, fisheye_inertial_scenario, kb8_kw
from test_torch_inertial_pipeline import assert_sessions_agree, run_session

torch.set_num_threads(2)


def _count_split(tr, counter):
    """Count the local-map steps a tracker takes on the split rounds."""
    orig = tr._track_local_map

    def counting(frame):
        counter[0] += int(not tr._use_fused_rounds())
        return orig(frame)

    tr._track_local_map = counting


def test_stereo_inertial_fisheye_session_matches_reference():
    """The TUM-VI rig over a KB8 world on the reference inertial tests'
    path (seed 13), cut to 11 frames with TrackerConfig(fps=3), the init
    schedule (0.6, 0.9, 1.2) s and a 0.25 s keyframe spacing: the IMU init
    runs at frame 9 and split frames follow in both.  Per frame the same
    state and IMU stage, centres within 2e-3 m and bias within 1e-4; the
    init scale within 1e-4 relative of the reference's (measured on the
    CPU: 1.9e-5).  The reference estimates that scale instead of fixing it
    to 1 (its fix_scale is cfg.bf > 0, and a fisheye rig keeps bf = 0:
    ROADMAP.md section 3); the port keeps that behaviour."""
    frames, traj = fisheye_inertial_scenario(13, 11)
    kw = dict(sensor="stereo-inertial", imu_init_times=(0.6, 0.9, 1.2),
              stereo_t_rl=tuple(T_RL), enable_loop_closing=False)
    jslam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(**kb8_kw(fps=3)),
                                      **kw))
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(**kb8_kw(fps=3)),
                                   device="cpu", **kw))
    splits = [[0], [0]]
    _count_split(jslam.tracker, splits[0])
    _count_split(slam.tracker, splits[1])
    ref = run_session(jslam, frames, traj, "stereo-inertial", spacing=0.25)
    port = run_session(slam, frames, traj, "stereo-inertial", spacing=0.25)
    assert ref[-1]["stage"] >= 1 and ref[-1]["scale"] is not None
    assert_sessions_agree(port, ref, scale_rtol=1e-4)
    assert splits[0][0] >= 1 and splits[1][0] == splits[0][0]
    assert slam.tracker.stats.get("split_frames", 0) == splits[1][0]
