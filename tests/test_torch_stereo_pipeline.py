"""Stereo and RGB-D sessions of the torch port against the JAX reference.

``test_stereo_slam_textured_lateral``'s scene (seed 3, baseline 0.11,
``TrackerConfig(fps=10)``, loop closing on) and ``test_rgbd_slam_textured``'s
(seed 7) run through both packages on the CPU from the same rendered
images.  Stereo and RGB-D initialization is immediate and metric and draws
no RANSAC sets, so nothing needs injecting: the two trajectories are held
frame by frame, without alignment.  The slow tier ports the e2e walls.
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState

torch.set_num_threads(2)

BASELINE = 0.11


def _stereo_pairs(n_traj, n, seed=3, x_span=1.0):
    """The first n rectified pairs of the lateral stereo scene."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(n_traj, x_span=x_span,
                                              z_span=0.0, y_amp=0.0)
    pairs = []
    for i in range(n):
        imgL = synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
        _, t_r = synthetic.stereo_right_pose(R_gt[i], t_gt[i], BASELINE)
        imgR = synthetic.render_textured(world, R_gt[i], t_r, rng=rng)
        pairs.append((imgL, imgR))
    return pairs, R_gt[:n], t_gt[:n]


def _rgbd_frames(n_traj, n, seed=7, x_span=0.7):
    rng = np.random.default_rng(seed)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(n_traj, x_span=x_span,
                                              z_span=0.0, y_amp=0.0)
    frames = []
    for i in range(n):
        img, depth = synthetic.render_textured(world, R_gt[i], t_gt[i],
                                               rng=rng, return_depth=True)
        frames.append((img, np.where(np.isfinite(depth), depth, 0.0)))
    return frames, R_gt[:n], t_gt[:n]


def _centers(R_gt, t_gt):
    return -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)


def _run(slam, sensor, data):
    for i, (a, b) in enumerate(data):
        if sensor == "stereo":
            slam.track_stereo(a, b, i * 0.1)
        else:
            slam.track_rgbd(a, b, i * 0.1)
    return slam


def _port(sensor):
    return SlamSystem(SystemConfig(sensor=sensor, baseline=BASELINE,
                                   tracker=TrackerConfig(fps=10), device="cpu"))


def _reference(sensor):
    return JSlamSystem(JSystemConfig(sensor=sensor, baseline=BASELINE,
                                     tracker=JTrackerConfig(fps=10)))


@pytest.mark.parametrize("sensor,n_traj,n", [("stereo", 30, 8),
                                             ("rgbd", 20, 6)])
def test_session_matches_reference(sensor, n_traj, n):
    """Per-frame camera centres within 2e-3 m of the reference's (no
    alignment: both are metric from the first frame), the same number of
    keyframes, state OK, and bf = fx * baseline in both configs."""
    data, R_gt, t_gt = (_stereo_pairs(n_traj, n) if sensor == "stereo"
                        else _rgbd_frames(n_traj, n))
    ref = _run(_reference(sensor), sensor, data)
    port = _run(_port(sensor), sensor, data)
    assert port.cfg.tracker.bf == ref.cfg.tracker.bf == 458.0 * BASELINE
    assert port.state == TrackState.OK and ref.state.name == "OK"
    assert port.stats()["n_kf"] == ref.stats()["n_kf"]
    a, b = port.trajectory(), ref.trajectory()
    assert a.shape == b.shape == (n, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    err = np.linalg.norm(a[:, 1:4] - b[:, 1:4], axis=1)
    assert err.max() < 2e-3, err
    rmse, nm, _ = ate_rmse(a[:, 0], a[:, 1:4], np.arange(n) * 0.1,
                           _centers(R_gt, t_gt), with_scale=False)
    assert nm == n and rmse < 0.15, rmse


@pytest.mark.slow
def test_stereo_slam_textured_lateral_port(tmp_path):
    """The reference's 30-frame stereo walls on the port: state OK, metric
    ATE < 0.15 over > 20 frames, scale within 10 % of 1, and a TUM row per
    frame."""
    n = 30
    data, R_gt, t_gt = _stereo_pairs(n, n)
    slam = _run(_port("stereo"), "stereo", data)
    assert slam.state == TrackState.OK, slam.stats()
    rows = slam.trajectory()
    ts = np.arange(n) * 0.1
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, _centers(R_gt, t_gt),
                           with_scale=False)
    assert nm > 20
    assert rmse < 0.15, rmse
    _, _, s_fit = ate_rmse(rows[:, 0], rows[:, 1:4], ts, _centers(R_gt, t_gt),
                           with_scale=True)
    assert abs(s_fit - 1.0) < 0.10, s_fit
    path = tmp_path / "traj.txt"
    slam.save_trajectory_tum(path)
    assert len(path.read_text().strip().splitlines()) == rows.shape[0]


@pytest.mark.slow
def test_rgbd_slam_textured_port():
    """The reference's 20-frame RGB-D walls: state OK, metric ATE < 0.15
    over > 12 frames."""
    n = 20
    data, R_gt, t_gt = _rgbd_frames(n, n)
    slam = _run(_port("rgbd"), "rgbd", data)
    assert slam.state == TrackState.OK, slam.stats()
    rows = slam.trajectory()
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1,
                           _centers(R_gt, t_gt), with_scale=False)
    assert nm > 12
    assert rmse < 0.15, rmse
