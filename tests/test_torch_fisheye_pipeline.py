"""The port's fisheye (KB8, TUM-VI 512x512) sessions against the JAX
reference: monocular and the non-rectified stereo rig, each through both
packages' ``SlamSystem`` on the same frames (the port on the CPU), held
frame by frame.  The monocular bootstrap draws RANSAC sets, so the
reference's draws are injected (``ransac_sets_fn=``); the stereo rig
initializes from triangulated stereo points and draws none.  The slow
tier runs the reference's two fisheye walls
(``tests/test_fisheye_pipeline.py``) on the port.  The stereo-inertial
rig's session is ``test_torch_fisheye_inertial.py``.
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse, max_bound_theta_deg
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState
from test_torch_fisheye_cuda import (T_RL, kb8_kw, mono_fisheye_frames,
                                     stereo_fisheye_pairs)
from test_torch_pipeline import _JaxKeyChain

torch.set_num_threads(2)


def _record(slam, frame):
    c = (-frame.R_cw.T @ frame.t_cw if frame.R_cw is not None
         else np.full(3, np.nan))
    return slam.state.name, c


def _run(slam, frames, stereo):
    track = slam.track_stereo if stereo else slam.track_monocular
    return [_record(slam, track(*(f if stereo else (f,)), i * 0.1))
            for i, f in enumerate(frames)]


def _agree(port, ref, atol):
    """Per frame the same state and camera centres within atol."""
    assert len(port) == len(ref)
    for i, ((sp, cp), (sr, cr)) in enumerate(zip(port, ref)):
        assert sp == sr, (i, sp, sr)
        if np.isfinite(cr).all():
            err = np.abs(cp - cr).max()
            assert err < atol, (i, err)


def test_mono_fisheye_session_matches_reference():
    """The first 12 frames of test_mono_fisheye_slam: the bootstrap on the
    central 75-degree cone at frame 6 with the reference's RANSAC draws,
    then fused frames; per frame the same state and camera centres within
    1e-3 (map units, no alignment: the same gauge), the same keyframes
    (measured on the CPU: 1.2e-6)."""
    imgs, _, _ = mono_fisheye_frames(12)
    cfg = dict(enable_loop_closing=False)
    ref = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(**kb8_kw(fps=10)),
                                    **cfg))
    port = SlamSystem(SystemConfig(tracker=TrackerConfig(**kb8_kw(fps=10)),
                                   device="cpu", **cfg),
                      ransac_sets_fn=_JaxKeyChain(0))
    r, p = _run(ref, imgs, False), _run(port, imgs, False)
    assert r[-1][0] == "OK" and sum(s == "OK" for s, _ in r) >= 5
    _agree(p, r, 1e-3)
    assert port.stats()["n_kf"] == ref.stats()["n_kf"]
    assert port.tracker.stats.get("fused_frames", 0) >= 1


def test_stereo_fisheye_session_matches_reference():
    """The first 8 frames of test_stereo_fisheye_slam (t_rl = (-0.10, 0,
    0)): immediate metric initialization from the triangulated points, bf
    kept at 0 in both; per frame the same state and camera centres within
    2e-3 m, as the rectified sessions are held (measured on the CPU:
    2.4e-6)."""
    pairs, _, _ = stereo_fisheye_pairs(8)
    cfg = dict(sensor="stereo", stereo_t_rl=tuple(T_RL))
    ref = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(**kb8_kw(fps=10)),
                                    **cfg))
    port = SlamSystem(SystemConfig(tracker=TrackerConfig(**kb8_kw(fps=10)),
                                   device="cpu", **cfg))
    assert port.cfg.tracker.bf == ref.cfg.tracker.bf == 0.0
    r, p = _run(ref, pairs, True), _run(port, pairs, True)
    assert all(s == "OK" for s, _ in r)
    _agree(p, r, 2e-3)
    assert port.stats()["n_kf"] == ref.stats()["n_kf"]


@pytest.mark.slow
def test_mono_fisheye_slam_port():
    """test_mono_fisheye_slam's walls on the port: state OK, nm > 20,
    scaled ATE < 0.2, and a bound observation beyond the 75-degree
    bootstrap cone."""
    n = 30
    imgs, R_gt, t_gt = mono_fisheye_frames(n)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(**kb8_kw(fps=10)),
                                   device="cpu"))
    for i, img in enumerate(imgs):
        slam.track_monocular(img, i * 0.1)
    assert slam.state == TrackState.OK, slam.stats()
    rows = slam.trajectory()
    cen = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1, cen,
                           with_scale=True)
    assert nm > 20
    assert rmse < 0.2, rmse
    assert max_bound_theta_deg(slam) > 75.0


@pytest.mark.slow
def test_stereo_fisheye_slam_port():
    """test_stereo_fisheye_slam's walls on the port: state OK, nm > 15,
    metric ATE < 0.25 (no scale alignment)."""
    n = 25
    pairs, R_gt, t_gt = stereo_fisheye_pairs(n)
    slam = SlamSystem(SystemConfig(sensor="stereo", stereo_t_rl=tuple(T_RL),
                                   tracker=TrackerConfig(**kb8_kw(fps=10)),
                                   device="cpu"))
    for i, (left, right) in enumerate(pairs):
        slam.track_stereo(left, right, i * 0.1)
    assert slam.state == TrackState.OK, slam.stats()
    rows = slam.trajectory()
    cen = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1, cen,
                           with_scale=False)
    assert nm > 15
    assert rmse < 0.25, rmse
