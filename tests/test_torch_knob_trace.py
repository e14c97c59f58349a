"""The ``patch_zncc_min=0.3`` session traced frame by frame (ROADMAP §3 O6).

The reference runs test_torch_tracker_knobs.py's 18-frame loop-off session
with the raw-patch ZNCC gate once; before every tracked frame its tracker
state (map tables, last frame, motion model, fused block) is captured.
The port starts each frame from that state, and from the reference local
mapper's recent landmarks and queue, and tracks it through
``MonoTracker.process``; the tracking state and pose flag must agree, and
the pose that frame writes into the trajectory must stay within
test_torch_tracker_knobs.py's bar (1e-4 in the rotation entries and the
translation) on a tracked frame, within the bundle-adjustment parity bar
(1e-3, tests/test_torch_solvers.py) on a keyframe, whose pose is the one
the in-line local BA leaves.  This separates what the port computes from a
frame from how the two sessions' maps part: each frame starts from the
reference's own map.  On the CPU (torch 2.13, jax 0.9.0) every frame but
17 agrees within 3.2e-7; frame 17, a keyframe, tracks within 8.5e-6 (the
pose solver's float32 sums), which moves one epipolar-gate decision of its
triangulation (a pair near the epipole: d2 3.70 against the gate 3.84 in
the port, 4.36 in the reference), so the port creates 62 landmarks where
the reference creates 61, and the local BA leaves the keyframe 8.2e-4
apart (ROADMAP §3 O6).
"""

import copy

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_pipeline import _capture
from test_torch_tracker_knobs import KNOBS, N_FRAMES, _frames

torch.set_num_threads(2)

POSE_TOL, KF_POSE_TOL = 1e-4, 1e-3
KW = KNOBS["patch_zncc"][0]


def _state(slam):
    """_capture, also where the motion model has no velocity yet."""
    tr = slam.tracker
    if tr.velocity is not None:
        return _capture(slam)
    tr.velocity = ()
    try:
        return dict(_capture(slam), velocity=None)
    finally:
        tr.velocity = None


@pytest.fixture(scope="module")
def trace():
    imgs = _frames(N_FRAMES)
    slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10, **KW),
                                     enable_loop_closing=False))
    tr, out, poses = slam.tracker, [], []
    record = tr._record_trajectory
    tr._record_trajectory = lambda f: (
        poses.append((np.array(f.R_cw), np.array(f.t_cw))), record(f))[1]
    for i, img in enumerate(imgs):
        state = None
        if tr.state.name == "OK":
            state = dict(tracker=_state(slam),
                         recent=copy.deepcopy(slam.local_mapper.recent),
                         queue=list(slam.local_mapper.queue))
        n_kf = tr.map.n_kf
        f = slam.track_monocular(img, i * 0.1)
        out.append(dict(state=state, after=tr.state.name, R=poses[i][0],
                        t=poses[i][1], pose_ok=bool(f.pose_ok),
                        keyframe=tr.map.n_kf > n_kf))
    return imgs, out


def test_every_tracked_frame_from_the_reference_state(trace):
    imgs, out = trace
    errs = {}
    for k, r in enumerate(out):
        if r["state"] is None:
            continue
        slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10, **KW),
                                       enable_loop_closing=False,
                                       device="cpu"))
        convert.tracker_state_from_numpy(slam.tracker, **r["state"]["tracker"])
        slam.local_mapper.recent = copy.deepcopy(r["state"]["recent"])
        slam.local_mapper.queue = list(r["state"]["queue"])
        f = slam.tracker.process(imgs[k], k * 0.1)
        assert slam.tracker.state.name == r["after"], k
        assert bool(f.pose_ok) == r["pose_ok"], k
        errs[k] = max(float(np.abs(f.R_cw - r["R"]).max()),
                      float(np.abs(f.t_cw - r["t"]).max()))
        assert errs[k] < (KF_POSE_TOL if r["keyframe"] else POSE_TOL), (
            k, r["keyframe"], errs)
    print("pose error per carried frame", errs)
    assert len(errs) >= N_FRAMES // 2
