"""The last tracker knobs of the reference (KLT off, ambiguous-observation
weights, the reference-keyframe flow anchor, the raw-patch ZNCC gate) on
the port, against the JAX reference.

Each knob's reference session runs the smoke scenario of
test_torch_pipeline.py (lateral textured world, seed 1, loop closing off)
up to frame K; its tracker state just before frame K is carried into the
port, which tracks frame K from it:

- ``klt_refine=False`` and ``ambig_obs_weight=0.5``: one fused frame
  (``_track_fused_frame``);
- ``refkf_anchor=True`` (with ``fused_frame=False``, so that the motion
  model's fused round with the anchor runs on every frame) and
  ``patch_zncc_min=0.3`` (which turns the fused rounds off): the motion
  model, then the local-map rounds.

Under ``-m slow`` the 18-frame sessions run through both packages with the
reference's RANSAC draws injected.  This file holds the KLT-off and ZNCC
knobs; test_torch_tracker_anchor.py the ambiguous-observation weights and
the reference-keyframe anchor (one file each would outgrow a minute).
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
from test_torch_pipeline import _capture, _JaxKeyChain

torch.set_num_threads(2)

N_FRAMES = 18
K_FRAME = 10
# knob -> (TrackerConfig fields, the steps frame K takes)
KNOBS = {
    "klt_off": (dict(klt_refine=False), "fused"),
    "ambig": (dict(ambig_obs_weight=0.5), "fused"),
    "refkf_anchor": (dict(refkf_anchor=True, fused_frame=False), "mm_local"),
    "patch_zncc": (dict(patch_zncc_min=0.3), "mm_local"),
}


def _frames(n):
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(N_FRAMES, x_span=0.5,
                                              z_span=0.0, y_amp=0.0)
    return [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            for i in range(n)]


@pytest.fixture(scope="module")
def frames():
    return _frames(K_FRAME + 1)


@pytest.fixture(scope="module", params=["klt_off", "patch_zncc"])
def reference(request, frames):
    return reference_run(request.param, frames)


def reference_run(knob, frames):
    """The reference's state before frame K and its result at frame K."""
    kw, kind = KNOBS[knob]
    slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10, **kw),
                                     enable_loop_closing=False))
    tr = slam.tracker
    rec = {}
    name = "_track_fused_frame" if kind == "fused" else "_track_local_map"
    orig_mm = tr._track_motion_model
    orig = getattr(tr, name)

    def recording_mm(frame):
        ok = orig_mm(frame)
        if frame.frame_id == K_FRAME:
            rec.setdefault("mm_ok", ok)
        return ok

    def recording(frame, *a, **k):
        n = orig(frame, *a, **k)
        if frame.frame_id == K_FRAME and "n" not in rec:
            rec.update(n=n, R=np.array(frame.R_cw), t=np.array(frame.t_cw),
                       kp_lm=frame.kp_lm.copy())
        return n

    tr._track_motion_model = recording_mm
    setattr(tr, name, recording)
    state = None
    for i, img in enumerate(frames):
        if i == K_FRAME:
            state = _capture(slam)
        slam.track_monocular(img, i * 0.1)
    return knob, state, rec


def test_knob_frame_from_carried_state(reference, frames):
    """Frame K from the reference's state: pose within 1e-4 (map units,
    rotation entries), inliers within 1 %, >= 99 % of bindings equal."""
    check_carried_frame(*reference, frames)


def check_carried_frame(knob, state, rec, frames):
    kw, kind = KNOBS[knob]
    assert rec.get("n") is not None and rec["n"] > 25, rec.get("n")
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10, **kw),
                                   enable_loop_closing=False, device="cpu"))
    tr = slam.tracker
    convert.tracker_state_from_numpy(tr, **state)
    frame = tr._extract_frame(frames[K_FRAME], K_FRAME * 0.1)
    assert frame.frame_id == K_FRAME
    assert (frame.pyr is None) == (not tr.cfg.klt_refine)
    tr._update_last_frame()
    if kind == "fused":
        n = tr._track_fused_frame(frame)
        assert tr.stats.get("fused_frames", 0) == 1
    else:
        assert rec["mm_ok"]
        assert tr._track_motion_model(frame)
        n = tr._track_local_map(frame)
        assert (tr.stats.get("split_frames", 0) == 1) == (knob == "patch_zncc")
    assert n is not None
    assert abs(n - rec["n"]) <= 0.01 * rec["n"], (n, rec["n"])
    np.testing.assert_allclose(frame.R_cw, rec["R"], atol=1e-4)
    np.testing.assert_allclose(frame.t_cw, rec["t"], atol=1e-4)
    both = (frame.kp_lm != NO_LM) | (rec["kp_lm"] != NO_LM)
    assert (frame.kp_lm[both] == rec["kp_lm"][both]).mean() >= 0.99


def _session(slam, imgs):
    states = []
    for i, img in enumerate(imgs):
        f = slam.track_monocular(img, i * 0.1)
        states.append((slam.state.name, bool(f.pose_ok)))
    return states, slam.trajectory()


@pytest.mark.slow
@pytest.mark.parametrize("knob", ["klt_off", "patch_zncc"])
def test_knob_session_matches_reference(knob):
    """The 18-frame session with each knob through both packages, the
    reference's RANSAC draws injected (see check_session)."""
    check_session(knob)


def check_session(knob):
    """The same state and pose flag frame by frame, and a scaled ATE under
    test_mono_slam_smoke's wall (0.05) and under 1.6x the reference's (the
    margin of the repo's ATE walls).  Camera centres are not held frame by
    frame here: from the reference's carried state every frame 9-17 of
    these sessions agrees within 1e-5 in pose (test_knob_frame_from_
    carried_state's bar is 1e-4), but the two maps part by float rounding
    over their keyframes, and the centres of the last frames differ by up
    to 3.4e-3 (patch_zncc, frame 16) and 2.2e-3 (refkf_anchor, frame 17)
    on the CPU (torch 2.13, jax 0.9.0)."""
    kw, _ = KNOBS[knob]
    imgs = _frames(N_FRAMES)
    R_gt, t_gt = synthetic.lateral_trajectory(N_FRAMES, x_span=0.5,
                                              z_span=0.0, y_amp=0.0)
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    ref, ref_rows = _session(JSlamSystem(JSystemConfig(
        tracker=JTrackerConfig(fps=10, **kw), enable_loop_closing=False)), imgs)
    port, port_rows = _session(SlamSystem(SystemConfig(
        tracker=TrackerConfig(fps=10, **kw), enable_loop_closing=False,
        device="cpu"), ransac_sets_fn=_JaxKeyChain(0)), imgs)
    assert port == ref
    ts = np.arange(N_FRAMES) * 0.1
    (ate_p, nm_p, _), (ate_r, nm_r, _) = (
        ate_rmse(r[:, 0], r[:, 1:4], ts, centers, True)
        for r in (port_rows, ref_rows))
    assert nm_p == nm_r and nm_p >= 8
    assert ate_p < 0.05 and ate_p < 1.6 * ate_r, (ate_p, ate_r)
