"""The split tracking rounds (``TrackerConfig(fused_rounds=False)``) of the
port against the JAX reference.

The flow anchor, the motion-model match and the two local-map match <->
solve rounds run as separate steps, each match one K2 call (its plain
version here), on the 18-frame smoke scenario of test_torch_pipeline.py
(lateral textured world, seed 1, span 0.5) cut to 13 frames: the map
initializes at frame 7 and frames 8-12 take the split rounds.
"""

import numpy as np
import torch

from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_pipeline import _JaxKeyChain

torch.set_num_threads(2)

N = 13


def _session(slam, imgs):
    out = []
    for i, img in enumerate(imgs):
        f = slam.track_monocular(img, i * 0.1)
        out.append((slam.state.name, bool(f.pose_ok),
                    -f.R_cw.T @ f.t_cw if f.R_cw is not None else None))
    return out


def test_split_rounds_session_matches_reference():
    """With the reference's RANSAC draws injected: the same states and pose
    flags frame by frame and camera centres within 1e-3 (map units, median
    depth 1), the split rounds on every tracked frame (no fused frame)."""
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(18, x_span=0.5, z_span=0.0,
                                              y_amp=0.0)
    imgs = [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            for i in range(N)]
    ref = _session(JSlamSystem(JSystemConfig(
        tracker=JTrackerConfig(fps=10, fused_rounds=False),
        enable_loop_closing=False)), imgs)
    slam = SlamSystem(SystemConfig(
        tracker=TrackerConfig(fps=10, fused_rounds=False),
        enable_loop_closing=False, device="cpu"),
        ransac_sets_fn=_JaxKeyChain(0))
    port = _session(slam, imgs)
    n_ok = 0
    for i, ((sj, oj, cj), (sp, op, cp)) in enumerate(zip(ref, port)):
        assert (sp, op) == (sj, oj), i
        if cj is not None and sj == "OK":
            n_ok += 1
            assert np.abs(cp - cj).max() < 1e-3, (i, cp, cj)
    st = slam.tracker.stats
    assert n_ok >= 5 and st.get("split_frames", 0) >= 4
    assert st.get("fused_frames", 0) == 0
