"""Relocalization of the torch port against a map the JAX reference built.

The reference runs tests/test_system_features.py's built_system scenario
(26 frames, default configuration); its map and vocabulary are carried into
a port SlamSystem with convert.session_map_from_numpy.  Both packages then
relocalize the same fresh view of frame 12 (features from the reference's
extractor, so the inputs are identical) with the same RANSAC PnP draws (the
reference session's key chain, injected into the port): the candidate list
and the inlier count must agree, and the pose within 1e-4.  The live
session's keyframe database is carried as it is: the reference adds the
keyframe that triggers vocabulary training twice, which doubles its counts
in the inverted file and changes the candidate list against a rebuilt one.
(Kept apart from tests/test_torch_system_loops.py so that each file stays
well under its time budget: the reference session alone takes about a
minute on the CPU.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.bow.vocabulary import vocabulary_arrays
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.ops import orb as jorb
from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.frame import Frame as JFrame
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.bow.vocabulary import vocabulary_checksum
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(4)
    world = synthetic.make_textured_world(np.random.default_rng(8), depth=6.0)
    n = 26
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=1.2, z_span=0.0, y_amp=0.0)
    slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10)))
    for i in range(n):
        slam.track_monocular(
            synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng), i * 0.1)
    assert slam.voc is not None and slam.state.name == "OK"
    m = slam.atlas.active_map
    tables = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in vars(m).items()
              if isinstance(v, (np.ndarray, int, float, bool))}
    img = synthetic.render_textured(world, R_gt[12], t_gt[12],
                                    rng=np.random.default_rng(123))
    feats = jorb.extract_orb(jnp.asarray(img, jnp.float32),
                             slam.cfg.tracker.orb_config)
    host = {k: np.array(getattr(feats, k)) for k in
            ("uv", "level", "angle", "response", "desc", "valid")}
    key0 = slam._key
    cands = slam.db.detect_relocalization_candidates(host["desc"],
                                                     host["valid"])
    frame = JFrame(frame_id=999, timestamp=99.0,
                   **{k: v.copy() for k, v in host.items()})
    ok = slam._relocalize(frame)
    db = dict(vectors={k: (w.copy(), v.copy())
                       for k, (w, v) in slam.db.vectors.items()},
              inv_file={w: list(kfs) for w, kfs in slam.db.inv_file.items()})
    return dict(tables=tables, voc=vocabulary_arrays(slam.voc), host=host, db=db,
                key0=key0, cands=cands, ok=ok, R=np.array(frame.R_cw),
                t=np.array(frame.t_cw), kp_lm=frame.kp_lm.copy(),
                sys_stats=dict(slam.sys_stats), ref_kf=slam.tracker.ref_kf)


class _JaxPnpDraws:
    """The reference session's relocalization draws: its key, one split per
    candidate that reaches RANSAC PnP."""

    def __init__(self, key):
        self.key = key

    def __call__(self, iters, n):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.uniform(sub, (iters, n)))


def _port_session(ref, **kw):
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), device="cpu"),
                      uniforms_fn=_JaxPnpDraws(ref["key0"]))
    return convert.session_map_from_numpy(slam, ref["tables"], ref["voc"],
                                          ref_kf=ref["ref_kf"], **kw)


def test_carried_map_and_vocabulary(reference):
    ref = reference
    slam = _port_session(ref)
    m = slam.atlas.active_map
    assert m.n_kf == ref["tables"]["n_kf"] and m.n_kf >= 5
    np.testing.assert_array_equal(m.lm_pos, ref["tables"]["lm_pos"])
    assert slam.state == TrackState.RECENTLY_LOST
    assert sorted(slam.db.vectors) == sorted(ref["db"]["vectors"])
    for k, (w, v) in ref["db"]["vectors"].items():
        np.testing.assert_array_equal(slam.db.vectors[k][0], w)
        np.testing.assert_allclose(slam.db.vectors[k][1], v, atol=1e-6)
    assert vocabulary_checksum(slam.voc) == vocabulary_checksum(
        convert.vocabulary_from_numpy(ref["voc"], device="cpu"))


def test_relocalization_on_carried_map_matches_reference(reference):
    """The same candidates, the same acceptance route and inlier count,
    the same bindings; pose within 1e-4."""
    ref = reference
    assert ref["ok"]
    slam = _port_session(ref, database=ref["db"])
    host = ref["host"]
    assert (slam.db.detect_relocalization_candidates(host["desc"], host["valid"])
            == ref["cands"])
    frame = Frame(frame_id=999, timestamp=99.0, device="cpu",
                  **{k: v.copy() for k, v in host.items()})
    assert slam._relocalize(frame)
    searched = slam.sys_stats.pop("n_reloc_searched")
    assert 1 <= searched <= len(ref["cands"])
    assert slam.sys_stats == ref["sys_stats"]
    n_good = int((frame.kp_lm != NO_LM).sum())
    assert n_good == int((ref["kp_lm"] != NO_LM).sum()) >= 15
    np.testing.assert_array_equal(frame.kp_lm, ref["kp_lm"])
    np.testing.assert_allclose(frame.R_cw, ref["R"], atol=1e-4)
    np.testing.assert_allclose(frame.t_cw, ref["t"], atol=1e-4)
