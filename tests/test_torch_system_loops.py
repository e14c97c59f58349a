"""The default configuration (loop closing on) of the torch port, end to
end on the CPU: tests/test_system_features.py's built_system scenario (26
frames of the lateral textured world, fps 10) through the port's
SlamSystem must meet the reference's walls.  Vocabulary, database and loop
closer come up; BoW relocalization recovers a fresh view of frame 12 and
reaches full acceptance on a kidnapped view of frame 14; localization-only
mode tracks without touching the map."""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.ops import orb
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def built_system():
    rng = np.random.default_rng(4)
    world = synthetic.make_textured_world(np.random.default_rng(8), depth=6.0)
    n = 26
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=1.2, z_span=0.0, y_amp=0.0)
    cfg = SystemConfig(tracker=TrackerConfig(fps=10), device="cpu")
    assert cfg.enable_loop_closing
    slam = SlamSystem(cfg)
    for i in range(n):
        img = synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
        slam.track_monocular(img, i * 0.1)
    assert slam.state == TrackState.OK
    return slam, world, R_gt, t_gt


def _make_frame(slam, world, R, t, seed=123):
    """A fresh view, features from the port's extractor (no pyramid)."""
    rng = np.random.default_rng(seed)
    img = synthetic.render_textured(world, R, t, rng=rng)
    feats = orb.extract_orb(torch.as_tensor(img), slam.cfg.tracker.orb_config)
    return Frame(frame_id=999, timestamp=99.0,
                 **{k: getattr(feats, k).numpy().copy() for k in
                    ("uv", "level", "angle", "response", "desc", "valid")})


def test_vocabulary_database_and_loop_closer(built_system):
    slam, *_ = built_system
    assert slam.voc is not None
    assert slam.db is not None and len(slam.db.vectors) >= 5
    assert slam.loop_closer is not None
    assert slam.loop_closer.stats["n_queries"] > 0
    stats = slam.stats()
    assert stats["loops"] is slam.loop_closer.stats
    assert "loop/detect_correct" in stats["stages"]


def test_relocalization_recovers_pose(built_system):
    slam, world, R_gt, t_gt = built_system
    frame = _make_frame(slam, world, R_gt[12], t_gt[12])
    assert slam._relocalize(frame), "relocalization failed"
    m = slam.atlas.active_map
    fid = np.nonzero(m.kf_valid)[0]
    src = m.kf_frame_id[fid]
    if (src == 12).any():
        c_kf = m.kf_center(fid[src == 12][0])
        c_fr = -(frame.R_cw.T @ frame.t_cw)
        assert np.linalg.norm(c_kf - c_fr) < 0.05, (c_kf, c_fr)


def test_relocalization_cascade_strong_acceptance(built_system):
    """Kidnapped camera (frame 14's view, another noise seed): the widening
    re-search cascade reaches the full 50-inlier acceptance."""
    slam, world, R_gt, t_gt = built_system
    slam.sys_stats.pop("n_reloc", None)
    slam.sys_stats.pop("n_reloc_weak", None)
    frame = _make_frame(slam, world, R_gt[14], t_gt[14], seed=321)
    assert slam._relocalize(frame), "cascade relocalization failed"
    assert slam.sys_stats.get("n_reloc", 0) >= 1, slam.sys_stats
    assert int((frame.kp_lm != NO_LM).sum()) >= 50


def test_localization_only_mode(built_system):
    """ActivateLocalizationMode freezes the map: tracking continues but no
    keyframe or landmark is created; the timestamp jump into the segment
    relocalizes instead of spawning a map."""
    slam, world, R_gt, t_gt = built_system
    m = slam.atlas.active_map
    slam.activate_localization_mode()
    try:
        n_kf, n_lm = int(m.kf_valid.sum()), int(m.lm_valid.sum())
        rng = np.random.default_rng(77)
        n_ok = 0
        for i in range(8, 14):
            img = synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            n_ok += bool(slam.track_monocular(img, 100.0 + 0.1 * i).pose_ok)
        assert n_ok >= 5, "localization mode lost tracking"
        assert int(m.kf_valid.sum()) == n_kf
        assert int(m.lm_valid.sum()) == n_lm
        assert len(slam.atlas.maps) == 1
        assert slam.sys_stats.get("n_ts_resets", 0) >= 1
    finally:
        slam.deactivate_localization_mode()
    assert not slam.tracker.only_tracking


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_prebuilt_vocabulary_path(tmp_path, fmt):
    """SystemConfig(vocabulary_path=...) loads the vocabulary at the first
    keyframe (no training wait) from a saved .npz or a DBoW2 text file, and
    the database indexes that keyframe."""
    from orb_slam3_study_kr_tpu_torch.bow import vocabulary as voc_mod

    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2, (400, 256)).astype(np.uint8)
    path = tmp_path / f"voc.{fmt}"
    if fmt == "npz":
        voc_mod.save_vocabulary(voc_mod.train_vocabulary(desc, k=4, L=2), path)
    else:
        with open(path, "w") as f:
            f.write("2 1 0 0\n")
            for w in (0.5, 0.7):
                f.write("0 1 " + " ".join(str(int(b)) for b in
                                          rng.integers(0, 256, 32)) + f" {w}\n")
    slam = SlamSystem(SystemConfig(vocabulary_path=str(path), device="cpu"))
    m = slam.atlas.active_map
    n = m.max_kp
    kf = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                        rng.uniform(0, 400, (n, 2)).astype(np.float32),
                        np.zeros(n, np.int32), np.zeros(n, np.float32),
                        np.ones(n, bool), desc[rng.integers(0, 400, n)], 0, 0.0)
    assert not slam._on_keyframe_for_loops(kf)
    assert slam.voc is not None and slam.voc.n_words == (16 if fmt == "npz" else 2)
    assert list(slam.db.vectors) == [kf]
    assert slam.loop_closer is not None
