"""The traffic generators give the same inputs for the same seed, and
different textures, not a different path, for another seed."""

import numpy as np
import pytest
import torch

from portbench import gbamap, harness, render

K = [[60.0, 0.0, 40.0], [0.0, 60.0, 30.0], [0.0, 0.0, 1.0]]


def _small_session(seed, baseline=None):
    traffic = harness.load_traffic("track")
    return render.render_session(traffic, K, 80, 60, 5, seed, "cpu",
                                 baseline=baseline, batch=2)


def test_frames_repeat_for_a_seed():
    a = _small_session(2 ** 31 + 5, baseline=0.11)
    b = _small_session(2 ** 31 + 5, baseline=0.11)
    assert torch.equal(a["left"], b["left"])
    assert torch.equal(a["right"], b["right"])
    assert a["left"].dtype == torch.uint8


def test_another_seed_changes_textures_not_the_path():
    a = _small_session(7)
    b = _small_session(2 ** 40 + 3)
    assert not torch.equal(a["left"], b["left"])
    np.testing.assert_array_equal(a["R_cw"], b["R_cw"])
    np.testing.assert_array_equal(a["t_cw"], b["t_cw"])


def test_right_camera_sits_at_the_baseline():
    a = _small_session(3, baseline=0.11)
    assert not torch.equal(a["left"], a["right"])


def test_path_moves_at_the_traffic_speed():
    traffic = harness.load_traffic("track")
    R, t, ts = render.camera_path(traffic["path"], traffic["fps"], 41)
    c = -np.einsum("nji,nj->ni", R, t)
    speed = (c[-1, 0] - c[0, 0]) / (ts[-1] - ts[0])
    assert speed == pytest.approx(traffic["path"]["speed_mps"])
    for Ri in R:
        np.testing.assert_allclose(Ri @ Ri.T, np.eye(3), atol=1e-12)


def _small_map(seed):
    traffic = harness.load_traffic("gba")
    traffic["map"].update(keyframes=32, obs_per_kf=64)
    intr = (458.654, 457.296, 367.215, 248.375, 752, 480)
    return traffic, gbamap.build(traffic, intr, 50.45194, 128, seed, "cpu")


def test_map_repeats_for_a_seed():
    _, a = _small_map(2 ** 31 + 9)
    _, b = _small_map(2 ** 31 + 9)
    for k in ("kf_R", "kf_t", "kf_kp_uv", "kf_kp_lm", "kf_kp_ur", "lm_pos"):
        np.testing.assert_array_equal(a[k], b[k])
    _, c = _small_map(4)
    assert not np.array_equal(a["lm_pos"], c["lm_pos"])


def test_map_structure_is_banded_on_a_ring():
    traffic, d = _small_map(11)
    g = traffic["map"]
    K, run = g["keyframes"], g["track_len"]
    assert d["M"] == K * g["obs_per_kf"] // run and d["O"] == d["M"] * run
    bound = d["kf_kp_lm"] >= 0
    assert (bound.sum(axis=1) == g["obs_per_kf"]).all()
    k, s = np.nonzero(bound)
    lm = d["kf_kp_lm"][k, s]
    assert (np.bincount(lm, minlength=d["M"]) == run).all()
    # Each landmark's keyframes are a run of consecutive ones, mod K.
    for m in range(0, d["M"], 97):
        kfs = np.sort(k[lm == m])
        first = m // (g["obs_per_kf"] // run)
        assert set(kfs) == {(first + i) % K for i in range(run)}
    # The gauge keyframes carry no drift.
    np.testing.assert_allclose(d["kf_R"][:2], d["true_R"][:2], atol=1e-6)
    np.testing.assert_allclose(d["kf_t"][:2], d["true_t"][:2], atol=1e-5)
    # Every landmark lies in front of every camera that observes it.
    p = np.einsum("oij,oj->oi", d["true_R"][k], d["true_X"][lm]) \
        + d["true_t"][k]
    assert (p[:, 2] > 0.0).all()


def test_snapshot_restores_the_map():
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
    _, d = _small_map(5)
    m = gbamap.to_map_state(MapState, d, 128)
    snap = gbamap.snapshot(m)
    m.kf_R[3] = 0
    m.kf_kp_lm[4, :10] = -1
    m.lm_valid[7] = False
    m.n_lm -= 1
    gbamap.restore(m, snap)
    np.testing.assert_array_equal(m.kf_R, d["kf_R"])
    np.testing.assert_array_equal(m.kf_kp_lm, d["kf_kp_lm"])
    assert m.lm_valid.all() and m.n_lm == d["M"]
