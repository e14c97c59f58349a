"""Inertial sessions and the Atlas, port against the JAX reference: the
bad-IMU watchdog, the inertial weld of a merge and checkpoints with the
IMU state (``imu/*`` keys).  The slow tier runs the reference's inertial
end-to-end walls through the port alone.
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
from test_torch_atlas import KF, _assert_atlas_equal, _two_maps
from test_torch_inertial_pipeline import inertial_scenario
from test_torch_pipeline import _JaxKeyChain

torch.set_num_threads(2)

DT_FRAME = 2.5      # seconds between the watchdog session's frames


def _dead_imu_session(slam, frames):
    """Frames of the lateral world 2.5 s apart with an all-zero IMU (no
    gravity, no excitation): the init gate refuses every attempt and, with
    BAD_IMU_KFS lowered to 3 and MAX_TS_GAP raised to 5 s on the instance,
    the watchdog resets the map at its third keyframe, 10 s after the
    first.  Returns per-frame (state, n_maps, resets, keyframes of the
    active map)."""
    slam.BAD_IMU_KFS = 3
    slam.MAX_TS_GAP = 5.0
    dead = np.zeros((20, 7), np.float32)
    dead[:, 0] = 1.0 / 200.0
    out = []
    for i, img in enumerate(frames):
        slam.track_monocular(img, i * DT_FRAME, imu=dead)
        out.append((slam.state.name, len(slam.atlas.maps),
                    slam.sys_stats.get("n_bad_imu_resets", 0),
                    int(slam.atlas.active_map.kf_valid.sum())))
    return out


def test_bad_imu_watchdog_as_reference():
    """The dead-IMU session through both packages (the reference's RANSAC
    draws injected): the map initializes, the IMU never does, and the
    watchdog resets the map at the same frame in both, with the same
    states and keyframe counts frame by frame."""
    rng = np.random.default_rng(4)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n = 9
    R_gt, t_gt = synthetic.lateral_trajectory(40, x_span=2.0, z_span=0.0,
                                              y_amp=0.0)
    frames = [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
              for i in range(n)]
    kw = dict(sensor="mono-inertial", imu_init_times=(1.0, 2.0, 3.0),
              enable_loop_closing=False)
    ref = _dead_imu_session(JSlamSystem(JSystemConfig(
        tracker=JTrackerConfig(fps=3), **kw)), frames)
    port = _dead_imu_session(SlamSystem(SystemConfig(
        tracker=TrackerConfig(fps=3), device="cpu", **kw),
        ransac_sets_fn=_JaxKeyChain(0)), frames)
    assert port == ref
    assert ref[-1][2] == 1 and max(r[3] for r in ref) >= 2


def _inertial_pair(pkg):
    """_two_maps' stored map B and active map A in one metric gauge (an
    inertial session merges at fixed scale), both IMU-initialized; map
    A's keyframes follow B's in time (timestamps 3, 4, 5 after 0, 1, 2),
    with keyframe velocities and a bias and an IMU log of a body at rest
    under gravity covering both, so that the merged map's local inertial
    BA has a chain to solve."""
    slam = _two_maps(pkg, sensor="mono-inertial", sigma=1.0)
    mB = slam.atlas.maps[0]
    mA = slam.atlas.active_map
    mA.kf_timestamp[:3] = np.array([3.0, 4.0, 5.0], np.float64)
    rng = np.random.default_rng(6)
    for m in (mA, mB):
        m.imu_initialized = True
        k = m.kf_valid
        m.kf_v[k] = rng.normal(0, 0.05, (int(k.sum()), 3)).astype(np.float32)
        m.kf_bias[k] = np.array([1e-3, -2e-3, 5e-4, 0.01, 0.0, -0.01],
                                np.float32)
    tr = slam.tracker
    tr.bias = np.array([1e-3, -2e-3, 5e-4, 0.01, 0.0, -0.01], np.float32)
    tr.imu_stage = 2
    rows = np.zeros((100, 7), np.float32)
    rows[:, 0] = 0.005
    rows[:, 3] = 9.81
    rows[:, 1:] += rng.normal(0, 0.01, (100, 6)).astype(np.float32)
    tr._imu_log = [(0.5 * (i + 1), rows.copy()) for i in range(10)]
    tr.kf_imu = {k: (k - 1, rows[:50].copy()) for k in (1, 2)}
    return slam


def test_inertial_weld_as_reference():
    """_try_merge -> _apply_merge between two IMU-initialized maps: the
    local inertial BA over the merged chain, then the welding BA with the
    target side held (fix_b).  One inertial BA and one welding BA in both;
    the welded keyframe poses, velocities, biases and landmarks within 1e-3
    of the reference; the tracker's bias within 1e-4."""
    out = {}
    for pkg in ("jax", "torch"):
        slam = _inertial_pair(pkg)
        assert slam._try_merge(KF)
        out[pkg] = slam
    js, ts = out["jax"], out["torch"]
    assert ts.tracker.stats.get("n_inertial_ba") == 1
    assert js.tracker.stats.get("n_inertial_ba") == 1
    assert ts.local_mapper.stats["n_welding_ba"] == 1
    mt, mj = ts.atlas.active_map, js.atlas.active_map
    assert len(ts.atlas.maps) == len(js.atlas.maps) == 1
    for f in ("kf_valid", "lm_valid", "kf_kp_lm"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), err_msg=f)
    for f in ("kf_R", "kf_t", "kf_v", "kf_bias", "lm_pos"):
        np.testing.assert_allclose(getattr(mt, f), getattr(mj, f), atol=1e-3,
                                   err_msg=f)
    np.testing.assert_allclose(ts.tracker.bias, js.tracker.bias, atol=1e-4)


def _imu_state(slam):
    tr = slam.tracker
    return (tr.bias, tr.imu_stage, sorted(tr.kf_imu), tr._imu_log, tr.kf_imu)


def _assert_imu_equal(a, b):
    (ba, sa, ka, la, ca), (bb, sb, kb, lb, cb) = _imu_state(a), _imu_state(b)
    np.testing.assert_array_equal(ba, bb)
    assert sa == sb and ka == kb and len(la) == len(lb)
    for (t1, r1), (t2, r2) in zip(la, lb):
        assert t1 == t2
        np.testing.assert_array_equal(r1, r2)
    for k in ka:
        assert ca[k][0] == cb[k][0]
        np.testing.assert_array_equal(ca[k][1], cb[k][1])


def test_inertial_checkpoint_roundtrip_and_across_packages(tmp_path):
    """An inertial session's checkpoint (the counterpart of
    test_serialization::test_inertial_session_roundtrip): port -> port and
    port -> JAX -> port, every array and the IMU state (bias, stage, the
    keyframe interval chain, the raw log) identical, the imu/* keys in the
    reference's layout, and the map's inertial flags restored."""
    slam = _inertial_pair("torch")
    p_port, p_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    slam.save_atlas(p_port)
    cfg = dict(sensor="mono-inertial")
    slam2 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                    device="cpu", **cfg))
    slam2.load_atlas(p_port)
    _assert_atlas_equal(slam, slam2)
    _assert_imu_equal(slam, slam2)
    assert slam2.atlas.active_map.imu_initialized
    assert slam2.local_mapper.inertial_ba == slam2.tracker.local_inertial_ba
    js = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10), **cfg))
    js.load_atlas(p_port)
    _assert_atlas_equal(slam, js)
    _assert_imu_equal(slam, js)
    js.save_atlas(p_jax)
    a, b = np.load(p_port), np.load(p_jax)
    assert sorted(a.files) == sorted(b.files)
    assert {"imu/bias", "imu/stage", "imu/chain_kf", "imu/chain_prev",
            "imu/chain_rows", "imu/chain_offs", "imu/log_ts", "imu/log_rows",
            "imu/log_offs"} <= set(a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    slam3 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                    device="cpu", **cfg))
    slam3.load_atlas(p_jax)
    _assert_atlas_equal(slam, slam3)
    _assert_imu_equal(slam, slam3)


def _inertial_wall_session(seed, n, sensor, extra=0):
    frames, traj = inertial_scenario(seed, n + extra, sensor)
    slam = SlamSystem(SystemConfig(
        sensor=sensor, imu_init_times=(2.5, 4.0, 5.0),
        tracker=TrackerConfig(fps=10), device="cpu"))
    track = slam.track_monocular if sensor == "mono-inertial" else slam.track_rgbd
    for i in range(n):
        track(*frames[i], traj["timestamps"][i], imu=traj["imu"][i])
    return slam, frames, traj


def _ate(slam, traj, n, with_scale):
    rows = slam.trajectory()
    R_gt, t_gt = traj["R_cw"][:n], traj["t_cw"][:n]
    cen = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], traj["timestamps"][:n],
                           cen, with_scale=with_scale)
    return rmse, nm


@pytest.mark.slow
def test_mono_inertial_pipeline_port():
    """test_mono_inertial_pipeline's walls on the port: state OK or
    RECENTLY_LOST, IMU stage >= 1, init scale in (1.5, 30), gyro bias
    within 3e-3, scaled ATE < 0.35 over > 40 frames."""
    slam, _, traj = _inertial_wall_session(11, 60, "mono-inertial")
    tr = slam.tracker
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
    assert tr.imu_stage >= 1
    s = tr.stats.get("imu_init_scale")
    assert s is not None and 1.5 < s < 30.0
    np.testing.assert_allclose(tr.bias[:3], traj["bias"][:3], atol=3e-3)
    rmse, nm = _ate(slam, traj, 60, True)
    assert nm > 40 and rmse < 0.35, (nm, rmse)


@pytest.mark.slow
def test_rgbd_inertial_pipeline_port():
    """test_rgbd_inertial_pipeline's walls on the port: IMU stage >= 1,
    init scale in (0.8, 1.25), metric ATE < 0.25 over > 35 frames."""
    slam, _, traj = _inertial_wall_session(13, 50, "rgbd-inertial")
    tr = slam.tracker
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
    assert tr.imu_stage >= 1
    s = tr.stats.get("imu_init_scale")
    assert s is not None and 0.8 < s < 1.25
    rmse, nm = _ate(slam, traj, 50, False)
    assert nm > 35 and rmse < 0.25, (nm, rmse)


@pytest.mark.slow
def test_imu_only_survival_while_recently_lost_port():
    """tests/test_robustness.py's IMU blackout on the port: after 60
    frames with the IMU initialized, 1.6 s of noise frames keep a
    dead-reckoned pose, RECENTLY_LOST, no map spawned, >= 10 IMU-only
    frames, drift < 1.5 ground-truth units scaled."""
    n = 60
    slam, _, traj = _inertial_wall_session(11, n, "mono-inertial", extra=16)
    tr = slam.tracker
    assert slam.state == TrackState.OK and tr.imu_stage >= 1
    n_maps = len(slam.atlas.maps)
    rng = np.random.default_rng(99)
    for i in range(n, n + 16):
        img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
        slam.track_monocular(img, traj["timestamps"][i], imu=traj["imu"][i])
    assert slam.state == TrackState.RECENTLY_LOST
    assert len(slam.atlas.maps) == n_maps
    assert tr.stats.get("imu_only_frames", 0) >= 10
    f = tr.last_frame
    assert f.R_cw is not None and np.isfinite(f.t_cw).all()
    R_gt, t_gt = traj["R_cw"], traj["t_cw"]
    c_gt = -R_gt[n + 15].T @ t_gt[n + 15]
    s = tr.stats.get("imu_init_scale", 1.0)
    assert np.linalg.norm(-f.R_cw.T @ f.t_cw - c_gt * s) < 1.5 * s
