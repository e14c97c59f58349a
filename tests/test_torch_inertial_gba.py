"""The loop closer's full inertial BA (``pipeline/global_ba.
global_inertial_bundle_adjustment``, ``solvers/inertial_ba`` with
``assembly="pcg"``) on the CPU at a small size: the PCG assembly against
the dense one, the entry against the plain reference of
``portbench/reference/vi_lm_schur.py``, the loop closer's route, and the
write-back of velocities and biases.  The map is the benchmark's
stereo-inertial ring (``portbench/vimap.py``) cut to 64 keyframes of 64
observations (512 landmarks), with its 200 Hz IMU log."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline import global_ba as j_global_ba
from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser as JLoopCloser
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    preintegrate_batch, preintegrate_batch_scan)
from orb_slam3_study_kr_tpu_torch.io.settings import Settings
from orb_slam3_study_kr_tpu_torch.pipeline import global_ba, inertial_tracking
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import inertial_bundle_adjust
from portbench import vimap
from portbench.reference import lm_schur, vi_lm_schur

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 12345


@functools.lru_cache(maxsize=None)
def _setup(K=64):
    st = Settings(os.path.join(ROOT, "portbench/configs/"
                               "euroc_stereo_inertial.yaml"))
    tc = st.tracker_config(device="cpu")
    with open(os.path.join(ROOT, "portbench/traffic/vigba.json")) as f:
        tr = json.load(f)
    tr["map"].update(keyframes=K, obs_per_kf=64)
    data = vimap.build(tr, (tc.fx, tc.fy, tc.cx, tc.cy, tc.width, tc.height),
                       tc.bf, tc.orb_config.total_slots, SEED, "cpu",
                       st.imu_params())
    log = vimap.ImuLog(data["imu_stamps"], data["imu_rows"])
    imu = global_ba.ImuIntervals(st.imu_calib(device="cpu"), log.rows_between)
    return tc, data, imu


def _map(data, tc):
    return vimap.to_map_state(MapState, data, tc.orb_config.total_slots)


@pytest.fixture
def force_pcg(monkeypatch):
    """The PCG assembly at the test's size (the cell's map is far above
    the dense threshold)."""
    monkeypatch.setattr(global_ba, "DENSE_CROSS_BLOCK_FLOATS", 0)


def _problem64(data, tc):
    """The snapshot as float64 solver arguments: body states, the
    observations in slot order, the chain's intervals preintegrated by the
    port in float64."""
    K = data["K"]
    R_cb = data["R_bc"].T
    t_cb = -R_cb @ data["t_bc"]
    Rwb, pwb = vi_lm_schur.camera_to_body(
        data["kf_R"].astype(np.float64), data["kf_t"].astype(np.float64),
        data["R_bc"], data["t_bc"])
    k, s = np.nonzero(data["kf_kp_lm"] >= 0)
    fixed = np.zeros(K)
    fixed[0] = 1.0
    D = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    T = lambda a: torch.as_tensor(np.asarray(a))               # noqa: E731
    rows = D(data["imu_rows"])
    f = data["freq"]
    sig = (data["noise_gyro"] * f ** 0.5, data["noise_acc"] * f ** 0.5,
           data["walk_gyro"] / f ** 0.5, data["walk_acc"] / f ** 0.5)
    return dict(Rwb=D(Rwb), pwb=D(pwb), v=D(data["kf_v"]),
                b=D(data["kf_bias"]), fixed=D(fixed), fixed_vb=D(np.zeros(K)),
                X=D(data["lm_pos"]), op=T(k), ol=T(data["kf_kp_lm"][k, s]),
                uv=D(data["kf_kp_uv"][k, s]),
                level=T(data["kf_kp_level"][k, s]),
                ur=D(data["kf_kp_ur"][k, s]), R_cb=D(R_cb), t_cb=D(t_cb),
                ei=T(np.arange(K - 1)), ej=T(np.arange(1, K)), rows=rows,
                sig=sig)


def _port64(p, tc, **kw):
    """inertial_bundle_adjust in float64 on _problem64's arguments."""
    E = p["ei"].shape[0]
    rows = p["rows"]
    calib = _setup()[2].calib
    pre = preintegrate_batch(rows[..., 1:4], rows[..., 4:7], rows[..., 0],
                             torch.ones(rows.shape[:2], dtype=torch.float64),
                             p["b"][p["ei"]], calib)
    cam = torch.tensor([tc.fx, tc.fy, tc.cx, tc.cy, 0, 0, 0, 0, 0],
                       dtype=torch.float64)
    one = lambda n: torch.ones(n, dtype=torch.float64)  # noqa: E731
    out = inertial_bundle_adjust(
        functools.partial(pinhole.project, cam),
        functools.partial(pinhole.project_jac, cam), p["Rwb"], p["pwb"],
        p["v"], p["b"], p["fixed"], p["R_cb"], p["t_cb"], p["X"],
        one(p["X"].shape[0]), p["op"], p["ol"], p["uv"], p["level"],
        one(p["op"].shape[0]), p["ei"], p["ej"], pre, one(E),
        fixed_vb=p["fixed_vb"], obs_ur=p["ur"], bf=tc.bf, **kw)
    return [o.numpy() for o in out]


def _ref64(p, tc, **kw):
    return vi_lm_schur.solve(
        p["Rwb"], p["pwb"], p["v"], p["b"], p["fixed"], p["fixed_vb"], p["X"],
        p["op"], p["ol"], p["uv"], p["level"], p["ur"], p["R_cb"], p["t_cb"],
        (tc.fx, tc.fy, tc.cx, tc.cy), tc.bf, p["ei"], p["ej"], p["rows"],
        p["sig"], **kw)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13),
                                        (torch.float32, 5e-6)])
def test_scan_preintegration_matches_the_stepwise_one(dtype, rtol):
    """preintegrate_batch_scan against preintegrate_batch on 64 intervals
    of 1-24 rows (the rest padding): every field within rtol of its
    largest entry.  The two sum the same recurrences in other orders: they
    met to 1.2e-15 in float64 and 5.6e-7 in float32."""
    g = torch.Generator().manual_seed(0)
    B, M = 64, 24
    acc = torch.randn((B, M, 3), generator=g, dtype=dtype) + torch.tensor(
        [0.0, 0.0, 9.81], dtype=dtype)
    gyro = 0.5 * torch.randn((B, M, 3), generator=g, dtype=dtype)
    dts = torch.full((B, M), 0.005, dtype=dtype)
    lens = torch.randint(1, M + 1, (B,), generator=g)
    lens[0] = M
    mask = (torch.arange(M)[None] < lens[:, None]).to(dtype)
    bias = 0.01 * torch.randn((B, 6), generator=g, dtype=dtype)
    calib = _setup()[2].calib
    a = preintegrate_batch(acc, gyro, dts, mask, bias, calib)
    b = preintegrate_batch_scan(acc, gyro, dts, mask, bias, calib)
    for f in ("dT", "dR", "dV", "dP", "cov", "JRg", "JVg", "JVa", "JPg",
              "JPa"):
        x, y = getattr(a, f), getattr(b, f)
        assert float((x - y).abs().max()) <= rtol * float(x.abs().max()), f


def test_pcg_assembly_solves_the_dense_step():
    """Float64, 2 LM steps, CG run to 30 K iterations (twice the size of
    the system: the bias chain's stiff random-walk edges slow it): the
    matrix-free assembly solves the step the dense (15 K)^2 system solves.
    The PCG assembly takes the inertial Jacobian in closed form, the dense
    one by autodiff through exp_so3's small-angle series; the two part by
    1.4e-8 in the rotation row's gyro-bias column.  At K = 24 the solves
    met to 3.7e-12 in R, 6.7e-11 in p, v and b, 5.3e-9 in X and 1.2e-10
    of the cost (1,500 iterations change none of these); the bars leave 8
    to 27 times that.  At 15 K iterations they part by 4e-8, at 60 by
    millimetres (CG is truncated), which is why the dense path stays the
    yardstick of small problems."""
    tc, data, _ = _setup(24)
    p = _problem64(data, tc)
    dense = _port64(p, tc, n_iters=2)
    pcg = _port64(p, tc, n_iters=2, assembly="pcg", n_cg=30 * 24)
    for i, atol in ((0, 1e-10), (1, 1e-9), (2, 1e-9), (3, 1e-9), (4, 5e-8)):
        np.testing.assert_allclose(pcg[i], dense[i], rtol=0, atol=atol)
    assert abs(float(pcg[6]) - float(dense[6])) <= 1e-9 * float(dense[6])


def test_pcg_assembly_refuses_a_shared_bias():
    tc, data, _ = _setup(24)
    p = _problem64(data, tc)
    with pytest.raises(ValueError, match="per-keyframe biases"):
        _port64(p, tc, n_iters=1, assembly="pcg", shared_bias=True)


def test_pcg_assembly_matches_the_reference_in_float64():
    """The same algorithm in float64 from the same snapshot, 7 LM steps of
    60 PCG iterations: the port's PCG assembly and the plain reference
    agree to 4e-8 in R, p, v and b and 6e-6 m in X (K = 64).  What parts
    them is the port's visual information 1.2^(-2 level), computed in
    float32 (a relative 6e-8) where the reference has float64; the bars
    leave 25 times that, and are a thousand times under what one dropped
    edge or a wrong Jacobian block moves."""
    tc, data, _ = _setup()
    p = _problem64(data, tc)
    port = _port64(p, tc, n_iters=7, assembly="pcg")
    ref = _ref64(p, tc, n_iters=7)
    for i, atol in ((0, 1e-6), (1, 1e-6), (2, 1e-6), (3, 1e-6), (4, 2e-4)):
        np.testing.assert_allclose(port[i], ref[i], rtol=0, atol=atol)


def _entry(tc, data, imu, **kw):
    m = _map(data, tc)
    assert global_ba.global_inertial_bundle_adjustment(tc, m, imu, **kw)
    return m


def _gaps(m, data, tc, ref):
    """pose, velocity and bias gaps (the cell's numbers) of map m against
    a reference solve."""
    Rb, pb, vr, br = ref[:4]
    R_cb = data["R_bc"].T
    R, t = vi_lm_schur.body_to_camera(Rb, pb, R_cb, -R_cb @ data["t_bc"])
    free = np.arange(data["K"]) > 0
    pose = np.linalg.norm(lm_schur.centres(m.kf_R.astype(np.float64),
                                           m.kf_t.astype(np.float64))
                          - lm_schur.centres(R, t), axis=1)[free].max()
    vel = np.linalg.norm(m.kf_v - vr, axis=1).max()
    walk = np.array([data["walk_gyro"]] * 3 + [data["walk_acc"]] * 3)
    return pose, vel, (np.abs(m.kf_bias - br) / walk).max()


def test_entry_matches_the_reference(force_pcg):
    """The entry as the loop closer calls it (float32, padded buckets, the
    IMU log read through ImuIntervals) against the float64 reference: 5.3e-6
    m in the keyframes' centres, 4.0e-6 m/s in velocity and 8.6e-4 walk
    densities in bias (K = 64); float32 rounding carried through 7 LM
    steps of 60 CG iterations.  The bars are those the benchmark's cell
    holds the program to at K = 2048 (portbench/limits/
    euroc_stereo_inertial-vigba.json); the bfloat16 reference misses them
    by 47, 129 and 12 times here."""
    tc, data, imu = _setup()
    m = _entry(tc, data, imu, n_iters=7, cull_outliers=False)
    p = _problem64(data, tc)
    pose, vel, bias = _gaps(m, data, tc, _ref64(p, tc, n_iters=7))
    assert pose < 1e-3 and vel < 1e-3 and bias < 1.0, (pose, vel, bias)
    pose16, vel16, bias16 = _gaps(m, data, tc, _ref64(
        p, tc, n_iters=7, dtype=torch.bfloat16))
    assert pose16 > 1e-2 and vel16 > 1e-2 and bias16 > 1.0


def test_entry_moves_every_state_and_keeps_the_gauge(force_pcg):
    """Every keyframe's velocity and biases move (the gauge keyframe's
    too), its pose alone stays; the solve takes the map's velocities
    nearer the truth."""
    tc, data, imu = _setup()
    m = _entry(tc, data, imu, n_iters=7)
    assert np.array_equal(m.kf_R[0], data["kf_R"][0])
    assert np.array_equal(m.kf_t[0], data["kf_t"][0])
    assert (m.kf_v != data["kf_v"]).any(axis=1).all()
    assert (m.kf_bias != data["kf_bias"]).any(axis=1).all()
    err = lambda v: np.linalg.norm(v - data["true_v"], axis=1).max()  # noqa
    assert err(m.kf_v) < 0.5 * err(data["kf_v"])


def test_keyframes_created_since_the_snapshot(force_pcg, monkeypatch):
    """A keyframe created while the solve runs (the last one, invalid in
    the snapshot) is corrected through the newest snapshot keyframe: its
    pose by T_d, its velocity turned by R_d^T (mVwbGBA), its biases kept."""
    tc, data, imu = _setup()
    m = _map(data, tc)
    K = data["K"]
    m.kf_valid[K - 1] = False
    m.next_kf = K - 1
    R0, t0 = m.kf_R[K - 1].copy(), m.kf_t[K - 1].copy()
    v0, b0 = m.kf_v[K - 1].copy(), m.kf_bias[K - 1].copy()
    real = global_ba._solve_vigba
    seen = {}

    def solve(*a):
        out = real(*a)
        m.kf_valid[K - 1] = True           # created meanwhile
        m.next_kf = K
        seen["out"], seen["snap"] = out, a[2]
        return out

    monkeypatch.setattr(global_ba, "_solve_vigba", solve)
    assert global_ba.global_inertial_bundle_adjustment(
        tc, m, imu, cull_outliers=False)
    out, s = seen["out"], seen["snap"]
    i = s["kfs"].size - 1                  # the newest snapshot keyframe
    R_d = s["R_old"][i].T @ out["R"][i]
    t_d = s["R_old"][i].T @ (out["t"][i] - s["t_old"][i])
    R_new = (R0 @ R_d).astype(np.float32)
    np.testing.assert_array_equal(m.kf_R[K - 1], R_new)
    np.testing.assert_allclose(m.kf_t[K - 1], t0 + R_new @ (R_d.T @ t_d),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.kf_v[K - 1], R_d.T @ v0, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.kf_bias[K - 1], b0)
    # The snapshot's keyframes take the solve's velocities and biases.
    idx = s["kf_index"][s["kfs"]]
    np.testing.assert_array_equal(m.kf_v[s["kfs"]], out["v"][idx])
    np.testing.assert_array_equal(m.kf_bias[s["kfs"]], out["bias"][idx])
    assert not np.allclose(R_d, np.eye(3), atol=1e-7)


def _closer(inertial, initialized, imu=True, mesh=None):
    tc, data, source = _setup(24)
    m = _map(data, tc)
    m.imu_initialized = initialized
    return LoopCloser(cfg=tc, map=m, db=None, inertial=inertial,
                      imu=source if imu else None, ba_mesh=mesh)


class _Mesh:
    size = 2


@pytest.mark.parametrize("inertial,initialized,imu,mesh,route", [
    (True, True, True, None, "inertial"),
    (True, False, True, None, "visual"),
    (False, True, True, None, "visual"),
    (True, True, False, None, "visual"),
    (True, True, True, _Mesh(), "visual")])
def test_run_gba_route(monkeypatch, inertial, initialized, imu, mesh, route):
    """LoopClosing.cc:2283-2291: an IMU-initialised inertial map gets the
    full inertial BA of 7 iterations; every other map (and an inertial one
    over a mesh of several shards) the visual GBA of 10."""
    calls = []
    monkeypatch.setattr(global_ba, "global_inertial_bundle_adjustment",
                        lambda cfg, m, imu, n_iters, use_lock: calls.append(
                            ("inertial", n_iters, use_lock)) or True)
    monkeypatch.setattr(global_ba, "global_bundle_adjustment",
                        lambda cfg, m, n_iters, mesh, use_lock: calls.append(
                            ("visual", n_iters, use_lock)) or True)
    lc = _closer(inertial, initialized, imu, mesh)
    lc._run_gba()
    assert calls == [(route, 7 if route == "inertial" else 10, True)]
    assert lc.stats["n_gba"] == 1


def test_the_jax_loop_closer_runs_the_visual_gba(monkeypatch):
    """The reference fault the port does not keep: the JAX loop closer runs
    the visual GBA on an IMU-initialised inertial map too."""
    calls = []
    monkeypatch.setattr(j_global_ba, "global_bundle_adjustment",
                        lambda cfg, m, n_iters, mesh, use_lock: calls.append(
                            n_iters) or True)
    jm = JMapState(max_kf=8, max_kp=16, max_lm=32)
    jm.imu_initialized = True
    jl = JLoopCloser(cfg=JTrackerConfig(), map=jm, db=None, inertial=True)
    jl._run_gba()
    assert calls == [10]


class _ImuTracker(inertial_tracking.ImuMixin):
    """The inertial tracker's IMU state alone, on a map of its own."""

    def __init__(self, calib, m):
        self.map = m
        self._init_imu_state(calib)


def test_imu_log_keeps_every_interval_of_the_map(monkeypatch):
    """A tracker's IMU log past its trim: 5000 frames at 20 fps after the
    final IMU init (10 rows each), a keyframe every second frame, the
    oldest 300 keyframes culled on the way.  Every interval of the map's
    chain keeps its 20 rows, so the full inertial BA gets an edge for each;
    the frames at or before the oldest valid keyframe are dropped."""
    monkeypatch.setattr(inertial_tracking, "_preintegrate_rows",
                        lambda *a: None)
    _, _, imu = _setup()
    n_frames, n_kf, n_cull = 5000, 2500, 300
    m = MapState(max_kf=n_kf, max_kp=8, max_lm=8)
    tr = _ImuTracker(imu.calib, m)
    tr.imu_stage = 3
    rows = np.zeros((10, 7), np.float32)
    rows[:, 0] = 0.005
    rows[:, 3] = 9.81
    for f in range(n_frames):
        ts = 0.05 * (f + 1)
        if f == 3000:
            m.kf_valid[:n_cull] = False
        tr._ingest_imu(rows + np.float32([0, 1e-4 * f, 0, 0, 0, 0, 0]), ts)
        if f % 2 == 1:
            k = f // 2
            m.kf_valid[k] = True
            m.kf_timestamp[k] = ts
    assert n_frames > inertial_tracking.IMU_LOG_TRIM_FRAMES
    kfs = np.nonzero(m.kf_valid)[0]
    oldest = float(m.kf_timestamp[kfs[0]])
    assert tr._imu_log[0][0] > oldest
    assert len(tr._imu_log) == n_frames - 2 * (n_cull + 1)
    ts = m.kf_timestamp[kfs]
    for a, b in zip(ts[:-1], ts[1:]):
        assert tr._rows_between(float(a), float(b)).shape == (20, 7)
    source = global_ba.ImuIntervals(imu.calib, tr._rows_between)
    s = dict(kfs=kfs, K=kfs.size, R_all=np.tile(np.eye(3), (kfs.size, 1, 1)),
             t_all=np.zeros((kfs.size, 3)))
    snap = global_ba._assemble_inertial(m, source, s)
    assert snap["edge_mask"].shape == (kfs.size - 1,)
    assert snap["edge_mask"].all()
    np.testing.assert_allclose(snap["pre"].dT.numpy(), 0.1, rtol=1e-5)


def test_imu_log_out_of_order_is_scanned():
    """A log whose stamps went back (assigned whole, or appended) is read
    by a scan, as every stamp in (t0, t1] in log order."""
    _, _, imu = _setup()
    tr = _ImuTracker(imu.calib, MapState(max_kf=4, max_kp=8, max_lm=8))
    r = [np.full((1, 7), i, np.float32) for i in range(4)]
    tr._imu_log = [(1.0, r[0]), (0.5, r[1]), (2.0, r[2])]
    np.testing.assert_array_equal(tr._rows_between(0.4, 1.0),
                                  np.concatenate([r[0], r[1]]))
    tr._imu_log = [(0.5, r[0]), (1.0, r[1])]
    np.testing.assert_array_equal(tr._rows_between(0.4, 1.0),
                                  np.concatenate([r[0], r[1]]))
    tr._ingest_imu(r[2], 0.7)
    np.testing.assert_array_equal(tr._rows_between(0.6, 1.0),
                                  np.concatenate([r[1], r[2]]))
