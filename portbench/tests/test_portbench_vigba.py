"""The full-inertial-BA cell (``euroc_stereo_inertial-vigba``) on the CPU
at a small size: its map's IMU log against the analytic motion,
whole runs (the program against the reference, the bfloat16 control, the
program broken underneath), the byte count of its PCG iteration and the
readers of its per-layer metrics on fabricated logs and traces."""

import argparse
import json
import time

import numpy as np
import pytest
import torch

from portbench import harness, run, vimap, vipcg
from portbench.reference import vi_lm_schur
from portbench.tests.test_portbench_span_readers import _Log

CELL = "euroc_stereo_inertial-vigba"
BENCH = harness.load_benchmark()
SPAN_READERS = ("vigba_preintegrate_ms", "vi_lm_linearize_ms",
                "vi_inertial_ms", "vi_pcg_iter_ms")
CTX_READERS = ("vi_pcg_roofline_pct",)
# The visual cell's readers of the shared snapshot, copies, write-back,
# cuBLAS products, segment sums and the window, reported here too.
SHARED = ("gba_host_ms", "small_matmul_share_pct", "segment_reduce_share_pct",
          "device_idle_pct.gba", "launches_per_gba", "gba_assemble_ms",
          "gba_transfer_ms", "gba_apply_ms")


def _traffic(K=64):
    tr = harness.load_traffic("vigba")
    tr["map"].update(keyframes=K, obs_per_kf=64)
    return tr


def _data(K=64, seed=2 ** 32 + 29):
    from orb_slam3_study_kr_tpu_torch.io.settings import Settings
    st = Settings(harness.data_path("configs", "euroc_stereo_inertial.yaml"))
    tc = st.tracker_config(device="cpu")
    return vimap.build(_traffic(K), (tc.fx, tc.fy, tc.cx, tc.cy, tc.width,
                                     tc.height), tc.bf,
                       tc.orb_config.total_slots, seed, "cpu",
                       st.imu_params())


def test_imu_rows_preintegrate_to_the_true_relative_states():
    """Each interval's rows, preintegrated at the true bias at its start,
    take the true body state at one keyframe to the next within the
    preintegration's own covariance: chi2 of the 9-D residual averages
    about 9 (63 intervals: 9 +- 0.5), the rotation within a few hundredths
    of a degree.  The snapshot's velocities are off the truth."""
    d = _data()
    K = d["K"]
    Rwb, pwb = vi_lm_schur.camera_to_body(d["true_R"], d["true_t"], d["R_bc"],
                                          d["t_bc"])
    f = d["freq"]
    pre = vi_lm_schur.preintegrate(
        torch.as_tensor(d["imu_rows"], dtype=torch.float64),
        torch.as_tensor(d["true_bias"][:-1]), d["noise_gyro"] * f ** 0.5,
        d["noise_acc"] * f ** 0.5, d["walk_gyro"] / f ** 0.5,
        d["walk_acc"] / f ** 0.5)
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    r, _ = vi_lm_schur.inertial_edge(
        pre, T(Rwb[:-1]), T(pwb[:-1]), T(d["true_v"][:-1]), T(Rwb[1:]),
        T(pwb[1:]), T(d["true_v"][1:]), T(d["true_bias"][:-1]),
        T(vimap.GRAVITY), jacobian=False)
    chi2 = torch.einsum("ei,eij,ej->e", r, torch.linalg.inv(
        pre["C"][:, :9, :9]), r).numpy()
    assert chi2.shape == (K - 1,)
    assert 6.5 < chi2.mean() < 11.5, chi2.mean()
    assert np.degrees(np.abs(r[:, :3].numpy())).max() < 0.05
    assert np.allclose(pre["dT"].numpy(), 0.1)
    assert np.linalg.norm(d["kf_v"] - d["true_v"], axis=1).max() > 0.01
    # Gravity along -z: the cameras' image-down axis points down.
    R_wc = np.swapaxes(d["true_R"], 1, 2)
    assert np.allclose(R_wc[:, :, 1] @ np.array([0, 0, -1.0]), 1.0)


def test_imu_log_gives_the_rows_of_an_interval():
    d = _data(K=16)
    log = vimap.ImuLog(d["imu_stamps"], d["imu_rows"])
    ts = d["kf_timestamp"]
    np.testing.assert_array_equal(log.rows_between(ts[3], ts[4]),
                                  d["imu_rows"][3])
    assert log.rows_between(ts[3], ts[6]).shape == (60, 7)
    assert log.rows_between(ts[5], ts[5]).shape == (0, 7)


def _run(monkeypatch, control=0, seconds=0.3):
    from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
    # The cell's map is far above the dense threshold; the small one not.
    monkeypatch.setattr(global_ba, "DENSE_CROSS_BLOCK_FLOATS", 0)
    tr = _traffic()
    monkeypatch.setattr(harness, "load_traffic", lambda name: tr)
    a = argparse.Namespace(workload=CELL, seed=2 ** 32 + 17, seconds=seconds,
                           trace=0, control=control)
    return run.run_cell(a, device="cpu", bench=BENCH,
                        t_start=time.perf_counter())


def test_sound_run_is_correct(monkeypatch):
    res, checks = _run(monkeypatch)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(checks) == {"pose_gap_m", "reproj_gap_px", "cull_mismatch",
                           "vel_gap_mps", "bias_gap"}
    assert set(res["metrics"]) == {"gba_s", "setup_s"}


def test_bfloat16_control_is_not_correct(monkeypatch):
    res, checks = _run(monkeypatch, control=1)
    assert not res["correct"]
    over = [k for k, (v, lim) in checks.items() if v > lim]
    assert {"pose_gap_m", "vel_gap_mps", "reproj_gap_px"} <= set(over)


def _break(monkeypatch, fault):
    from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
    real = global_ba.global_inertial_bundle_adjustment

    def broken(cfg, m, imu, **kw):
        if fault == "unchanged":
            return True
        ok = real(cfg, m, imu, **kw)
        if fault == "velocity":
            m.kf_v[7] += np.float32(0.01)
        elif fault == "bias":
            m.kf_bias[9, 1] += np.float32(1e-4)
        return ok

    monkeypatch.setattr(global_ba, "global_inertial_bundle_adjustment", broken)


@pytest.mark.parametrize("fault,number", [("unchanged", "pose_gap_m"),
                                          ("velocity", "vel_gap_mps"),
                                          ("bias", "bias_gap")])
def test_fault_is_not_correct(monkeypatch, fault, number):
    _break(monkeypatch, fault)
    res, checks = _run(monkeypatch)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    value, limit = checks[number]
    assert value > limit


def test_iteration_bytes_at_the_cells_size():
    """About 171 MB an iteration (K4's visual 165 MB with 15-wide states
    and three 15x15 blocks a state): a bound near 0.051 ms at 3.35 TB/s,
    set by bytes."""
    K, M, O = 2048, 153600, 1228800
    b = vipcg.iteration_bytes(K, M, O)
    assert 170e6 < b < 172e6
    assert vipcg.iteration_bound_s(K, M, O) == pytest.approx(b / 3.35e12)
    assert vipcg.iteration_ops(K, M, O) / 67e12 < b / 3.35e12


def _reader(name):
    return harness.load_module(harness.data_path("metrics", f"{name}.py"),
                               "vigba_" + name.replace(".", "_"))


def test_cell_reports_its_metrics_and_the_shared_ones():
    names = {m["name"] for m in harness.metrics_for(BENCH, CELL, "per_layer")}
    assert names == set(SPAN_READERS + CTX_READERS + SHARED)
    gba = {m["name"] for m in harness.metrics_for(BENCH, "euroc_stereo-gba",
                                                  "per_layer")}
    assert gba & names == set(SHARED)


@pytest.fixture
def log(monkeypatch):
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    lg = _Log(profiling.StageTimers, profiling.Span)
    monkeypatch.setattr(profiling, "DEFAULT_TIMERS", lg.timers)
    return lg


def _vigba(log, lin, inertial, loop, steps=7):
    """One gba/call of an inertial BA: 80 host ms in preintegration,
    ``steps`` LM steps of (lin, inertial, loop) device ms."""
    call = log.add("gba/call", host_ms=900.0, device_ms=800.0)
    asm = log.add("gba/assemble", call, 200.0, 0.0)
    log.add("gba/preintegrate", asm, 80.0, 10.0)
    solve = log.add("viba/solve", call, 600.0, 600.0)
    for _ in range(steps):
        log.add("viba/linearize", solve, 1.0, lin, viba__lm_steps=1)
        log.add("viba/inertial", solve, 1.0, inertial,
                viba__inertial_edges=2047)
        sch = log.add("viba/schur", solve, 1.0, loop + 5.0)
        log.add("viba/pcg_loop", sch, 1.0, loop, viba__cg_iters=60)
        log.add("viba/update", solve, 1.0, 10.0)


def test_span_readers_arithmetic(log):
    _vigba(log, lin=20.0, inertial=30.0, loop=8.0)
    _vigba(log, lin=22.0, inertial=32.0, loop=9.0)
    # A visual GBA request beside them: its ba/ spans do not count.
    other = log.add("gba/call", host_ms=100.0, device_ms=90.0)
    log.add("ba/linearize", other, 1.0, 1000.0)
    got = {n: _reader(n).read(dict(trace={})) for n in SPAN_READERS}
    assert set(got.values()) == {None}     # an empty trace reads nothing
    trace = dict(busy_s=1.0, window_s=2.0, launches=1, kernels={})
    got = {n: _reader(n).read(dict(trace=trace)) for n in SPAN_READERS}
    assert got["vigba_preintegrate_ms"] == pytest.approx(160.0 / 3)
    assert got["vi_lm_linearize_ms"] == pytest.approx(21.0)
    assert got["vi_inertial_ms"] == pytest.approx(31.0)
    assert got["vi_pcg_iter_ms"] == pytest.approx((7 * 8.0 + 7 * 9.0) / 840)


def test_span_readers_of_a_port_without_them(log):
    """The parent's port: visual GBA spans only, or no span log at all."""
    call = log.add("gba/call", host_ms=100.0, device_ms=90.0)
    log.add("gba/assemble", call, 3.0, 0.0)
    trace = dict(busy_s=1.0, window_s=2.0, launches=1, kernels={})
    got = {n: _reader(n).read(dict(trace=trace)) for n in SPAN_READERS}
    assert set(got.values()) == {None}


def test_trace_readers_arithmetic():
    """The roofline share and the visual cell's readers of the window on
    the record ``kinds/vigba_map.py`` leaves in ``ctx["gba"]``."""
    K, M, O = 2048, 153600, 1228800
    kernels = {"void (anonymous namespace)::landmark_sweep<float, 15>(x)":
               [840, 0.042],
               "void (anonymous namespace)::pose_sweep_vi<float>(x)":
               [840, 0.021],
               "void (anonymous namespace)::cg_update<float, 15>(x)":
               [840, 0.021], "gemm": [100, 0.5]}
    trace = dict(busy_s=0.9, window_s=1.8, launches=17600, kernels=kernels)
    vig = dict(spans=[0.6, 0.62], walls=[0.86, 0.9], n_iters=7,
               trace_solves=2, K=K, M=M, O=O)
    got = {n: _reader(n).read(dict(trace=trace, gba=vig))
           for n in CTX_READERS + ("gba_host_ms", "device_idle_pct.gba",
                                   "launches_per_gba",
                                   "small_matmul_share_pct")}
    assert got["gba_host_ms"] == pytest.approx(270.0)
    assert got["device_idle_pct.gba"] == pytest.approx(50.0)
    assert got["launches_per_gba"] == pytest.approx(8800.0)
    assert got["small_matmul_share_pct"] == pytest.approx(100 * 0.5 / 0.584)
    t_iter = 0.084 / 840
    assert got["vi_pcg_roofline_pct"] == pytest.approx(
        100.0 * vipcg.iteration_bound_s(K, M, O) / t_iter)
    # No trace, no cell's record, or no inertial pose sweep (the visual
    # cell's trace): no roofline share.
    roof = _reader("vi_pcg_roofline_pct")
    assert roof.read(dict(trace=None, gba=vig)) is None
    assert roof.read(dict(trace=trace)) is None
    bare = dict(trace, kernels={"gemm": [1, 0.1]})
    assert roof.read(dict(trace=bare, gba=vig)) is None


def test_limits_file_holds_its_readings():
    lim = json.load(open(harness.data_path("limits", f"{CELL}.json")))
    for name, n in lim["numbers"].items():
        assert n["lower"] < n["limit"] < n["upper"], name
