"""Drive a whole run on the CPU (the card check skipped) with the timed
path broken underneath, and see ``correct`` come out false: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced.  The cells have no exchange between chips."""

import argparse
import time

import numpy as np
import pytest

from portbench import harness, run

BENCH = harness.load_benchmark()


def _run(monkeypatch, workload, traffic, seconds, bench=BENCH):
    monkeypatch.setattr(harness, "load_traffic", lambda name: traffic)
    a = argparse.Namespace(workload=workload, seed=2 ** 32 + 17,
                           seconds=seconds, trace=0, control=0)
    return run.run_cell(a, device="cpu", bench=bench,
                        t_start=time.perf_counter())


def _gba_traffic():
    tr = harness.load_traffic("gba")
    tr["map"].update(keyframes=32, obs_per_kf=64)
    return tr


def _break_gba(monkeypatch, fault):
    from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
    real = global_ba.global_bundle_adjustment

    def broken(cfg, m, **kw):
        before = m.kf_t.copy(), m.kf_R.copy()
        if fault == "unchanged":
            return True
        ok = real(cfg, m, **kw)
        if fault == "half":
            m.kf_t[1::2], m.kf_R[1::2] = before[0][1::2], before[1][1::2]
        elif fault == "altered":
            m.lm_pos[5] += np.float32(0.05)
        return ok

    monkeypatch.setattr(global_ba, "global_bundle_adjustment", broken)


def test_gba_sound_run_is_correct(monkeypatch):
    res, checks = _run(monkeypatch, "euroc_stereo-gba", _gba_traffic(), 0.3)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault,number", [("unchanged", "pose_gap_m"),
                                          ("half", "pose_gap_m"),
                                          ("altered", "reproj_gap_px")])
def test_gba_fault_is_not_correct(monkeypatch, fault, number):
    _break_gba(monkeypatch, fault)
    res, checks = _run(monkeypatch, "euroc_stereo-gba", _gba_traffic(), 0.3)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    value, limit = checks[number]
    assert value > limit


def _track_traffic():
    tr = harness.load_traffic("track")
    tr["warmup"] = {"min_frames": 20, "after_vocabulary": 1, "max_frames": 40}
    tr["sample"] = {"frames": 1, "among_first": 1}
    tr["render_batch"] = 8
    return tr


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_track_fault_is_not_correct(monkeypatch, track_bench, fault):
    from orb_slam3_study_kr_tpu_torch.pipeline.system import SlamSystem
    real = SlamSystem.track_monocular
    state = dict(n=0, pose=None)

    def broken(self, img, ts, imu=None):
        f = real(self, img, ts, imu)
        i = state["n"]
        state["n"] += 1
        if i == 10:
            state["pose"] = (f.R_cw, f.t_cw)
        # Frozen from frame 11: every window frame's move over the k frames
        # the check compares is zero.  Altered: every other window frame.
        if fault == "unchanged" and i > 10 and f.R_cw is not None:
            f.R_cw, f.t_cw = state["pose"]
        elif fault == "altered" and i >= 20 and i % 2 and f.R_cw is not None:
            f.t_cw = np.asarray(f.t_cw) + np.float32(0.1)
        return f

    monkeypatch.setattr(SlamSystem, "track_monocular", broken)
    res, checks = _run(monkeypatch, "euroc_mono-track", _track_traffic(), 6.0,
                       track_bench)
    assert not res["correct"] and res["failed"] >= 1
    assert checks["step_err"][0] > 0.9
