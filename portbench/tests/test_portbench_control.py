"""The controls come out as not correct, at a size a test run can hold:
each number's control (``--control 1``) reads above that number's limit.

On the card the same runs, at the cells' own sizes, gave the readings the
limits in ``limits/*.json`` were set from."""

import argparse
import time

import pytest

from portbench import harness, run

BENCH = harness.load_benchmark()


def _control(monkeypatch, workload, traffic, seconds, bench=BENCH):
    monkeypatch.setattr(harness, "load_traffic", lambda name: traffic)
    a = argparse.Namespace(workload=workload, seed=2 ** 31 + 101,
                           seconds=seconds, trace=0, control=1)
    return run.run_cell(a, device="cpu", bench=bench,
                        t_start=time.perf_counter())


def test_gba_control_fails_every_number(monkeypatch):
    tr = harness.load_traffic("gba")
    tr["map"].update(keyframes=32, obs_per_kf=64)
    res, checks = _control(monkeypatch, "euroc_stereo-gba", tr, 0.3)
    assert not res["correct"]
    for name in ("pose_gap_m", "reproj_gap_px", "cull_mismatch"):
        value, limit = checks[name]
        assert value > limit, name


@pytest.mark.parametrize("workload", ["euroc_mono-track"])
def test_track_control_fails_every_number(monkeypatch, track_bench, workload):
    tr = harness.load_traffic("track")
    tr["warmup"] = {"min_frames": 14, "after_vocabulary": 1, "max_frames": 40}
    tr["sample"] = {"frames": 1, "among_first": 1}
    tr["render_batch"] = 8
    res, checks = _control(monkeypatch, workload, tr, 16.0, track_bench)
    assert not res["correct"]
    for name in ("step_err", "pyramid_err", "k1_map_mismatch", "k1_blur_err",
                 "k2_mismatch"):
        value, limit = checks[name]
        assert value > limit, name
