"""The metric arithmetic: whole-window rates, per-layer readers, the
trace's busy time and idle gaps, and how attempted and failed frames are
counted."""

import pytest

from portbench import harness, peaks, trace
from portbench.kinds import session

BENCH = harness.load_benchmark()


def _reader(name):
    return harness.load_module(harness.data_path("metrics", f"{name}.py"),
                               "m_" + name.replace(".", "_"))


def _window():
    return dict(frames=40, seconds=50.0, frame_s=[1.0] * 36 + [2.0] * 4,
                stages={"track/track": (40, 32.0), "track/extract": (80, 0.8),
                        "mapping/keyframe": (20, 3.0),
                        "loop/detect_correct": (20, 0.06)},
                syncs=60.0, trace_frames=3)


def test_stage_readers_take_whole_window_sums():
    ctx = dict(window=_window())
    assert _reader("track_ms_per_frame").read(ctx) == pytest.approx(800.0)
    assert _reader("extract_ms_per_frame").read(ctx) == pytest.approx(20.0)
    assert _reader("mapping_ms_per_kf").read(ctx) == pytest.approx(150.0)
    assert _reader("loop_ms_per_kf").read(ctx) == pytest.approx(3.0)
    assert _reader("keyframes_per_100_frames").read(ctx) == pytest.approx(50.0)
    assert _reader("syncs_per_frame").read(ctx) == 60.0
    assert _reader("stereo_match_ms_per_frame").read(ctx) is None
    assert 1000.0 < _reader("frame_ms_p90").read(ctx) <= 2000.0


def test_trace_readers():
    s = dict(busy_s=0.5, window_s=10.0, launches=300000,
             kernels={"void segment_reduce_kernel": [10, 0.2],
                      "gemm": [5, 0.3]})
    ctx = dict(trace=s, window=_window(),
               gba=dict(spans=[0.8, 0.9], walls=[1.0, 1.1], n_iters=10,
                        trace_solves=2))
    assert _reader("device_idle_pct.track").read(ctx) == pytest.approx(95.0)
    assert _reader("launches_per_frame").read(ctx) == pytest.approx(1e5)
    assert _reader("launches_per_gba").read(ctx) == pytest.approx(1.5e5)
    assert _reader("segment_reduce_share_pct").read(ctx) == pytest.approx(40.0)
    assert _reader("gba_host_ms").read(ctx) == pytest.approx(200.0)
    assert _reader("ba_ms_per_lm_iter").read(ctx) == pytest.approx(85.0)


def test_union_and_gaps():
    busy, gaps = trace._union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert busy == pytest.approx(3.0)
    assert gaps == [(2.0, 3.0)]
    owners = trace._gap_owners([(1.5, 3.5, "aten::mul"),
                                (2.4, 2.6, "cudaLaunchKernel")], gaps)
    assert dict(owners) == {"cudaLaunchKernel": pytest.approx(1.0)}
    owners = trace._gap_owners([], gaps)
    assert dict(owners) == {"host: no profiled op": pytest.approx(1.0)}


def test_failed_counts_lost_and_rejected_frames_once():
    lost = [False, True, False, False, True]
    errs = [0.1, None, 0.9, 0.2, 0.8]
    assert session.outcome(lost, errs, 0.5) == 3
    assert session.outcome([False] * 3, [0.1, 0.2, 0.3], 0.5) == 0


def test_kernel_bounds():
    # K1 at 752x480 alone: 360,960 px x 20 B over 3.35 TB/s.
    assert peaks.k1_bound_s([(480, 752)]) == pytest.approx(
        480 * 752 * 20 / 3.35e12)
    # K2: N = L = 1000, none passing: the gates' operations bound it.
    assert peaks.k2_bound_s(1, 1000, 1000, 0) == pytest.approx(
        1e6 * 10 / 67e12)


def test_metrics_for_follows_workloads_keys(track_bench):
    names = {m["name"] for m in harness.metrics_for(BENCH, "euroc_stereo-gba",
                                                    "end_to_end")}
    assert names == {"gba_s", "setup_s"}
    per = {m["name"] for m in harness.metrics_for(
        track_bench, "euroc_mono-track", "per_layer")}
    assert "gba_host_ms" not in per and "k1_roofline" in per
    names = {m["name"] for m in harness.metrics_for(
        track_bench, "euroc_mono-track", "end_to_end")}
    assert names == {"frames_per_s", "setup_s"}
