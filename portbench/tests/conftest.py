"""The benchmark's own tests: run from the checkout root with
``python -m pytest portbench/tests``.  Tests marked ``gpu`` need the card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402

from portbench import harness  # noqa: E402

# The tracking cells are not in BENCHMARK.json while the tracker drops
# frames on every seed (PERF.md, Open questions); their driver, traffic and
# configurations are, and these tests drive them through a bench that adds
# the cells, with provisional limits.
TRACK_LIMITS = {"step_err": 0.5, "pyramid_err": 0.01, "k1_map_mismatch": 0,
                "k1_blur_err": 1e-3, "k2_mismatch": 0}
TRACK_METRICS = ("frame_ms_p90", "track_ms_per_frame", "syncs_per_frame",
                 "extract_ms_per_frame", "mapping_ms_per_kf",
                 "keyframes_per_100_frames", "loop_ms_per_kf", "k1_roofline",
                 "k2_roofline", "device_idle_pct.track", "launches_per_frame")


@pytest.fixture
def track_bench(monkeypatch):
    """BENCHMARK.json plus the euroc_mono-track and euroc_stereo-track
    cells, and their provisional limits."""
    bench = harness.load_benchmark()
    bench["configs"].append({
        "name": "euroc_mono", "file": "portbench/configs/euroc_mono.yaml",
        "source": "https://github.com/UZ-SystemsLab/ORB_SLAM3/blob/master/"
                  "Examples/Monocular/EuRoC.yaml", "reduced": [],
        "why": "tracking"})
    cells = ["euroc_mono-track", "euroc_stereo-track"]
    for name in cells:
        bench["workloads"].append({"name": name, "config": name.split("-")[0],
                                   "traffic": "track", "chips": 1,
                                   "why": "tracking"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                                "better": "higher", "bound": 0.2,
                                "source": "host_clock", "workloads": cells})
    for m in TRACK_METRICS:
        bench["per_layer"].append({"name": m, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "x",
                                   "moves": "frames_per_s",
                                   "workloads": cells})
    real = harness.load_limits
    monkeypatch.setattr(
        harness, "load_limits",
        lambda w: dict(TRACK_LIMITS) if w in cells else real(w))
    return bench
