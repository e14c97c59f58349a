"""Cells, configurations, traffic, limits and metric readers are found by
name from data, and BENCHMARK.json keeps to the benchmark's contract."""

import glob
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) < 65536


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    cfg = harness.find_config(BENCH, cell["config"])
    assert os.path.exists(os.path.join(harness.ROOT, cfg["file"]))
    traffic = harness.load_traffic(cell["traffic"])
    assert harness.load_kind(traffic["kind"]).run
    limits = harness.load_limits(cell["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = harness.metrics_for(BENCH, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_for(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(cfg["why"]) <= 200 and "\n" not in cfg["why"]
    assert cfg["file"].startswith("portbench/configs/")
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    used = [c for c in BENCH["workloads"] if c["config"] == cfg["name"]]
    assert used


def test_config_reads_through_the_port_settings():
    from orb_slam3_study_kr_tpu_torch.io.settings import Settings
    entries = {c["file"]: c for c in BENCH["configs"]}
    files = sorted(glob.glob(os.path.join(harness.HERE, "configs", "*.yaml")))
    assert len(files) == 2
    for path in files:
        st = Settings(path)
        tc = st.tracker_config(device="cpu")
        assert (tc.width, tc.height, tc.fps) == (752, 480, 20.0)
        assert st.get("Port.sensor") in ("mono", "stereo")
        assert st.get("source").startswith("https://")
        cfg = entries.get(os.path.relpath(path, harness.ROOT))
        if cfg is not None:
            assert st.get("source") == cfg["source"]
            assert sorted(st.get("reduced")) == sorted(cfg["reduced"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        mod = harness.load_module(
            harness.data_path("metrics", f"{metric['name']}.py"), "m")
        assert callable(mod.read)
        assert mod.read({}) is None
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["layer"]


def test_names_unique():
    for table in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[table]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_missing_cell_file_is_named():
    with pytest.raises(harness.CellError, match="traffic/nope.json"):
        harness.load_traffic("nope")


def test_limits_files_record_their_readings():
    for cell in BENCH["workloads"]:
        with open(harness.data_path("limits", f"{cell['name']}.json")) as f:
            numbers = json.load(f)["numbers"]
        for name, entry in numbers.items():
            assert "limit" in entry, name
