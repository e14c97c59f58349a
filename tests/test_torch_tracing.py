"""Spans and counters of ``utils/profiling.StageTimers`` and of the global
BA's path (``pipeline/global_ba.py``, ``solvers/local_ba.py``).

The global BA runs on a small stereo map with outliers, its PCG assembly
forced (``DENSE_CROSS_BLOCK_FLOATS = 1``, so ``bundle_adjust`` is called
with ``assembly="pcg"``).  A span is traced only while a
``torch.profiler`` is active: the tests profile the CPU, where spans carry
no device time; the test marked ``gpu`` reads device times on the card.
"""

import threading

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, local_ba
from orb_slam3_study_kr_tpu_torch.utils.profiling import (DEFAULT_TIMERS,
                                                          StageTimers)

N_ITERS = 4
N_CG = 60                      # bundle_adjust's default, which the GBA uses
BF = 458.0 * 0.11
GBA_CHILDREN = {"gba/assemble", "gba/upload", "ba/solve", "gba/download",
                "gba/apply"}
OUTPUTS = ("kf_R", "kf_t", "lm_pos", "lm_valid", "kf_kp_lm")


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _stereo_map(n_outliers=12):
    """8 keyframes on a line seeing 400 landmarks, every observation with a
    right-image coordinate, keyframes 2-7 and the landmarks perturbed, and
    ``n_outliers`` observations moved 40 px."""
    rng = np.random.default_rng(5)
    n_kf, n_lm, max_kp = 8, 400, 512
    cfg = TrackerConfig(device="cpu", bf=BF)
    X_gt = rng.uniform([-3, -2, 5], [3, 2, 10], (n_lm, 3)).astype(np.float32)
    m = MapState(max_kf=16, max_kp=max_kp, max_lm=4096)
    lm_ids = m.add_landmarks(
        X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32),
        rng.integers(0, 2, (n_lm, 256)).astype(np.uint8), first_kf=0)
    for k in range(n_kf):
        R = _rot_y(0.03 * k)
        t = np.array([0.25 * k, 0.02 * k, 0], np.float32)
        Rn, tn = R, t
        if k >= 2:
            Rn = (_rot_y(rng.normal(0, 0.01)) @ R).astype(np.float32)
            tn = (t + rng.normal(0, 0.03, 3)).astype(np.float32)
        pc = X_gt @ R.T + t
        uv = np.stack([cfg.fx * pc[:, 0] / pc[:, 2] + cfg.cx,
                       cfg.fy * pc[:, 1] / pc[:, 2] + cfg.cy], -1)
        ur = uv[:, 0] - BF / pc[:, 2]
        if k >= 2:
            bad = rng.choice(n_lm, n_outliers // (n_kf - 2), replace=False)
            uv[bad] += 40.0
        pad = max_kp - n_lm
        kp_lm = np.full(max_kp, NO_LM, np.int32)
        kp_lm[:n_lm] = lm_ids
        m.add_keyframe(Rn, tn, np.pad(uv, ((0, pad), (0, 0))).astype(
                           np.float32),
                       np.zeros(max_kp, np.int32),
                       np.zeros(max_kp, np.float32),
                       np.arange(max_kp) < n_lm,
                       rng.integers(0, 2, (max_kp, 256)).astype(np.uint8),
                       frame_id=k, timestamp=0.1 * k, kp_lm=kp_lm,
                       ur=np.pad(ur, (0, pad), constant_values=-1.0).astype(
                           np.float32))
    return cfg, m


@pytest.fixture
def force_pcg(monkeypatch):
    monkeypatch.setattr(global_ba, "DENSE_CROSS_BLOCK_FLOATS", 1)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _new_spans(n0):
    return list(DEFAULT_TIMERS.spans)[n0:]


def _traced_gba():
    """(map, the spans the call added to the default log, profiler)."""
    cfg, m = _stereo_map()
    n0 = len(DEFAULT_TIMERS.spans)
    with _profile() as prof:
        assert global_ba.global_bundle_adjustment(cfg, m, n_iters=N_ITERS,
                                                  use_lock=True)
    DEFAULT_TIMERS.resolve()
    return m, _new_spans(n0), prof


def _outputs(m):
    return {k: getattr(m, k).copy() for k in OUTPUTS}


def test_modules_record_into_the_default_instance():
    assert global_ba.TIMERS is DEFAULT_TIMERS
    assert local_ba.TIMERS is DEFAULT_TIMERS


def test_gba_span_tree_is_one_request(force_pcg):
    """gba/call is the request and the parent of the snapshot, the copies,
    ba/solve and the write-back; every span of the call shares its id."""
    _, spans, _ = _traced_gba()
    calls = [s for s in spans if s.name == "gba/call"]
    assert len(calls) == 1
    call = calls[0]
    assert call.parent is None and call.request == call.id
    assert all(s.request == call.id for s in spans)
    children = [s.name for s in spans if s.parent == call.id]
    assert sorted(children) == sorted(GBA_CHILDREN)
    by_id = {s.id: s for s in spans}
    assert by_id[next(s.parent for s in spans
                      if s.name == "gba/cull")].name == "gba/apply"
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1
        assert s.device_ms is None              # the CPU: no device time
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 and s.t1 <= up.t1


def test_lm_iterations_and_their_phases(force_pcg):
    _, spans, _ = _traced_gba()
    by_id = {s.id: s for s in spans}
    solve = next(s for s in spans if s.name == "ba/solve")
    iters = [s for s in spans if s.name == "ba/lm_iter"]
    assert len(iters) == N_ITERS
    assert all(s.parent == solve.id for s in iters)
    assert sorted(s.name for s in spans if s.parent == solve.id) == sorted(
        ["ba/setup", "ba/final"] + ["ba/lm_iter"] * N_ITERS)
    for it in iters:
        assert [s.name for s in spans if s.parent == it.id] == [
            "ba/linearize", "ba/schur", "ba/update"]
    for name in ("ba/pcg_setup", "ba/pcg_loop"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == N_ITERS
        assert all(by_id[s.parent].name == "ba/schur" for s in mine)


def test_counts_of_the_solve(force_pcg):
    _, spans, _ = _traced_gba()
    counts = {}
    for s in spans:
        for k, v in s.counts.items():
            counts[k] = counts.get(k, 0) + v
    assert counts == {"ba/lm_steps": N_ITERS, "ba/cg_iters": N_ITERS * N_CG}
    # The counts sit on the spans where the work happens.
    where = {k: s.name for s in spans for k in s.counts}
    assert where == {"ba/lm_steps": "ba/lm_iter", "ba/cg_iters": "ba/pcg_loop"}


def test_totals_take_only_gba_requests(force_pcg):
    """A bare bundle_adjust (its own request) adds nothing to the totals of
    the gba/call requests."""
    _traced_gba()
    before = DEFAULT_TIMERS.totals("gba/call")
    cfg, m = _stereo_map()
    s = global_ba._assemble_gba(cfg, m)
    names = ("R_all", "t_all", "fixed_p", "X", "lm_mask", "op", "ol", "ouv",
             "olev", "omask")
    n0 = len(DEFAULT_TIMERS.spans)
    with _profile():
        bundle_adjust(cfg.project_fn, cfg.project_jac_fn,
                      *(torch.as_tensor(s[k]) for k in names), n_iters=2,
                      assembly="pcg")
    after = DEFAULT_TIMERS.totals("gba/call")
    assert after["counts"] == before["counts"]
    assert after["requests"] == before["requests"] >= 1
    assert after["host_ms"] == before["host_ms"]
    bare = _new_spans(n0)[0]
    assert bare.name == "ba/solve" and bare.request == bare.id
    assert all(s.request == bare.id for s in _new_spans(n0))
    assert DEFAULT_TIMERS.totals("ba/solve")["counts"]["ba/lm_steps"] >= 2


def test_span_names_reach_the_profiler(force_pcg):
    _, spans, prof = _traced_gba()
    keys = {e.key for e in prof.key_averages()}
    assert {s.name for s in spans} <= keys
    assert {"gba/call", "gba/cull", "ba/pcg_loop", "ba/lm_iter"} <= keys


def test_untraced_call_keeps_only_host_samples(force_pcg, monkeypatch):
    """Untraced, the default instance records nothing at all (it keeps no
    samples, so a long session does not grow it); an instance that keeps
    samples, as the tracker's does, keeps one per stage and no span."""
    cfg, m = _stereo_map()
    n0 = len(DEFAULT_TIMERS.spans)
    assert global_ba.global_bundle_adjustment(cfg, m, n_iters=N_ITERS)
    assert len(DEFAULT_TIMERS.spans) == n0
    assert not DEFAULT_TIMERS.samples
    kept = StageTimers()
    monkeypatch.setattr(global_ba, "TIMERS", kept)
    monkeypatch.setattr(local_ba, "TIMERS", kept)
    assert global_ba.global_bundle_adjustment(cfg, m, n_iters=N_ITERS)
    assert not kept.spans
    assert {k: len(v) for k, v in kept.samples.items()} == {
        "gba/call": 1, "gba/assemble": 1, "gba/upload": 1, "ba/solve": 1,
        "ba/setup": 1, "ba/lm_iter": N_ITERS, "ba/linearize": N_ITERS,
        "ba/schur": N_ITERS, "ba/pcg_setup": N_ITERS,
        "ba/pcg_loop": N_ITERS, "ba/update": N_ITERS, "ba/final": 1,
        "gba/download": 1, "gba/apply": 1, "gba/cull": 1}


@pytest.mark.parametrize("pcg", [True, False], ids=["pcg", "dense"])
def test_written_back_map_is_bit_identical_under_the_profiler(pcg,
                                                             monkeypatch):
    if pcg:
        monkeypatch.setattr(global_ba, "DENSE_CROSS_BLOCK_FLOATS", 1)
    cfg, m = _stereo_map()
    assert global_ba.global_bundle_adjustment(cfg, m, n_iters=N_ITERS)
    m_traced, _, _ = _traced_gba()
    a, b = _outputs(m), _outputs(m_traced)
    for k in OUTPUTS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stage_nesting_requests_and_counts():
    t = StageTimers()
    with _profile():
        with t.stage("outer"):
            t.count("n", 2)
            with t.stage("req", request=True):
                with t.stage("inner"):
                    t.count("n")
                    t.count("f", 0.75)
            t.count("n", 3)
        t.count("n")                     # no open span: dropped
    outer, req, inner = t.resolve()
    assert [s.name for s in (outer, req, inner)] == ["outer", "req", "inner"]
    assert outer.parent is None and outer.request == outer.id
    assert req.parent == outer.id and req.request == req.id
    assert inner.parent == req.id and inner.request == req.id
    assert outer.counts == {"n": 5}
    assert inner.counts == {"n": 1, "f": 0.75}
    assert t.totals("req")["counts"] == {"n": 1, "f": 0.75}
    assert t.totals("req")["requests"] == 1
    assert t.totals("outer")["counts"] == {"n": 5}
    assert t.totals("inner")["requests"] == 0
    assert [len(t.samples[k]) for k in ("outer", "req", "inner")] == [1, 1, 1]


def test_stage_untraced_adds_no_span_and_counts_nothing():
    t = StageTimers()
    with t.stage("a"):
        t.count("n")
    assert not t.spans and len(t.samples["a"]) == 1
    assert t.totals("a") == dict(requests=0, host_ms={}, device_ms={},
                                 counts={})


def test_spans_of_two_instances_and_a_worker_thread():
    """Parents come from the thread's own stack (a span opened on a worker
    thread starts at the top there); counts go to the instance's own
    innermost span."""
    a, b = StageTimers(), StageTimers()
    seen = {}

    def worker():
        with b.stage("worker"):
            b.count("w")
        seen["done"] = True

    with _profile():
        with a.stage("main"):
            with b.stage("nested"):
                a.count("to_main")
                b.count("to_nested")
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive() and seen["done"]
    (main,) = a.resolve()
    nested, worker_span = b.resolve()
    assert main.counts == {"to_main": 1}
    assert nested.counts == {"to_nested": 1}
    assert nested.parent == main.id and nested.request == main.id
    assert worker_span.parent is None and worker_span.request == worker_span.id
    assert worker_span.counts == {"w": 1}


def test_a_raising_block_closes_its_span():
    t = StageTimers()
    with _profile():
        with pytest.raises(ValueError):
            with t.stage("outer"):
                with t.stage("boom"):
                    raise ValueError("x")
        with t.stage("after"):
            pass
    outer, boom, after = t.resolve()
    assert boom.t1 is not None and outer.t1 is not None
    assert after.parent is None
    assert len(t.samples["boom"]) == 1


@pytest.mark.gpu
def test_device_times_and_counts_on_the_card(force_pcg):
    """On the card the written-back map is bit-identical with and without
    the profiler, every span has a device time, ba/setup, the LM
    iterations and ba/final lie within ba/solve's, and the counts are
    those of the solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device times come from CUDA events")
    cfg = TrackerConfig(device="cuda", bf=BF)
    m_plain = _stereo_map()[1]
    assert global_ba.global_bundle_adjustment(cfg, m_plain, n_iters=N_ITERS)
    n0 = len(DEFAULT_TIMERS.spans)
    m_traced = _stereo_map()[1]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        assert global_ba.global_bundle_adjustment(cfg, m_traced,
                                                  n_iters=N_ITERS)
    a, b = _outputs(m_plain), _outputs(m_traced)
    for k in OUTPUTS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    DEFAULT_TIMERS.resolve()
    spans = _new_spans(n0)
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in spans)
    solve = next(s for s in spans if s.name == "ba/solve")
    inside = sum(s.device_ms for s in spans if s.parent == solve.id)
    assert inside <= solve.device_ms * 1.001
    counts = {}
    for s in spans:
        for k, v in s.counts.items():
            counts[k] = counts.get(k, 0) + v
    assert counts == {"ba/lm_steps": N_ITERS, "ba/cg_iters": N_ITERS * N_CG}
