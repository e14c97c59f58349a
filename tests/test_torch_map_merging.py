"""The port's Atlas map merging (pipeline/map_merging.py) and welding BA
(LocalMapper.welding_ba) against the JAX reference, on the CPU.

The two-map scene is ``tests/test_map_merging.py``'s ``_build_pair``: the
same keyframes and landmarks in two world gauges a known Sim3 apart.  Each
package gets its own copy of the same numpy tables; the reference's Sim3
RANSAC draws (PRNGKey(23), split once per verification) are injected into
the port.  The three cases are that file's: gauge recovery, capacity growth
of the target map, and the yaw-only weld of two IMU-initialized maps."""

import jax
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.pipeline.local_mapping import LocalMapper as JLocalMapper
from orb_slam3_study_kr_tpu.pipeline.map_merging import MapMerger as JMapMerger
from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.map_merging import MapMerger
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState as TMapState

from test_map_merging import _build_pair
from test_welding_ba import _reproj_rms, _small_rot

torch.set_num_threads(2)

TCFG = TrackerConfig(device="cpu")


class _JaxUniforms:
    """A reference MapMerger's Sim3 RANSAC draws: PRNGKey(seed), one split
    per verification that reaches the RANSAC."""

    def __init__(self, seed=23):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, iters, n):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.uniform(sub, (iters, n)))


def port_map(jm):
    """A port MapState holding copies of a reference MapState's tables."""
    m = TMapState(max_kf=jm.max_kf, max_kp=jm.max_kp, max_lm=jm.max_lm,
                  map_id=jm.map_id)
    for k, v in vars(jm).items():
        if isinstance(v, np.ndarray):
            setattr(m, k, v.copy())
        elif isinstance(v, (bool, int, float)):
            setattr(m, k, v)
    return m


def _assert_tables_equal(tm, jm, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)


CASES = {
    # name: (seed, sigma, fix_scale, imu, full target allocator)
    "gauge": (0, 0.7, False, False, False),
    "growth": (1, 0.7, False, False, True),
    "inertial_yaw": (7, 1.0, True, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matches_reference(case):
    """verify: identical verified pairs, (R12, t12) within 1e-4, s12 within
    2.5e-3 relative; merge: identical kf_map, lm_map and lm_valid, the
    transformed kf_R, kf_t and lm_pos within 1e-4 times the scene scale,
    every other target table identical; then the reference test's walls
    on the port's result."""
    seed, sigma, fix_scale, imu, full = CASES[case]
    jcfg, jA, jB, *_ = _build_pair(np.random.default_rng(seed), sigma=sigma)
    tA, tB = port_map(jA), port_map(jB)
    for m in (jA, jB, tA, tB):
        m.imu_initialized = imu
    jm = JMapMerger(cfg=jcfg)
    tm = MapMerger(cfg=TCFG, uniforms_fn=_JaxUniforms(23))
    js = jm.verify(jA, 0, jB, 0, fix_scale=fix_scale)
    ts = tm.verify(tA, 0, tB, 0, fix_scale=fix_scale)
    assert js is not None and ts is not None
    for a, b in zip(ts["pairs"], js["pairs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ts["R12"], js["R12"], atol=1e-4)
    np.testing.assert_allclose(ts["t12"], js["t12"], atol=1e-4)
    assert abs(ts["s12"] / js["s12"] - 1.0) < 2.5e-3, (ts["s12"], js["s12"])
    assert tm.stats == jm.stats

    n_kf_B0, n_lm_B0, old_cap = tB.n_kf, int(tB.lm_valid.sum()), tB.max_kf
    if full:
        jB.next_kf = jB.max_kf
        tB.next_kf = tB.max_kf
    jr = jm.merge(jA, 0, jB, 0, js)
    tr = tm.merge(tA, 0, tB, 0, ts)
    assert tr.kf_map == jr.kf_map and tr.target_kf == jr.target_kf == 0
    np.testing.assert_array_equal(tr.lm_map, jr.lm_map)
    assert abs(tr.sigma / jr.sigma - 1.0) < 2.5e-3
    np.testing.assert_allclose(tr.R_BA, jr.R_BA, atol=1e-4)
    mB, jmB = tr.target_map, jr.target_map
    assert mB is tB and (mB.max_kf, mB.max_lm) == (jmB.max_kf, jmB.max_lm)
    assert (mB.n_kf, mB.n_lm, mB.next_kf, mB.next_lm) == (
        jmB.n_kf, jmB.n_lm, jmB.next_kf, jmB.next_lm)
    scale = float(np.abs(jmB.lm_pos[jmB.lm_valid]).max())
    for f in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(getattr(mB, f), getattr(jmB, f),
                                   atol=1e-4 * scale, err_msg=f)
    np.testing.assert_allclose(mB.lm_normal, jmB.lm_normal, atol=1e-4)
    _assert_tables_equal(mB, jmB, ("kf_valid", "lm_valid", "kf_kp_lm",
                                   "lm_first_kf", "lm_desc", "kf_frame_id",
                                   "kf_timestamp", "kf_kp_uv", "kf_desc"))

    # The reference's walls (tests/test_map_merging.py).
    if case == "gauge":
        assert abs(tr.sigma - sigma) < 0.05 * sigma, tr.sigma
        assert mB.n_kf == n_kf_B0 + 3
        assert int(mB.lm_valid.sum()) <= n_lm_B0 + 12
        jA0 = tr.kf_map[0]
        cA, cB = mB.kf_center(jA0), mB.kf_center(0)
        assert np.linalg.norm(cA - cB) < 0.05 * max(np.linalg.norm(cB), 1.0)
        lm = mB.kf_kp_lm[jA0]
        ok = lm != NO_LM
        assert ok.sum() > 100 and mB.lm_valid[lm[ok]].all()
    elif case == "growth":
        assert mB.max_kf > old_cap
        assert all(mB.kf_valid[j] for j in tr.kf_map.values())
    else:
        assert tr.sigma == 1.0
        R = tr.R_BA
        np.testing.assert_allclose(R[2], [0, 0, 1], atol=1e-6)
        np.testing.assert_allclose(R[:, 2], [0, 0, 1], atol=1e-6)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        for a, j in tr.kf_map.items():
            np.testing.assert_allclose(mB.kf_center(j), mB.kf_center(a),
                                       atol=0.05)


def test_verify_rejects_unrelated_maps():
    """Two maps of different scenes: too few descriptor matches, no
    verification and no RANSAC draw, as in the reference."""
    jcfg, jA, _, *_ = _build_pair(np.random.default_rng(0))
    _, _, jB, *_ = _build_pair(np.random.default_rng(5))
    draws = _JaxUniforms(23)
    tm = MapMerger(cfg=TCFG, uniforms_fn=draws)
    jm = JMapMerger(cfg=jcfg)
    key0 = np.array(draws.key)
    assert tm.verify(port_map(jA), 0, port_map(jB), 0) is None
    assert jm.verify(jA, 0, jB, 0) is None
    assert tm.stats == jm.stats == {"n_attempts": 1, "n_verified": 0,
                                    "n_merged": 0}
    np.testing.assert_array_equal(np.array(draws.key), key0)


@pytest.mark.parametrize("fix_b", [False, True])
def test_welding_ba_matches_reference(fix_b):
    """tests/test_welding_ba.py's problem through both packages: the same
    merged map with the same perturbation of the transferred poses and the
    landmarks.  Poses and points within 1e-3 of the reference, and the
    reference's walls (reprojection RMS below 0.35x on both seam sides)."""
    rng = np.random.default_rng(3)
    jcfg, jA, jB, *_ = _build_pair(rng)
    tA, tB = port_map(jA), port_map(jB)
    jm = JMapMerger(cfg=jcfg)
    tm = MapMerger(cfg=TCFG, uniforms_fn=_JaxUniforms(23))
    n_b0 = jB.n_kf
    jr = jm.merge(jA, 0, jB, 0, jm.verify(jA, 0, jB, 0))
    tr = tm.merge(tA, 0, tB, 0, tm.verify(tA, 0, tB, 0))
    a_kfs = np.asarray(sorted(jr.kf_map.values()))
    b_kfs = np.arange(n_b0)
    dR = _small_rot(rng, a_kfs.size)
    dt = rng.normal(0, 0.01, (a_kfs.size, 3)).astype(np.float32)
    live = np.nonzero(jB.lm_valid)[0]
    dX = rng.normal(0, 0.01, (live.size, 3)).astype(np.float32)
    for m in (jB, tB):
        m.kf_R[a_kfs] = m.kf_R[a_kfs] @ dR
        m.kf_t[a_kfs] += dt
        m.lm_pos[live] += dX
    # Both start from the reference's transformed tables.
    for f in ("kf_R", "kf_t", "lm_pos", "lm_normal", "lm_min_dist",
              "lm_max_dist"):
        setattr(tB, f, getattr(jB, f).copy())
    e0 = [_reproj_rms(jcfg, jB, k) for k in (a_kfs, b_kfs)]
    assert min(e0) > 1.0
    jmap = JLocalMapper(cfg=jcfg, map=jB, ba_window=12)
    tmap = LocalMapper(cfg=TCFG, map=tB, ba_window=12)
    jmap.welding_ba(a_kfs, b_kfs, fix_b=fix_b)
    tmap.welding_ba(a_kfs, b_kfs, fix_b=fix_b)
    assert tmap.stats["n_welding_ba"] == jmap.stats["n_welding_ba"] == 1
    assert tmap.stats["n_ba"] == jmap.stats["n_ba"] == 1
    for f in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(getattr(tB, f), getattr(jB, f), atol=1e-3,
                                   err_msg=f)
    np.testing.assert_array_equal(tB.kf_kp_lm, jB.kf_kp_lm)
    np.testing.assert_array_equal(tB.lm_valid, jB.lm_valid)
    if fix_b:
        np.testing.assert_array_equal(tB.kf_R[b_kfs], jB.kf_R[b_kfs])
    for kfs, e in zip((a_kfs, b_kfs), e0):
        assert _reproj_rms(jcfg, tB, kfs) < 0.35 * e
