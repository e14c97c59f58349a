"""The port's native map-index helpers: the global BA's one-pass
observation gather against its numpy fallback and against the snapshot it
replaced (``observations`` + a landmark filter + fancy indexing), and
``MapState.remove_landmarks`` (``native.unbind_landmarks`` and its numpy
fallback) against ``np.isin``."""

from unittest import mock

import numpy as np
import pytest

from orb_slam3_study_kr_tpu_torch import native
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState


def _tables(rng, n_kf=40, max_kp=300, max_lm=3000):
    lm = np.full((n_kf, max_kp), NO_LM, np.int32)
    bound = rng.random((n_kf, max_kp)) < 0.5
    lm[bound] = rng.integers(0, max_lm, bound.sum())
    uv = rng.random((n_kf, max_kp, 2)).astype(np.float32)
    level = rng.integers(0, 8, (n_kf, max_kp)).astype(np.int32)
    ur = np.where(rng.random((n_kf, max_kp)) < 0.5,
                  rng.random((n_kf, max_kp)), -1.0).astype(np.float32)
    kfs = np.sort(rng.choice(n_kf, 30, replace=False)).astype(np.int32)
    lms = np.sort(rng.choice(max_lm, 2000, replace=False))
    lm_index = np.full(max_lm, -1, np.int32)
    lm_index[lms] = np.arange(lms.size)
    return lm, uv, level, ur, kfs, lm_index


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_gather_observations_matches_the_fancy_indexed_snapshot(route):
    lm, uv, level, ur, kfs, lm_index = _tables(np.random.default_rng(1))
    okf, okp, olm = native.observations_coo(lm, kfs)
    keep = lm_index[olm] >= 0
    okf, okp, olm = okf[keep], okp[keep], olm[keep]
    n, size = okf.size, okf.size + 77
    kf_pos = np.full(lm.shape[0], -1, np.int32)
    kf_pos[kfs] = np.arange(kfs.size)
    if route == "native":
        assert native.available()
        got = native.gather_observations(lm, uv, level, ur, kfs, lm_index, n,
                                         size)
    else:
        with mock.patch.object(native, "_load", lambda: None):
            got = native.gather_observations(lm, uv, level, ur, kfs, lm_index,
                                             n, size)
    tail = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full((size - n, *a.shape[1:]), fill, a.dtype)])
    want = (okf, okp, tail(kf_pos[okf], 0), tail(lm_index[olm], 0),
            tail(uv[okf, okp], 0.0), tail(level[okf, okp], 0),
            tail(ur[okf, okp], -1.0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        native.gather_observations(lm, uv, level, ur, kfs, lm_index, n - 1,
                                   size)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_remove_landmarks_unbinds_exactly_the_given_landmarks(route):
    rng = np.random.default_rng(2)
    m = MapState(max_kf=16, max_kp=64, max_lm=500)
    bound = rng.random((16, 64)) < 0.6
    m.kf_kp_lm[bound] = rng.integers(0, 500, bound.sum())
    m.lm_valid[:] = True
    ids = rng.choice(500, 40, replace=False)
    before = m.kf_kp_lm.copy()
    if route == "native":
        assert native.available()
        m.remove_landmarks(ids)
    else:
        with mock.patch.object(native, "_load", lambda: None):
            m.remove_landmarks(ids)
    want = np.where(np.isin(before, ids), NO_LM, before)
    np.testing.assert_array_equal(m.kf_kp_lm, want)
    assert not m.lm_valid[ids].any() and m.n_lm == 460
