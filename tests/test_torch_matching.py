"""Parity of the torch port's matchers and K2's plain version with the JAX
reference package.  Hamming distances are exact integers in both (float32
sums of 0/1 products), so indices, masks and distances compare exactly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.ops import matching as jmatching
from orb_slam3_study_kr_tpu.ops import track_match as jtm
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.ops import matching as tmatching
from orb_slam3_study_kr_tpu_torch.ops import track_match as ttm
from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import (
    BIG, gated_nn, gated_nn_plain, pack_desc)

torch.set_num_threads(2)

PARAMS = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
j_project = functools.partial(jpinhole.project, jnp.asarray(PARAMS))
t_project = functools.partial(tpinhole.project, torch.as_tensor(PARAMS))


def _bits(rng, shape, p=0.5):
    return (rng.random(shape) < p).astype(np.uint8)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _bits(rng, (70, 256)), _bits(rng, (90, 256))
    d = tmatching.hamming_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(d, ref)
    np.testing.assert_array_equal(
        d, np.asarray(jmatching.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


def test_pack_desc_popcount_roundtrip():
    rng = np.random.default_rng(1)
    a = _bits(rng, (5, 256))
    w = pack_desc(torch.as_tensor(a)).numpy().view(np.uint32)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little").reshape(5, 256)
    np.testing.assert_array_equal(bits, a)


def _frames(seed, n1=200, n2=220):
    rng = np.random.default_rng(seed)
    uv1 = rng.uniform(0, 300, (n1, 2)).astype(np.float32)
    d1 = _bits(rng, (n1, 256))
    a1 = rng.uniform(-np.pi, np.pi, n1).astype(np.float32)
    perm = rng.permutation(n2)[:n1]
    uv2 = rng.uniform(0, 300, (n2, 2)).astype(np.float32)
    d2 = _bits(rng, (n2, 256))
    a2 = rng.uniform(-np.pi, np.pi, n2).astype(np.float32)
    # Half of frame 1 reappears in frame 2: shifted, rotated, few bit flips.
    k = n1 // 2
    uv2[perm[:k]] = uv1[:k] + rng.normal(0, 3, (k, 2)).astype(np.float32)
    d2[perm[:k]] = np.where(rng.random((k, 256)) < 0.05, 1 - d1[:k], d1[:k])
    a2[perm[:k]] = a1[:k] - 0.2
    v1 = rng.random(n1) < 0.95
    v2 = rng.random(n2) < 0.95
    return uv1, d1, a1, v1, uv2, d2, a2, v2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_for_initialization_exact(seed):
    args = _frames(seed)
    j = jmatching.search_for_initialization(*[jnp.asarray(a) for a in args])
    t = tmatching.search_for_initialization(*[torch.as_tensor(a) for a in args])
    jidx, jok, jbest = [np.asarray(x) for x in j]
    tidx, tok, tbest = [x.numpy() for x in t]
    assert jok.sum() > 20
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tbest, jbest)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_by_descriptor_exact(seed):
    uv1, d1, a1, v1, uv2, d2, a2, v2 = _frames(seed)
    j = jtm.match_by_descriptor(jnp.asarray(d1), jnp.asarray(v1),
                                jnp.asarray(d2), jnp.asarray(v2))
    t = ttm.match_by_descriptor(torch.as_tensor(d1), torch.as_tensor(v1),
                                torch.as_tensor(d2), torch.as_tensor(v2))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _local_map_problem(seed, L=256, N=128):
    """The reference's own K2 A/B scenario (tests/test_pallas_matching.py)."""
    rng = np.random.default_rng(seed)
    lm_pos = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                       rng.uniform(3, 9, L)], -1).astype(np.float32)
    dirs = (lm_pos / np.linalg.norm(lm_pos, axis=-1, keepdims=True)).astype(np.float32)
    lm_min = rng.uniform(0.5, 1.0, L).astype(np.float32)
    lm_max = rng.uniform(8, 20, L).astype(np.float32)
    lm_desc = _bits(rng, (L, 256))
    lm_mask = (rng.random(L) < 0.9).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    uv_lm = np.asarray(j_project(jnp.asarray(lm_pos)))
    f_uv = uv_lm[:N] + rng.normal(0, 1.0, (N, 2)).astype(np.float32)
    f_desc = np.where(rng.random((N, 256)) < 0.02, 1 - lm_desc[:N],
                      lm_desc[:N]).astype(np.uint8)
    f_level = rng.integers(0, 3, N).astype(np.int32)
    f_valid = rng.random(N) < 0.95
    return (R, t, lm_pos, dirs, lm_min, lm_max, lm_desc, lm_mask,
            f_uv, f_level, f_desc, f_valid)


@pytest.mark.parametrize("seed,th,slack", [(5, 3.0, 7), (6, 1.0, 1), (7, 6.0, 7)])
def test_match_local_map_plain_matches_jax_and_pallas(seed, th, slack):
    """(slot, ok, visible) exact against the jnp matcher; against the Pallas
    gated-NN path (interpret mode) visible/ok exact and slot on ok rows."""
    arrs = _local_map_problem(seed)
    kw = dict(th=th, level_slack=slack)
    jargs = (j_project, *[jnp.asarray(a) for a in arrs], 752, 480)
    targs = (t_project, *[torch.as_tensor(a) for a in arrs], 752, 480)
    js, jo, jv = [np.asarray(x) for x in jtm.match_local_map(*jargs, **kw)]
    ts, to, tv = [x.numpy() for x in ttm.match_local_map(*targs, **kw)]
    assert jo.sum() > 10
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ts, js)
    ps, po, pv = [np.asarray(x) for x in jtm.match_local_map_pallas(
        *jargs, interpret=True, **kw)]
    np.testing.assert_array_equal(tv, pv)
    np.testing.assert_array_equal(to, po)
    np.testing.assert_array_equal(ts[to], ps[po])


def test_match_local_map_batch_exact():
    """Fuse-style batched matching (vmap in the reference, one batched K2
    call here) against the reference, neighbour by neighbour."""
    rng = np.random.default_rng(11)
    B, L, N = 3, 256, 128
    base = _local_map_problem(11, L, N)
    R = np.stack([np.eye(3, dtype=np.float32)] * B)
    t = np.stack([np.zeros(3, np.float32), np.array([0.05, 0, 0], np.float32),
                  np.array([0, -0.03, 0.1], np.float32)])
    masks = np.stack([base[7], base[7] * (rng.random(L) < 0.7), np.zeros(L, np.float32)])
    f_uv = np.stack([base[8] + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
                     for _ in range(B)])
    f_level = np.stack([base[9]] * B)
    f_desc = np.stack([base[10]] * B)
    f_valid = np.stack([base[11], base[11], np.zeros(N, bool)])
    arrs = (R, t, *base[2:7], masks, f_uv, f_level, f_desc, f_valid)
    kw = dict(th=3.0, max_dist=50.0)
    j = jtm.match_local_map_batch(j_project, *[jnp.asarray(a) for a in arrs],
                                  752, 480, **kw)
    tt = ttm.match_local_map_batch(t_project, *[torch.as_tensor(a) for a in arrs],
                                   752, 480, **kw)
    for a, b in zip(tt, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(j[1])[0].sum() > 5


def _gated_args(q_desc, t_desc, q_valid=None, t_valid=None, radius=1e6):
    N, L = q_desc.shape[0], t_desc.shape[0]
    return (torch.as_tensor(q_desc), torch.zeros(N, 2), torch.zeros(N, dtype=torch.int32),
            torch.ones(N, dtype=torch.bool) if q_valid is None else torch.as_tensor(q_valid),
            torch.as_tensor(t_desc), torch.zeros(L, 2), torch.full((L,), radius),
            torch.zeros(L, dtype=torch.int32),
            torch.ones(L, dtype=torch.bool) if t_valid is None else torch.as_tensor(t_valid))


def test_gated_nn_tie_first_index_and_second_equals_best():
    """Equal distances at several indices: idx is the first of them and
    second == best (so the ratio test fails), as jnp.argmin gives."""
    rng = np.random.default_rng(3)
    q = _bits(rng, (4, 256))
    t = _bits(rng, (40, 256))
    t[[7, 19, 33]] = q[0]          # three exact copies of query 0
    t[[12, 30]] = q[1]             # two copies of query 1
    t[25] = q[2]                   # a unique copy of query 2
    best, second, idx = gated_nn(*_gated_args(q, t))
    assert idx[0] == 7 and best[0] == 0 and second[0] == 0
    assert idx[1] == 12 and best[1] == 0 and second[1] == 0
    assert idx[2] == 25 and best[2] == 0 and second[2] > 0
    d = (q[:, None, :] != t[None]).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), d.argmin(1))


def test_gated_nn_all_gated():
    """Every landmark gated: idx 0 and best = second = BIG."""
    rng = np.random.default_rng(4)
    q, t = _bits(rng, (6, 256)), _bits(rng, (17, 256))
    q_valid = np.array([True, False, True, True, True, True])
    t_valid = np.zeros(17, bool)
    best, second, idx = gated_nn(*_gated_args(q, t, q_valid, t_valid))
    assert (best.numpy() == BIG).all() and (second.numpy() == BIG).all()
    assert (idx.numpy() == 0).all()
    # A single ungated landmark: second stays BIG.
    t_valid[9] = True
    best, second, idx = gated_nn(*_gated_args(q, t, q_valid, t_valid))
    assert (idx.numpy()[q_valid] == 9).all()
    assert (second.numpy() == BIG).all()
    assert best.numpy()[1] == BIG


def test_gated_nn_plain_batched_equals_unbatched():
    arrs = _local_map_problem(9)
    rng = np.random.default_rng(9)
    q = torch.as_tensor(arrs[10])
    t = torch.as_tensor(arrs[6])
    N, L = q.shape[0], t.shape[0]
    uv = torch.as_tensor(rng.uniform(0, 50, (2, L, 2)).astype(np.float32))
    f_uv = torch.as_tensor(rng.uniform(0, 50, (2, N, 2)).astype(np.float32))
    rad = torch.full((2, L), 20.0)
    lvl_t = torch.as_tensor(rng.integers(0, 4, (2, L)).astype(np.int32))
    lvl_q = torch.as_tensor(rng.integers(0, 4, (2, N)).astype(np.int32))
    vt = torch.as_tensor(rng.random((2, L)) < 0.8)
    vq = torch.ones(2, N, dtype=torch.bool)
    qb = q.expand(2, N, 256)
    batched = gated_nn_plain(qb, f_uv, lvl_q, vq, t, uv, rad, lvl_t, vt)
    for b in range(2):
        one = gated_nn_plain(q, f_uv[b], lvl_q[b], vq[b], t, uv[b], rad[b],
                             lvl_t[b], vt[b])
        for x, y in zip(batched, one):
            np.testing.assert_array_equal(x[b].numpy(), y.numpy())
