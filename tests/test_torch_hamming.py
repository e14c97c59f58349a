"""K3 (masked Hamming nearest neighbour) and descriptor matching in the
torch port against the JAX reference.  On the CPU the K3 wrapper runs its
plain version; the CUDA kernel is held to it in
tests/test_torch_cuda_kernels.py.  Hamming distances are integer
popcounts, so every comparison here is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.ops.matching import BIG, hamming_matrix
from orb_slam3_study_kr_tpu.ops.pallas_matching import hamming_nn_pallas
from orb_slam3_study_kr_tpu.ops.track_match import (
    match_by_descriptor as j_match_by_descriptor)
from orb_slam3_study_kr_tpu_torch.ops import cuda_hamming
from orb_slam3_study_kr_tpu_torch.ops.track_match import (
    match_by_descriptor, match_by_descriptor_plain)

torch.set_num_threads(2)


def _bits(rng, shape):
    return (rng.random(shape) > 0.5).astype(np.uint8)


def _T(a):
    return torch.as_tensor(np.asarray(a))


def test_hamming_nn_plain_matches_pallas_interpret():
    """Q=128, T=1024 (the reference kernel's own test shape): best and
    second exact, idx a true minimizer and equal to the dense first-index
    argmin."""
    rng = np.random.default_rng(0)
    Q, T = 128, 1024
    q, t = _bits(rng, (Q, 256)), _bits(rng, (T, 256))
    tv = rng.random(T) > 0.2
    jb, js, ji = hamming_nn_pallas(jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(tv.astype(np.float32)),
                                   tile_t=256, interpret=True)
    best, second, idx = cuda_hamming.hamming_nn(
        _T(q), torch.ones(Q, dtype=torch.bool), _T(t), _T(tv))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(second.numpy(), np.asarray(js))
    D = np.where(tv[None], np.asarray(hamming_matrix(jnp.asarray(q),
                                                     jnp.asarray(t))), BIG)
    idx = idx.numpy()
    assert (D[np.arange(Q), idx] == np.asarray(jb)).all()
    np.testing.assert_array_equal(idx, D.argmin(1))
    assert idx.dtype == np.int32


def test_hamming_nn_all_invalid():
    """No valid target: idx 0, best = second = BIG on every row, as argmin
    over an all-BIG row (and the reference kernel's BIG)."""
    rng = np.random.default_rng(1)
    Q, T = 16, 256
    q, t = _bits(rng, (Q, 256)), _bits(rng, (T, 256))
    jb, js, _ = hamming_nn_pallas(jnp.asarray(q), jnp.asarray(t),
                                  jnp.zeros(T, jnp.float32), tile_t=128,
                                  interpret=True)
    best, second, idx = cuda_hamming.hamming_nn(
        _T(q), torch.ones(Q, dtype=torch.bool), _T(t),
        torch.zeros(T, dtype=torch.bool))
    assert (idx.numpy() == 0).all()
    assert (best.numpy() == BIG).all() and (second.numpy() == BIG).all()
    assert float(jnp.min(jb)) >= BIG * 0.99 and float(jnp.min(js)) >= BIG * 0.99


def test_hamming_nn_query_gate_and_ties():
    """An invalid query row scores BIG against every target; a tie at
    another index gives second == best and keeps the lowest index; T = 1
    leaves second = BIG."""
    rng = np.random.default_rng(2)
    proto = _bits(rng, (3, 256))
    q = proto[rng.integers(0, 3, 40)]
    t = proto[rng.integers(0, 3, 50)]
    qv = rng.random(40) > 0.3
    tv = rng.random(50) > 0.2
    best, second, idx = (x.numpy() for x in cuda_hamming.hamming_nn(
        _T(q), _T(qv), _T(t), _T(tv)))
    D = (q[:, None, :] != t[None, :, :]).sum(-1).astype(np.float32)
    D = np.where(qv[:, None] & tv[None, :], D, BIG)
    np.testing.assert_array_equal(idx, D.argmin(1))
    np.testing.assert_array_equal(best, D.min(1))
    D2 = D.copy()
    D2[np.arange(40), D.argmin(1)] = BIG
    np.testing.assert_array_equal(second, D2.min(1))
    assert (best[~qv] == BIG).all() and (idx[~qv] == 0).all()
    assert (second[qv] == best[qv]).any()         # ties among prototypes
    b1, s1, i1 = cuda_hamming.hamming_nn(_T(q), _T(qv), _T(t[:1]),
                                         torch.ones(1, dtype=torch.bool))
    assert (s1.numpy() == BIG).all() and (i1.numpy() == 0).all()


def _match_case(rng, n_q=300, n_t=280, W=None):
    """Query set and (W?) target sets with shared features (bit-flipped
    copies) so that the ratio and mutual checks both bite."""
    base = _bits(rng, (400, 256))
    q = base[rng.permutation(400)[:n_q]]

    def one():
        tt = base[rng.permutation(400)[:n_t]].copy()
        flip = rng.random(tt.shape) < 0.03
        return np.where(flip, 1 - tt, tt).astype(np.uint8), rng.random(n_t) > 0.2

    qv = rng.random(n_q) > 0.1
    if W is None:
        t, tv = one()
    else:
        t, tv = (np.stack(a) for a in zip(*[one() for _ in range(W)]))
    return q, qv, t, tv


def test_match_by_descriptor_matches_reference():
    rng = np.random.default_rng(3)
    q, qv, t, tv = _match_case(rng)
    ji, jok, jb = j_match_by_descriptor(jnp.asarray(q), jnp.asarray(qv),
                                        jnp.asarray(t), jnp.asarray(tv))
    idx, ok, best = match_by_descriptor(_T(q), _T(qv), _T(t), _T(tv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    assert 50 < ok.numpy().sum() < qv.sum()


def test_match_by_descriptor_window_matches_reference_vmap():
    """The loop window form: one query set against W=3 target sets, as the
    reference's vmap over targets (loop_closing.py:261-263)."""
    rng = np.random.default_rng(4)
    q, qv, t, tv = _match_case(rng, W=3)
    qd, qvd = jnp.asarray(q), jnp.asarray(qv)
    ji, jok, jb = jax.vmap(lambda td, tvv: j_match_by_descriptor(
        qd, qvd, td, tvv))(jnp.asarray(t), jnp.asarray(tv))
    idx, ok, best = match_by_descriptor(_T(q), _T(qv), _T(t), _T(tv))
    assert idx.shape == (3, q.shape[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))


@pytest.mark.parametrize("W", [None, 3])
def test_match_by_descriptor_equals_plain(W):
    """The K3 route (row + column pass) gives the dense form's answer."""
    rng = np.random.default_rng(5)
    q, qv, t, tv = _match_case(rng, W=W)
    a = match_by_descriptor(_T(q), _T(qv), _T(t), _T(tv))
    b = match_by_descriptor_plain(_T(q), _T(qv), _T(t), _T(tv))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _j_masked(q, qv, t, tv):
    """The reference's masked matrix (track_match.py:211-213)."""
    d = hamming_matrix(jnp.asarray(q), jnp.asarray(t))
    return jnp.where(jnp.asarray(qv)[:, None] & jnp.asarray(tv)[None, :], d, BIG)


def _j_back(q, qv, t, tv):
    """The reference's column argmin (track_match.py:219)."""
    return jnp.argmin(_j_masked(q, qv, t, tv), axis=0)


def _tie_case(rng, Q, T, n_proto=4):
    """Descriptors from a few prototypes (many column ties), a share of
    invalid queries and targets."""
    proto = _bits(rng, (n_proto, 256))
    q = proto[rng.integers(0, n_proto, Q)]
    t = proto[rng.integers(0, n_proto, T)]
    return q, rng.random(Q) > 0.3, t, rng.random(T) > 0.25


def test_hamming_nn_columns_match_reference():
    """back (the column output of the one masked matrix) equals the
    reference's jnp.argmin over axis 0 exactly: column ties among
    prototypes go to the lowest valid query, an invalid target gets 0;
    the rows of the same call equal hamming_nn's."""
    rng = np.random.default_rng(6)
    q, qv, t, tv = _tie_case(rng, 60, 70)
    tv[:3] = False
    best, second, idx, back = cuda_hamming.hamming_nn_match(
        _T(q), _T(qv), _T(t), _T(tv))
    jback = np.asarray(_j_back(q, qv, t, tv))
    np.testing.assert_array_equal(back.numpy(), jback)
    assert back.dtype == torch.int32 and back.shape == (70,)
    assert (back.numpy()[~tv] == 0).all()
    first_valid = int(np.nonzero(qv)[0][0])
    assert (jback[tv] >= first_valid).all()
    D = np.asarray(_j_masked(q, qv, t, tv))
    assert (D[back.numpy(), np.arange(70)] == D.min(0)).all()
    for x, y in zip((best, second, idx), cuda_hamming.hamming_nn(
            _T(q), _T(qv), _T(t), _T(tv))):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(D.argmin(1)))


def test_hamming_nn_columns_window_matches_reference_vmap():
    """The loop window layout, W = 3 target sets against one shared query
    set, against jax.vmap of the reference's expression; one target set
    all invalid."""
    rng = np.random.default_rng(7)
    q, qv, _, _ = _tie_case(rng, 50, 1)
    t = np.stack([_tie_case(rng, 1, 40)[2] for _ in range(3)])
    tv = rng.random((3, 40)) > 0.25
    tv[1] = False
    jback = jax.vmap(lambda td, tvv: _j_back(q, qv, td, tvv))(
        jnp.asarray(t), jnp.asarray(tv))
    best, second, idx, back = cuda_hamming.hamming_nn_match(
        _T(q), _T(qv), _T(t), _T(tv))
    assert back.shape == (3, 40) and idx.shape == (3, 50)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert (back.numpy()[1] == 0).all()


@pytest.mark.parametrize("Q,T", [(1, 30), (30, 1), (1, 1)])
def test_hamming_nn_columns_single_row_or_column(Q, T):
    """Q = 1 and T = 1: back and the rows equal the reference's argmins."""
    rng = np.random.default_rng(8 + Q + T)
    q, qv, t, tv = _tie_case(rng, Q, T, n_proto=2)
    qv[:] = True
    best, second, idx, back = cuda_hamming.hamming_nn_match(
        _T(q), _T(qv), _T(t), _T(tv))
    D = _j_masked(q, qv, t, tv)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jnp.argmin(D, axis=0)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argmin(D, axis=1)))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jnp.min(D, axis=1)))
