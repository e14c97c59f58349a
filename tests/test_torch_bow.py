"""BoW vocabulary and keyframe database of the torch port against the JAX
reference, on the descriptors of tests/test_bow.py's rendered sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.bow import KeyframeDatabase as JDatabase
from orb_slam3_study_kr_tpu.bow import vocabulary as jvoc
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.ops import orb
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase as TDatabase
from orb_slam3_study_kr_tpu_torch.bow import vocabulary as tvoc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sequence():
    """tests/test_bow.py's fixture: 10 rendered frames, vocabulary trained
    on every other frame's valid descriptors."""
    rng = np.random.default_rng(7)
    world = synthetic.make_textured_world(np.random.default_rng(3), depth=6.0)
    n = 10
    R, t = synthetic.lateral_trajectory(n, x_span=2.5)
    cfg = orb.OrbConfig()
    frames = []
    for i in range(n):
        img = synthetic.render_textured(world, R[i], t[i], rng=rng)
        f = orb.extract_orb(jnp.asarray(img), cfg)
        frames.append((np.array(f.desc), np.array(f.valid)))
    train = np.concatenate([d[v] for d, v in frames[::2]])
    jv = jvoc.train_vocabulary(train, k=8, L=3, seed=0)
    tv = tvoc.train_vocabulary(train, k=8, L=3, seed=0, device="cpu")
    return frames, jv, tv


def test_train_vocabulary_matches_reference(sequence):
    """Centers exact (the same numpy k-means and seed), idf within 1e-6."""
    _, jv, tv = sequence
    np.testing.assert_array_equal(tv.centers.numpy(), np.asarray(jv.centers))
    assert tv.level_offsets == jv.level_offsets
    np.testing.assert_allclose(tv.word_weights.numpy(),
                               np.asarray(jv.word_weights), atol=1e-6)


def test_transform_word_ids_exact(sequence):
    frames, jv, tv = sequence
    for d, v in frames[:4]:
        jw, jx = jvoc.transform(jv, jnp.asarray(d), jnp.asarray(v))
        tw, tx = tvoc.transform(tv, torch.as_tensor(d), torch.as_tensor(v))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


def _write_dbow2_text(path, k, L, nodes):
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for p, leaf, b, w in nodes:
            f.write(f"{p} {int(leaf)} " + " ".join(str(int(x)) for x in b)
                    + f" {w}\n")


def _unbalanced_nodes(rng):
    """tests/test_bow.py's k=3, L=3 tree: a depth-1 leaf, a node with 2
    (< k) children, depth-2 and depth-3 leaves."""
    b = lambda: rng.integers(0, 256, 32)
    return [(0, 0, b(), 0.0), (0, 0, b(), 0.0), (0, 1, b(), 0.7),
            (1, 1, b(), 1.1), (1, 1, b(), 1.2), (1, 1, b(), 1.3),
            (2, 0, b(), 0.0), (2, 1, b(), 2.1), (7, 1, b(), 3.1),
            (7, 1, b(), 3.2), (7, 1, b(), 3.3)]


def test_dbow2_text_and_transform_tree_exact(tmp_path, sequence):
    """load_dbow2_text arrays equal; transform_tree word ids exact, on
    random bits and on the sequence's descriptors; pack_bits equals
    np.packbits."""
    frames, _, _ = sequence
    rng = np.random.default_rng(5)
    p = tmp_path / "voc.txt"
    _write_dbow2_text(p, 3, 3, _unbalanced_nodes(rng))
    jt = jvoc.load_dbow2_text(p)
    tt = tvoc.load_dbow2_text(p, device="cpu")
    ja, ta = jvoc.vocabulary_arrays(jt), tvoc.vocabulary_arrays(tt)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        if isinstance(ja[k], np.ndarray):
            assert ja[k].dtype == ta[k].dtype, k
            np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
        else:
            assert ja[k] == ta[k], k
    desc = np.concatenate([rng.integers(0, 2, (64, 256)).astype(np.uint8),
                           frames[0][0]])
    valid = np.ones(desc.shape[0], bool)
    jw, jx = jvoc.transform_tree(jt, jnp.asarray(desc), jnp.asarray(valid))
    tw, tx = tvoc.transform_tree(tt, torch.as_tensor(desc),
                                 torch.as_tensor(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_array_equal(tvoc.pack_bits(torch.as_tensor(desc)).numpy(),
                                  np.packbits(desc, axis=-1))


def test_vocabulary_roundtrip_and_checksum(tmp_path, sequence):
    """save/load round trip in the port; the checksum equals the
    reference's for the trained and the text-loaded vocabulary; the port
    loads the reference's .npz and the reference's arrays
    (convert.vocabulary_from_numpy) with the same checksum."""
    frames, jv, tv = sequence
    d, v = (torch.as_tensor(a) for a in frames[0])
    p = tmp_path / "port.npz"
    tvoc.save_vocabulary(tv, p)
    tv2 = tvoc.load_vocabulary(p, device="cpu")
    for a, b in zip(tvoc.words_and_weights(tv, d, v),
                    tvoc.words_and_weights(tv2, d, v)):
        assert torch.equal(a, b)
    assert tvoc.vocabulary_checksum(tv) == jvoc.vocabulary_checksum(jv)
    assert tvoc.vocabulary_checksum(tv2) == jvoc.vocabulary_checksum(jv)
    pj = tmp_path / "ref.npz"
    jvoc.save_vocabulary(jv, pj)
    assert (tvoc.vocabulary_checksum(tvoc.load_vocabulary(pj, device="cpu"))
            == jvoc.vocabulary_checksum(jv))
    conv = convert.vocabulary_from_numpy(jvoc.vocabulary_arrays(jv),
                                         device="cpu")
    assert tvoc.vocabulary_checksum(conv) == jvoc.vocabulary_checksum(jv)
    rng = np.random.default_rng(5)
    pt = tmp_path / "voc.txt"
    _write_dbow2_text(pt, 3, 3, _unbalanced_nodes(rng))
    assert (tvoc.vocabulary_checksum(tvoc.load_dbow2_text(pt, device="cpu"))
            == jvoc.vocabulary_checksum(jvoc.load_dbow2_text(pt)))


def test_database_candidates_match_reference(sequence):
    """detect_candidates (with exclusion and covisibility accumulation) and
    detect_relocalization_candidates: the same ids, the same sparse
    vectors; scores within 1e-6."""
    frames, jv, tv = sequence
    jdb, tdb = JDatabase(jv), TDatabase(tv)
    for i, (d, v) in enumerate(frames[1:], start=1):
        jdb.add(i, d, v)
        tdb.add(i, d, v)
    for i in jdb.vectors:
        np.testing.assert_array_equal(tdb.vectors[i][0], jdb.vectors[i][0])
        np.testing.assert_allclose(tdb.vectors[i][1], jdb.vectors[i][1],
                                   atol=1e-6)
    d0, v0 = frames[0]
    cov = lambda k: [k - 1, k + 1]
    for kw in (dict(n_best=3), dict(exclude=(1, 2, 3), n_best=3),
               dict(covisibility=cov, n_best=5)):
        assert (tdb.detect_candidates(d0, v0, **kw)
                == jdb.detect_candidates(d0, v0, **kw)), kw
    assert (tdb.detect_relocalization_candidates(d0, v0)
            == jdb.detect_relocalization_candidates(d0, v0))
    from orb_slam3_study_kr_tpu.bow.database import sparse_l1_score as j_score
    from orb_slam3_study_kr_tpu_torch.bow.database import sparse_l1_score, sparse_bow
    qw, qv = sparse_bow(tv, d0, v0)
    for i in tdb.vectors:
        assert abs(sparse_l1_score(qw, qv, *tdb.vectors[i])
                   - j_score(qw, qv, *jdb.vectors[i])) < 1e-6
    tdb.erase(1)
    jdb.erase(1)
    assert (tdb.detect_candidates(d0, v0, n_best=5)
            == jdb.detect_candidates(d0, v0, n_best=5))
