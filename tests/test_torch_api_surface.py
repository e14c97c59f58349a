"""The port's public surface against the reference's.

Both packages are walked with ``ast`` (nothing is imported): every public
top-level function and class of each module of the JAX package must have a
namesake in the port's module of the same path, unless ``EXEMPT`` names it
with its reason.  The names the port gained for this each get a parity
test against the reference below.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.bow import vocabulary as jvoc
from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.ops import geometry as jgeo
from orb_slam3_study_kr_tpu.ops import klt as jklt
from orb_slam3_study_kr_tpu.ops import matching as jmatching
from orb_slam3_study_kr_tpu.ops import orb as jorb
from orb_slam3_study_kr_tpu.ops import triangulation_match as jtm
from orb_slam3_study_kr_tpu_torch.bow import vocabulary as tvoc
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.lie import se3 as tse3
from orb_slam3_study_kr_tpu_torch.lie import sim3 as tsim3
from orb_slam3_study_kr_tpu_torch.ops import geometry as tgeo
from orb_slam3_study_kr_tpu_torch.ops import klt as tklt
from orb_slam3_study_kr_tpu_torch.ops import matching as tmatching
from orb_slam3_study_kr_tpu_torch.ops import orb as torb
from orb_slam3_study_kr_tpu_torch.ops import triangulation_match as ttm

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "orb_slam3_study_kr_tpu"
PORT = ROOT / "orb_slam3_study_kr_tpu_torch"

# module (path under the package) -> {name: reason}; "*" exempts the module.
EXEMPT = {
    "ops/pallas_fast.py": {
        "*": "the Pallas kernel K1; csrc/fast_nms_blur.cu behind "
             "ops/cuda_fast.py takes its place"},
    "ops/pallas_matching.py": {
        "*": "the Pallas kernels K2 and K3; csrc/gated_nn.cu and "
             "csrc/hamming_nn.cu behind ops/cuda_matching.py and "
             "ops/cuda_hamming.py take their place"},
    "ops/track_match.py": {
        "match_local_map_auto": "the use_pallas dual path (ROADMAP: do not "
                                "port); match_local_map runs the kernel on "
                                "CUDA and torch elsewhere",
        "match_local_map_pallas": "the same dual path's Pallas branch"},
}


def _public(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def test_every_public_name_has_a_counterpart():
    missing = []
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        exempt = EXEMPT.get(rel, {})
        if "*" in exempt:
            continue
        port = PORT / rel
        have = _public(port) if port.exists() else set()
        missing += [f"{rel}:{n}" for n in sorted(_public(ref) - have)
                    if n not in exempt]
    assert not missing, missing


def test_exemptions_are_live_and_reasoned():
    """Every exemption names a reference module and name that exist, and
    gives a reason; an exempted name the port gained is no longer
    exempt."""
    for rel, names in EXEMPT.items():
        assert (REF / rel).exists(), rel
        for name, reason in names.items():
            assert len(reason) > 20, (rel, name)
            if name != "*":
                assert name in _public(REF / rel), (rel, name)
                assert not (PORT / rel).exists() or \
                    name not in _public(PORT / rel), (rel, name)


def _T(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol)


# ------------------------------------------------------------ lie, geometry


def test_se3_sim3_helpers_match_reference():
    rng = np.random.default_rng(0)
    R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        rng.normal(0, 0.5, (4, 6)), jnp.float32)))
    p = rng.normal(0, 2, (4, 3)).astype(np.float32)
    _close(tse3.se3_apply(_T(R), _T(t), _T(p)), jlie.se3_apply(R, t, p), 1e-6)
    T4 = tse3.se3_matrix(_T(R), _T(t))
    np.testing.assert_array_equal(T4.numpy(), np.asarray(jlie.se3_matrix(R, t)))
    for a, b in zip(tse3.se3_from_matrix(T4), jlie.se3_from_matrix(T4.numpy())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for shape in ((), (3,)):
        for a, b in zip(tse3.se3_identity(shape), jlie.se3_identity(shape)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tsim3.sim3_identity(shape), jlie.sim3_identity(shape)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_geometry_helpers_match_reference():
    rng = np.random.default_rng(1)
    R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        rng.normal(0, 0.3, (2, 6)), jnp.float32)))
    K1 = np.array([[458.0, 0, 376.0], [0, 457.0, 240.0], [0, 0, 1]], np.float32)
    K2 = np.array([[190.9, 0, 254.9], [0, 190.9, 256.9], [0, 0, 1]], np.float32)
    _close(tgeo.essential_from_pose(_T(R[0]), _T(t[0])),
           jgeo.essential_from_pose(R[0], t[0]), 1e-6)
    F = tgeo.fundamental_from_poses(_T(K1), _T(K2), _T(R[0]), _T(t[0]),
                                    _T(R[1]), _T(t[1]))
    Fj = np.asarray(jgeo.fundamental_from_poses(K1, K2, R[0], t[0], R[1], t[1]))
    np.testing.assert_allclose(F.numpy(), Fj, rtol=1e-5, atol=1e-9)
    uv = rng.uniform(0, 500, (2, 20, 2)).astype(np.float32)
    _close(tgeo.reprojection_error(_T(uv[0]), _T(uv[1])),
           jgeo.reprojection_error(uv[0], uv[1]), 1e-4)
    pw = rng.normal(0, 3, (20, 3)).astype(np.float32)
    c = rng.normal(0, 1, (2, 3)).astype(np.float32)
    _close(tgeo.parallax_cos(_T(pw), _T(c[0]), _T(c[1])),
           jgeo.parallax_cos(pw, c[0], c[1]), 1e-6)


def test_scale_band_mask_matches_reference():
    rng = np.random.default_rng(2)
    l1, l2 = (rng.integers(0, 8, n).astype(np.int32) for n in (30, 40))
    for lo, hi in ((-1, 1), (0, 2)):
        np.testing.assert_array_equal(
            tmatching.scale_band_mask(_T(l1), _T(l2), lo, hi).numpy(),
            np.asarray(jmatching.scale_band_mask(l1, l2, lo, hi)))


# ------------------------------------------------------------------- BoW


def test_bow_vectors_and_l1_score_match_reference():
    rng = np.random.default_rng(3)
    train = rng.integers(0, 2, (600, 256)).astype(np.uint8)
    jv = jvoc.train_vocabulary(train, k=4, L=2, seed=0)
    tv = tvoc.train_vocabulary(train, k=4, L=2, seed=0, device="cpu")
    desc = rng.integers(0, 2, (2, 80, 256)).astype(np.uint8)
    valid = rng.random((2, 80)) < 0.9
    vs = []
    for d, v in zip(desc, valid):
        jb = np.asarray(jvoc.bow_vector(jv, jnp.asarray(d), jnp.asarray(v)))
        tb = tvoc.bow_vector(tv, _T(d), _T(v))
        _close(tb, jb, 1e-6)
        _close(tvoc.bow_vector_any(tv, _T(d), _T(v)),
               jvoc.bow_vector_any(jv, jnp.asarray(d), jnp.asarray(v)), 1e-6)
        vs.append((tb, jb))
    _close(tvoc.l1_score(vs[0][0], vs[1][0]),
           jvoc.l1_score(vs[0][1], vs[1][1]), 1e-6)
    assert abs(float(tvoc.l1_score(vs[0][0], vs[0][0])) - 1.0) < 1e-6


# -------------------------------------------------------------- ORB, KLT


@pytest.fixture(scope="module")
def level_image():
    world = synthetic.make_textured_world(np.random.default_rng(4), width=320,
                                          height=240, depth=6.0)
    img = synthetic.render_textured(world, np.eye(3), np.zeros(3),
                                    rng=np.random.default_rng(5))
    return img.astype(np.float32)


def _keypoints(img, n=120, margin=0):
    rng = np.random.default_rng(6)
    H, W = img.shape
    xs = rng.integers(margin, W - margin, n).astype(np.int32)
    ys = rng.integers(margin, H - margin, n).astype(np.int32)
    return xs, ys, rng.uniform(-np.pi, np.pi, n).astype(np.float32)


def test_orb_keypoint_helpers_match_reference(level_image):
    """Integer windows and the nearest-sampled rotated BRIEF bits exact,
    keypoints at the border included; the intensity-centroid angle within
    1e-4 rad; the bilinear oriented patches within 1e-3 gray levels; the
    parabolic refinement within 1e-6 px."""
    img = level_image
    xs, ys, ang = _keypoints(img)
    jimg = jnp.asarray(img)
    np.testing.assert_array_equal(
        torb.gather_patches(_T(img), _T(xs), _T(ys), 15).numpy(),
        np.asarray(jorb.gather_patches(jimg, jnp.asarray(xs), jnp.asarray(ys), 15)))
    _close(torb.compute_orientation(_T(img), _T(xs), _T(ys)),
           jorb.compute_orientation(jimg, jnp.asarray(xs), jnp.asarray(ys)), 1e-4)
    blur = np.asarray(jorb.gaussian_blur7(jimg))
    np.testing.assert_array_equal(
        torb.compute_descriptors(_T(blur), _T(xs), _T(ys), _T(ang)).numpy(),
        np.asarray(jorb.compute_descriptors(jnp.asarray(blur), jnp.asarray(xs),
                                            jnp.asarray(ys), jnp.asarray(ang))))
    fx = xs + np.float32(0.3)
    fy = ys - np.float32(0.2)
    _close(torb.gather_oriented_patches(_T(blur), _T(fx), _T(fy), _T(ang)),
           jorb.gather_oriented_patches(jnp.asarray(blur), jnp.asarray(fx),
                                        jnp.asarray(fy), jnp.asarray(ang)), 1e-3)
    score = np.asarray(jorb.fast_score_map(jimg, 7.0))
    for a, b in zip(torb.subpixel_refine(_T(score), _T(xs).long(), _T(ys).long()),
                    jorb.subpixel_refine(jnp.asarray(score), jnp.asarray(xs),
                                         jnp.asarray(ys))):
        _close(a, b, 1e-6)


def test_stack_pyramid_matches_reference_and_extract_orb(level_image):
    """The padded stack equals the reference's, and extract_orb's
    with_pyramid stack is stack_pyramid of its blurred levels."""
    levels = [level_image[: 240 - 40 * i, : 320 - 50 * i] for i in range(3)]
    np.testing.assert_array_equal(
        tklt.stack_pyramid([_T(a) for a in levels]).numpy(),
        np.asarray(jklt.stack_pyramid([jnp.asarray(a) for a in levels])))
    cfg = torb.OrbConfig(n_features=200, height=240, width=320)
    _, pyr = torb.extract_orb(_T(level_image), cfg, with_pyramid=True)
    assert pyr.shape == (cfg.n_levels, 240, 320)
    for l, (h, w) in enumerate(cfg.level_sizes):
        assert not pyr[l, h:].any() and not pyr[l, :, w:].any()


# ------------------------------------------------- epipolar triangulation


def test_match_and_triangulate_single_pair_matches_reference():
    """The reference's single-pair signature, with and without angles:
    idx2, matched and good exact, X within 1e-3 on the good pairs, cos_par
    within 1e-5; the port's pair equals its batch of one."""
    rng = np.random.default_rng(7)
    n = 150
    params = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
    jproj = functools.partial(jpinhole.project, jnp.asarray(params))
    tproj = functools.partial(tpinhole.project, torch.as_tensor(params))
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 8, n)], -1).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2, t2 = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        [0.0, 0.05, 0.0, -0.4, 0.0, 0.02], jnp.float32)))
    perm = rng.permutation(n)
    uv1 = np.asarray(jproj(jnp.asarray(X))) + rng.normal(0, 0.3, (n, 2))
    uv2 = np.asarray(jproj(jnp.asarray(X[perm] @ R2.T + t2))) \
        + rng.normal(0, 0.3, (n, 2))
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    Kinv = np.linalg.inv(np.array([[458.0, 0, 376], [0, 457, 240], [0, 0, 1]]))
    b1 = (np.concatenate([uv1, np.ones((n, 1))], 1) @ Kinv.T).astype(np.float32)
    b2 = (np.concatenate([uv2, np.ones((n, 1))], 1) @ Kinv.T).astype(np.float32)
    desc1 = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    desc2 = desc1[perm].copy()
    flip = rng.random(desc2.shape) < 0.05
    desc2[flip] ^= 1
    lvl = rng.integers(0, 3, (2, n)).astype(np.int32)
    free = rng.random((2, n)) < 0.9
    ang1 = rng.uniform(0, 0.2, n).astype(np.float32)
    ang2 = ang1[perm] + np.float32(0.05)
    common = (uv1, b1, lvl[0], desc1, free[0], uv2, b2, lvl[1], desc2, free[1])
    for angles in ((None, None), (ang1, ang2)):
        jo = jtm.match_and_triangulate(
            *map(jnp.asarray, (R1, t1, R2, t2)), jproj, 458.0,
            *map(jnp.asarray, common),
            *(None if a is None else jnp.asarray(a) for a in angles))
        to = ttm.match_and_triangulate(
            *map(_T, (R1, t1, R2, t2)), tproj, 458.0, *map(_T, common),
            *(None if a is None else _T(a) for a in angles))
        for k in ("idx2", "matched", "good"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
        good = to["good"].numpy()
        assert good.sum() > 50
        _close(to["X"].numpy()[good], np.asarray(jo["X"])[good], 1e-3)
        _close(to["cos_par"].numpy()[good], np.asarray(jo["cos_par"])[good], 1e-5)
    tb = ttm.match_and_triangulate_batch(
        *map(_T, (R1, t1, R2[None], t2[None])), tproj, 458.0,
        *map(_T, common[:5]), *(_T(a[None]) for a in common[5:]),
        _T(ang1), _T(ang2[None]))
    for k in ("idx2", "X", "good"):
        assert torch.equal(tb[k][0], to[k])
