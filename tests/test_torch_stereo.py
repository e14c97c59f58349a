"""Parity of the port's stereo pieces with the JAX reference: the stereo
residual row in the reprojection block, the pose solver and bundle
adjustment; the rectified stereo matcher; the RGB-D virtual right
coordinate; and the rectification maps."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.io import rectify as jrectify
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.lie import se3 as jse3
from orb_slam3_study_kr_tpu.ops import orb as jorb
from orb_slam3_study_kr_tpu.ops import stereo as jstereo
from orb_slam3_study_kr_tpu.solvers import bundle_adjust as j_bundle_adjust
from orb_slam3_study_kr_tpu.solvers import optimize_pose as j_optimize_pose
from orb_slam3_study_kr_tpu.solvers.reproj import (
    residual_and_jacobians as j_residuals)
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.io import rectify as trectify
from orb_slam3_study_kr_tpu_torch.ops import stereo as tstereo
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust as t_bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers import optimize_pose as t_optimize_pose
from orb_slam3_study_kr_tpu_torch.solvers.reproj import (
    residual_and_jacobians as t_residuals)

torch.set_num_threads(2)

FX, BASELINE = 458.0, 0.11
BF = FX * BASELINE
PARAMS = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
j_proj = functools.partial(jpinhole.project, jnp.asarray(PARAMS))
j_jac = functools.partial(jpinhole.project_jac, jnp.asarray(PARAMS))
t_proj = functools.partial(tpinhole.project, torch.as_tensor(PARAMS))
t_jac = functools.partial(tpinhole.project_jac, torch.as_tensor(PARAMS))


def _T(a):
    return torch.as_tensor(np.array(a))


def _J(a):
    return jnp.asarray(np.asarray(a))


def _pose(xi):
    return [np.asarray(a) for a in jse3.exp_se3(jnp.asarray(xi, jnp.float32))]


def _stereo_obs(rng, uv, p_cam, frac=0.6, noise=0.5):
    """Right coordinates u - bf / z (+ noise) for a share of the
    observations, -1 (mono) for the rest."""
    ur = uv[:, 0] - BF / p_cam[:, 2] + rng.normal(0, noise, uv.shape[0])
    return np.where(rng.random(uv.shape[0]) < frac, ur, -1.0).astype(np.float32)


def test_reproj_stereo_row_matches_reference():
    """Residuals, both Jacobians and camera points within 1e-5 relative,
    with mixed stereo (ur >= 0) and mono (ur < 0) rows; the mono rows' third
    residual and Jacobian row are exactly zero."""
    rng = np.random.default_rng(0)
    n = 200
    R, t = _pose([0.03, -0.02, 0.01, 0.2, -0.1, 0.05])
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(2, 12, n)], -1).astype(np.float32)
    p = X @ R.T + t
    uv = np.asarray(j_proj(jnp.asarray(p))) + rng.normal(0, 1, (n, 2))
    uv = uv.astype(np.float32)
    ur = _stereo_obs(rng, uv, p)
    assert 50 < (ur >= 0).sum() < n - 50
    jout = j_residuals(j_jac, j_proj, _J(R)[None], _J(t)[None], _J(X), _J(uv),
                       ur_obs=_J(ur), bf=jnp.float32(BF))
    tout = t_residuals(t_jac, t_proj, _T(R)[None], _T(t)[None], _T(X), _T(uv),
                       ur_obs=_T(ur), bf=BF)
    for name, a, b in zip(("r", "J_pose", "J_point", "p"), tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    mono = ur < 0
    assert not tout[0][mono, 2].any() and not tout[1][mono, 2].any()


def _stereo_pose_problem(seed, n=150, outliers=20):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 10, n)], -1).astype(np.float32)
    R, t = _pose([0.02, -0.03, 0.01, 0.1, -0.05, 0.08])
    p = X @ R.T + t
    uv = np.asarray(j_proj(jnp.asarray(p)))
    level = rng.integers(0, 4, n).astype(np.int32)
    uv = uv + rng.normal(0, 0.7, uv.shape).astype(np.float32) * 1.2 ** level[:, None]
    uv[:outliers] += rng.uniform(20, 40, (outliers, 2)).astype(np.float32)
    ur = _stereo_obs(rng, uv, p)
    mask = (rng.random(n) < 0.95).astype(np.float32)
    return X, uv.astype(np.float32), level, mask, ur


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_stereo_matches_reference(seed):
    """Pose solve with stereo rows (per-observation gate 7.815 / 5.991,
    Huber delta its square root) from identity: R, t within 1e-4; the
    inlier masks equal."""
    X, uv, level, mask, ur = _stereo_pose_problem(seed)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (R0, t0, X, uv, level, mask)
    Rj, tj, inj, nj = j_optimize_pose(j_proj, j_jac, *[_J(a) for a in args],
                                      ur_obs=_J(ur), bf=jnp.float32(BF))
    Rt, tt, int_, nt = t_optimize_pose(t_proj, t_jac, *[_T(a) for a in args],
                                       ur_obs=_T(ur), bf=BF)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 100


def _stereo_ba_problem(seed, K_=4, M=120):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                  rng.uniform(4, 8, M)], -1).astype(np.float32)
    Rs, ts, obs = [], [], []
    for k in range(K_):
        R, t = _pose([0, 0.02 * k, 0, -0.1 * k, 0, 0])
        Rs.append(R)
        ts.append(t)
        p = X @ R.T + t
        uv = np.asarray(j_proj(jnp.asarray(p)))
        for m in range(M):
            if rng.random() < 0.85:
                u, v = uv[m] + rng.normal(0, 0.5, 2)
                ur = (u - BF / p[m, 2] + rng.normal(0, 0.5)
                      if rng.random() < 0.6 else -1.0)
                obs.append((k, m, u, v, ur))
    obs = np.asarray(obs)
    ts = np.stack(ts) + rng.normal(0, 0.01, (K_, 3)).astype(np.float32)
    ts[0] = 0
    Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    args = (np.stack(Rs).astype(np.float32), ts.astype(np.float32),
            np.array([1.0] + [0.0] * (K_ - 1), np.float32),
            Xn, np.ones(M, np.float32),
            obs[:, 0].astype(np.int32), obs[:, 1].astype(np.int32),
            obs[:, 2:4].astype(np.float32),
            rng.integers(0, 3, len(obs)).astype(np.int32),
            np.ones(len(obs), np.float32))
    return args, obs[:, 4].astype(np.float32)


@pytest.mark.parametrize("assembly", ["dense", "pcg"])
def test_bundle_adjust_stereo_matches_reference(assembly):
    """LM with stereo rows on a 4-keyframe window, one pose fixed (the
    stereo rows fix the scale): poses within 1e-3 (the existing BA bar),
    points within 5e-3, final chi2 and cost within 1e-3 relative."""
    args, our = _stereo_ba_problem(0)
    assert 0.3 < (our >= 0).mean() < 0.9
    Rj, tj, Xj, cj, costj = j_bundle_adjust(
        j_proj, j_jac, *[_J(a) for a in args], n_iters=10, obs_ur=_J(our),
        bf=jnp.float32(BF), assembly=assembly)
    Rt, tt, Xt, ct, costt = t_bundle_adjust(
        t_proj, t_jac, *[_T(a) for a in args], n_iters=10, obs_ur=_T(our),
        bf=BF, assembly=assembly)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5e-3)
    cj, ct = np.asarray(cj), ct.numpy()
    assert abs(ct.sum() - cj.sum()) <= 1e-3 * cj.sum()
    assert abs(float(costt) - float(costj)) <= 1e-3 * float(costj)


@pytest.fixture(scope="module")
def stereo_pair():
    """``test_stereo_depth_recovery``'s rendered rectified pair and the
    reference's features of both images."""
    rng = np.random.default_rng(0)
    world = synthetic.make_textured_world(np.random.default_rng(2), depth=6.0)
    R = np.eye(3, dtype=np.float32)
    imgL = synthetic.render_textured(world, R, np.zeros(3, np.float32), rng=rng)
    imgR = synthetic.render_textured(world, R, np.array([-BASELINE, 0, 0],
                                                        np.float32), rng=rng)
    cfg = jorb.OrbConfig()
    fL = jorb.extract_orb(jnp.asarray(imgL), cfg)
    fR = jorb.extract_orb(jnp.asarray(imgR), cfg)
    feats = [np.asarray(a) for f in (fL, fR)
             for a in (f.uv, f.level, f.desc, f.valid)]
    return feats, imgL, imgR


def test_match_stereo_matches_reference(stereo_pair):
    """The same features and images through both matchers: ok agrees on
    >= 99.5 % of keypoints (measured: all of them); where both accept, u_r
    within 1e-3 px and depth within 1e-4 relative (measured 3e-5 px and
    6e-6).  The 121-term SAD sums run in another order than XLA's, which can
    move a sum's last bits."""
    feats, imgL, imgR = stereo_pair
    ju, jd, jok = [np.asarray(a) for a in jstereo.match_stereo(
        *[_J(a) for a in feats], _J(imgL), _J(imgR), FX, BASELINE)]
    tu, td, tok = [a.numpy() for a in tstereo.match_stereo(
        *[_T(a) for a in feats], _T(imgL), _T(imgR), FX, BASELINE)]
    assert jok.sum() > 250
    assert (jok == tok).mean() >= 0.995
    both = jok & tok
    assert np.abs(tu[both] - ju[both]).max() < 1e-3
    assert (np.abs(td[both] - jd[both]) / jd[both]).max() < 1e-4
    assert (tu[~tok] == -1).all() and (td[~tok] == -1).all()


def test_nanmedian_midpoint_even_count():
    """The tail cull's median: with an even accepted count the reference's
    jnp.nanmedian averages the two middle values, where torch.nanmedian
    returns the lower one; the port follows the reference."""
    x = np.array([9.0, 1.0, 4.0, 100.0, 2.0, 7.0, 3.0], np.float32)
    ok = np.array([1, 1, 1, 0, 1, 0, 1], bool)    # accepted: 9 1 4 2 3 -> odd
    ok_even = ok.copy()
    ok_even[2] = False                              # accepted: 9 1 2 3 -> even
    for mask in (ok, ok_even, np.zeros_like(ok)):
        ref = float(np.nan_to_num(jnp.nanmedian(jnp.where(_J(mask), _J(x),
                                                          jnp.nan)),
                                  nan=np.inf))
        got = float(tstereo.nanmedian_midpoint(_T(x), _T(mask)))
        assert got == ref, (mask, got, ref)
    even = float(tstereo.nanmedian_midpoint(_T(x), _T(ok_even)))
    lower = float(torch.nanmedian(torch.where(_T(ok_even), _T(x),
                                              torch.tensor(float("nan")))))
    assert even == 2.5 and lower == 2.0


def test_depth_to_virtual_right_exact():
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 752, 500).astype(np.float32)
    depth = rng.uniform(0.3, 12, 500).astype(np.float32)
    depth[::7] = -1.0
    depth[::11] = 0.0
    ju, jok = jstereo.depth_to_virtual_right(_J(u), _J(depth), FX, BASELINE)
    tu, tok = tstereo.depth_to_virtual_right(_T(u), _T(depth), FX, BASELINE)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_stereo_rectify_matches_reference():
    """``test_rectified_rows_align``'s rotated, distorted EuRoC-like rig:
    integer sampling positions exact, fractions within 1e-5, remapped
    images within 1e-3 gray levels, rig geometry equal."""
    W, H = 752, 480
    params_l = np.array([458.0, 457.0, 372.0, 244.0, -0.28, 0.07, 1e-4, 2e-5, 0.0])
    params_r = np.array([456.0, 455.5, 379.0, 255.0, -0.28, 0.07, -1e-4, 1e-5, 0.0])
    R_rl = np.asarray(jlie.exp_so3(jnp.asarray([0.004, -0.01, 0.006],
                                               jnp.float32)), np.float64)
    t_rl = np.array([-0.110, 0.0004, -0.0008])
    a = jrectify.stereo_rectify(params_l, params_r, R_rl, t_rl, W, H)
    b = trectify.stereo_rectify(params_l, params_r, R_rl, t_rl, W, H)
    for name in ("K_new", "R_rect_l", "R_rect_r"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert b.baseline == a.baseline and b.bf == a.bf
    img = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
    for side in ("left", "right"):
        ma, mb = getattr(a, side), getattr(b, side)
        np.testing.assert_array_equal(mb.x0, ma.x0)
        np.testing.assert_array_equal(mb.y0, ma.y0)
        np.testing.assert_allclose(mb.wx, ma.wx, atol=1e-5)
        np.testing.assert_allclose(mb.wy, ma.wy, atol=1e-5)
        remap_a = getattr(a, f"remap_{side}")(img)
        remap_b = getattr(b, f"remap_{side}")(img)
        np.testing.assert_allclose(remap_b, remap_a, atol=1e-3)
    # Identity rig: the remap reproduces the source (test_remap_identity_rig).
    p = np.array([100.0, 100.0, 32.0, 24.0, 0, 0, 0, 0, 0])
    rig = trectify.stereo_rectify(p, p, np.eye(3), np.array([-0.1, 0.0, 0.0]),
                                  64, 48)
    src = img[:48, :64]
    np.testing.assert_allclose(rig.remap_left(src)[1:-1, 1:-1], src[1:-1, 1:-1],
                               atol=1e-3)
