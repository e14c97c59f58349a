"""The port's inertial solvers against the JAX reference.

The four solvers of ``solvers/inertial.py`` run on ``tests/test_inertial.py``'s
simulated keyframe chains, and ``inertial_bundle_adjust`` on
``tests/test_inertial_ba.py``'s analytic-trajectory problem, in both
packages from the same numpy inputs (the port on the CPU).  Each test
states its tolerance: the solves are float32 Gauss-Newton / LM loops whose
accept/reject decisions are the same in both packages, so the results
agree to the float32 rounding of the reduction orders, amplified by the
conditioning of each problem.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.solvers import inertial as jinertial
from orb_slam3_study_kr_tpu.solvers.inertial_ba import (
    inertial_bundle_adjust as j_vi_ba)
from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.imu import Preintegrated
from orb_slam3_study_kr_tpu_torch.solvers import inertial
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
    inertial_bundle_adjust)
from test_inertial import _simulate_trajectory
from test_inertial_ba import _perturb, _problem

torch.set_num_threads(2)

CAM = [458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0]
J_PROJECT = functools.partial(jpinhole.project, jnp.asarray(CAM, jnp.float32))
J_PROJECT_JAC = functools.partial(jpinhole.project_jac,
                                  jnp.asarray(CAM, jnp.float32))
PROJECT = functools.partial(pinhole.project, torch.tensor(CAM))
PROJECT_JAC = functools.partial(pinhole.project_jac, torch.tensor(CAM))


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def pre_from_jax(p):
    """A reference Preintegrated (possibly stacked) as the port's."""
    return Preintegrated(**{k: torch.as_tensor(np.asarray(getattr(p, k)))
                            for k in Preintegrated.__dataclass_fields__})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("fix_scale", [False, True], ids=["mono", "fixed"])
def test_inertial_only_optimization_matches_reference(fix_scale):
    """IMU init on the reference test's chain (bias known, true scale 2.7,
    or fixed scale on metric positions): scale within 1e-4 relative,
    gravity rotation and bias within 1e-4, velocities within 1e-3 m/s,
    edge norms within 1e-3 relative."""
    rng = np.random.default_rng(0)
    bias = np.asarray([0.004, -0.006, 0.003, 0.06, -0.04, 0.05], np.float32)
    R_kf, p_kf, _, pre_stack, _, _ = _simulate_trajectory(rng, bias=bias)
    p_vis = p_kf if fix_scale else p_kf / 2.7
    kw = dict(prior_gyro=1e2, prior_acc=1e5, fix_scale=fix_scale)
    ref = jinertial.inertial_only_optimization(
        jnp.asarray(R_kf, jnp.float32), jnp.asarray(p_vis, jnp.float32),
        pre_stack, **kw)
    out = inertial.inertial_only_optimization(
        T(R_kf), T(p_vis), pre_from_jax(pre_stack), **kw)
    assert _rel(out["scale"], ref["scale"]) < 1e-4
    np.testing.assert_allclose(out["R_wg"].numpy(), np.asarray(ref["R_wg"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["bias"].numpy(), np.asarray(ref["bias"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["v"].numpy(), np.asarray(ref["v"]),
                               atol=1e-3)
    assert _rel(out["edge_norms"], ref["edge_norms"]) < 1e-3


def test_estimate_gyro_bias_matches_reference():
    """The robust gyro-bias solve with a 2-degree glitched keyframe: bias
    within 1e-6, edge weights within 1e-4."""
    rng = np.random.default_rng(1)
    bias = np.array([0.004, -0.002, 0.003, 0.0, 0.0, 0.0], np.float32)
    R_kf, _, _, pre_stack, _, _ = _simulate_trajectory(rng, n_kf=12, bias=bias)
    R_kf = np.array(R_kf, np.float32)
    glitch = np.asarray(jlie.exp_so3(jnp.asarray([0.0, np.radians(2.0), 0.0],
                                                 jnp.float32)))
    R_kf[5] = R_kf[5] @ glitch
    bg_r, w_r = jinertial.estimate_gyro_bias(
        jnp.asarray(R_kf[:-1]), jnp.asarray(R_kf[1:]), pre_stack)
    bg, w = inertial.estimate_gyro_bias(T(R_kf[:-1]), T(R_kf[1:]),
                                        pre_from_jax(pre_stack))
    np.testing.assert_allclose(bg.numpy(), np.asarray(bg_r), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-4)
    assert w[4] < 0.5 and w[5] < 0.5


def _pose_problem(seed):
    rng = np.random.default_rng(seed)
    R_kf, p_kf, v_kf, pre_stack, _, _ = _simulate_trajectory(
        rng, n_kf=2, g_tilt=(0.0, 0.0))
    pre = jax.tree_util.tree_map(lambda a: a[0], pre_stack)
    N = 200
    R1, p1, v1 = R_kf[1], p_kf[1], v_kf[1]
    pc = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                   rng.uniform(4, 10, N)], -1).astype(np.float32)
    X = (pc @ R1.T + p1).astype(np.float32)
    uv = np.asarray(J_PROJECT(jnp.asarray(pc)))
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    uv[:10] += 25.0                                        # outliers
    dR = np.asarray(jlie.exp_so3(jnp.asarray([0.01, -0.02, 0.01], jnp.float32)))
    init = ((R1 @ dR).astype(np.float32),
            (p1 + np.asarray([0.05, -0.04, 0.06])).astype(np.float32),
            (v1 + np.asarray([0.2, -0.1, 0.1])).astype(np.float32))
    anchor = (R_kf[0].astype(np.float32), p_kf[0].astype(np.float32),
              v_kf[0].astype(np.float32), np.zeros(6, np.float32))
    level = rng.integers(0, 3, N).astype(np.int32)
    return pre, anchor, init, X, uv, level


def _check_pose(out, ref, info_rtol):
    R, p, v, b, inl, info = out
    Rr, pr, vr, br, inlr, infor = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(R.numpy(), Rr, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), pr, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), vr, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), br, atol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), inlr)
    assert _rel(info, infor) < info_rtol


def test_pose_inertial_optimization_matches_reference():
    """The fixed-anchor frame solve with 10 gross outliers and mixed
    pyramid levels: rotation and position within 1e-5, velocity within
    1e-4, bias within 1e-5, identical inliers, info within 1e-3 relative."""
    pre, anchor, init, X, uv, level = _pose_problem(2)
    ones = np.ones(X.shape[0], np.float32)
    common = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
              level, ones)
    ref = jinertial.pose_inertial_optimization(
        J_PROJECT, *map(jnp.asarray, anchor), pre, *map(jnp.asarray, init),
        *map(jnp.asarray, common), n_iters=10)
    out = inertial.pose_inertial_optimization(
        PROJECT, *map(T, anchor), pre_from_jax(pre), *map(T, init),
        *map(T, common[:4]), T(level, torch.int32), T(ones), n_iters=10)
    _check_pose(out, ref, 1e-3)
    assert int(out[4].sum()) >= 180


def test_pose_inertial_last_frame_matches_reference():
    """The joint 30-dof solve under a 15-D prior (the previous solve's
    info, as the tracker carries it): the current state as above and the
    Schur-complemented info within 1e-3 relative."""
    pre, anchor, init, X, uv, level = _pose_problem(3)
    ones = np.ones(X.shape[0], np.float32)
    common = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
              level, ones)
    prior = np.asarray(jinertial.pose_inertial_optimization(
        J_PROJECT, *map(jnp.asarray, anchor), pre, *map(jnp.asarray, init),
        *map(jnp.asarray, common))[5], np.float32)
    ref = jinertial.pose_inertial_optimization_last_frame(
        J_PROJECT, *map(jnp.asarray, anchor), jnp.asarray(prior), pre,
        *map(jnp.asarray, init), *map(jnp.asarray, common), n_iters=10)
    out = inertial.pose_inertial_optimization_last_frame(
        PROJECT, *map(T, anchor), T(prior), pre_from_jax(pre), *map(T, init),
        *map(T, common[:4]), T(level, torch.int32), T(ones), n_iters=10)
    _check_pose(out, ref, 1e-3)


def test_singular_prior_gives_nonfinite_info_in_both():
    """A prior that is not positive definite: the reference's Cholesky
    gives NaN (no exception) and so must the port's, so that the tracker
    drops the carried prior; neither solve moves the state."""
    pre, anchor, init, X, uv, level = _pose_problem(4)
    ones = np.ones(X.shape[0], np.float32)
    common = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
              level, ones)
    bad = -np.eye(15, dtype=np.float32)
    ref = jinertial.pose_inertial_optimization_last_frame(
        J_PROJECT, *map(jnp.asarray, anchor), jnp.asarray(bad), pre,
        *map(jnp.asarray, init), *map(jnp.asarray, common), n_iters=3)
    out = inertial.pose_inertial_optimization_last_frame(
        PROJECT, *map(T, anchor), T(bad), pre_from_jax(pre), *map(T, init),
        *map(T, common[:4]), T(level, torch.int32), T(ones), n_iters=3)
    assert not np.isfinite(np.asarray(ref[5])).all()
    assert not torch.isfinite(out[5]).all()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(out[0].numpy(), init[0], atol=1e-6)


def _ba_args(prob, R0, p0, v0, bias0, X0, fixed):
    K = prob["K"]
    O = prob["obs_pose"].shape[0]
    return [R0, p0, v0, bias0, fixed, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), X0, np.ones(X0.shape[0], np.float32),
            prob["obs_pose"], prob["obs_lm"], prob["obs_uv"],
            np.zeros(O, np.int32), np.ones(O, np.float32),
            prob["edge_i"], prob["edge_j"], prob["pre_stack"],
            np.ones(K - 1, np.float32)]


def _run_ba(args, **kw):
    ref = j_vi_ba(J_PROJECT, J_PROJECT_JAC,
                  *[a if i == 16 else jnp.asarray(a) for i, a in enumerate(args)],
                  **kw)
    targs = [pre_from_jax(a) if i == 16 else
             T(a, torch.int64 if np.asarray(a).dtype.kind == "i" else torch.float32)
             for i, a in enumerate(args)]
    out = inertial_bundle_adjust(PROJECT, PROJECT_JAC, *targs, **kw)
    return out, ref


def _check_ba(out, ref, tol):
    names = ("R", "p", "v", "bias", "X", "chi2", "cost")
    for name, a, b in zip(names, out, ref):
        b = np.asarray(b)
        a = a.numpy()
        if name == "chi2":
            np.testing.assert_allclose(a, b, rtol=tol["chi2"], atol=tol["chi2"])
        elif name == "cost":
            assert _rel(a, b) < tol["cost"], (a, b)
        else:
            np.testing.assert_allclose(a, b, atol=tol[name], err_msg=name)


BA_TOL = dict(R=1e-4, p=1e-4, v=1e-3, bias=1e-4, X=1e-3, chi2=1e-2, cost=1e-3)


def test_inertial_ba_shared_bias_matches_reference():
    """FullInertialBA's init mode (shared bias, priors 1e2/1e10) from
    perturbed states and zero bias: every output within BA_TOL."""
    rng = np.random.default_rng(3)
    prob = _problem(rng)
    K = prob["K"]
    R0, p0, v0, X0 = _perturb(rng, prob)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    args = _ba_args(prob, R0, p0, v0, np.zeros((K, 6), np.float32), X0, fixed)
    out, ref = _run_ba(args, n_iters=15, shared_bias=True, bias_src=K - 1,
                       prior_gyro=1e2, prior_acc=1e10)
    _check_ba(out, ref, BA_TOL)


def test_inertial_ba_per_kf_bias_matches_reference():
    """Per-keyframe biases with random-walk edges, anchor bias at truth."""
    rng = np.random.default_rng(4)
    b_anchor = np.array([0.004, -0.002, 0.003, 0.03, -0.05, 0.02], np.float32)
    prob = _problem(rng, bias_est=b_anchor)
    K = prob["K"]
    R0, p0, v0, X0 = _perturb(rng, prob)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    bias0 = (np.tile(b_anchor, (K, 1))
             + rng.normal(0, 2e-4, (K, 6))).astype(np.float32)
    bias0[0] = b_anchor
    args = _ba_args(prob, R0, p0, v0, bias0, X0, fixed)
    out, ref = _run_ba(args, n_iters=12, shared_bias=False)
    _check_ba(out, ref, BA_TOL)


def test_inertial_ba_fixed_anchor_window_matches_reference():
    """LocalInertialBA's shape: the last 5 states free, the others fixed
    (bit-identical in both: fixed rows never move), a free anchor
    velocity/bias on the first fixed state (fixed_vb), and the stereo row
    on half of the observations."""
    rng = np.random.default_rng(5)
    b_true = np.array([0.004, -0.002, 0.003, 0.03, -0.05, 0.02], np.float32)
    prob = _problem(rng, bias_est=b_true)
    K = prob["K"]
    W = 5
    fixed = np.ones(K, np.float32)
    fixed[-W:] = 0.0
    fixed_vb = fixed.copy()
    fixed_vb[K - W - 1] = 0.0
    R0, p0, v0, X0 = _perturb(rng, prob, keep_first=K - W, lm=0.01)
    args = _ba_args(prob, R0, p0, v0, np.tile(b_true, (K, 1)), X0, fixed)
    O = prob["obs_pose"].shape[0]
    ur = (prob["obs_uv"][:, 0] - 458.0 * 0.11 / 6.0).astype(np.float32)
    ur[::2] = -1.0
    out, ref = _run_ba(args, n_iters=10, shared_bias=False)
    _check_ba(out, ref, BA_TOL)
    np.testing.assert_array_equal(out[1].numpy()[: K - W], p0[: K - W])
    ref2 = j_vi_ba(J_PROJECT, J_PROJECT_JAC,
                   *[a if i == 16 else jnp.asarray(a) for i, a in enumerate(args)],
                   n_iters=10, shared_bias=False,
                   fixed_vb=jnp.asarray(fixed_vb), obs_ur=jnp.asarray(ur),
                   bf=jnp.float32(458.0 * 0.11))
    out2 = inertial_bundle_adjust(
        PROJECT, PROJECT_JAC,
        *[pre_from_jax(a) if i == 16 else
          T(a, torch.int64 if np.asarray(a).dtype.kind == "i" else torch.float32)
          for i, a in enumerate(args)],
        n_iters=10, shared_bias=False, fixed_vb=T(fixed_vb), obs_ur=T(ur),
        bf=458.0 * 0.11)
    assert O == out2[5].shape[0]
    _check_ba(out2, ref2, BA_TOL)
