"""The port's fisheye (Kannala-Brandt KB8) modules against the JAX
reference: the lens model and the camera dispatch, the KB8 tracker
config and its bootstrap helpers, the theta gate of the projection
matching, the solvers with the wide-FOV cheirality (|p| > 1e-3) on a
problem with observations past 90 degrees off-axis, the non-rectified
stereo matcher and the KB8 renderer.  Each test states its tolerance; the
inputs are made from seeds with numpy and fed to both packages (the port
on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import cameras as jcameras
from orb_slam3_study_kr_tpu.cameras import kb8 as jkb8
from orb_slam3_study_kr_tpu.io import synthetic as jsynthetic
from orb_slam3_study_kr_tpu.lie import se3 as jse3
from orb_slam3_study_kr_tpu.ops import track_match as jtrack_match
from orb_slam3_study_kr_tpu.ops.fisheye_stereo import (
    match_stereo_fisheye as j_match_stereo_fisheye)
from orb_slam3_study_kr_tpu.pipeline import tracking as jtracking
from orb_slam3_study_kr_tpu.solvers import bundle_adjust as j_bundle_adjust
from orb_slam3_study_kr_tpu.solvers import inertial as jinertial
from orb_slam3_study_kr_tpu.solvers import optimize_pose as j_optimize_pose
from orb_slam3_study_kr_tpu.solvers.inertial_ba import (
    inertial_bundle_adjust as j_vi_ba)
from orb_slam3_study_kr_tpu.solvers.pnp import ransac_pnp as j_ransac_pnp
from orb_slam3_study_kr_tpu_torch import cameras
from orb_slam3_study_kr_tpu_torch.cameras import kb8
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.ops import track_match
from orb_slam3_study_kr_tpu_torch.pipeline import tracking
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, optimize_pose
from orb_slam3_study_kr_tpu_torch.solvers import inertial
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
    inertial_bundle_adjust)
from orb_slam3_study_kr_tpu_torch.solvers.pnp import ransac_pnp
from test_inertial import _simulate_trajectory
from test_inertial_ba import _perturb, _problem
from test_torch_fisheye_cuda import (KB8, KB8_PARAMS, kb8_kw,
                                     run_fisheye_matcher, stereo_rig_problem,
                                     wide_angle_points)
from test_torch_inertial import pre_from_jax

torch.set_num_threads(2)

J_P = jnp.asarray(KB8_PARAMS)
T_P = torch.as_tensor(KB8_PARAMS)
J_PROJECT = functools.partial(jkb8.project, J_P)
J_PROJECT_JAC = functools.partial(jkb8.project_jac, J_P)
PROJECT = functools.partial(kb8.project, T_P)
PROJECT_JAC = functools.partial(kb8.project_jac, T_P)
# tests/test_cameras.py's TUM-VI calibration (its KB8 cases' lens).
TUMVI_KB8 = dict(fx=190.97847715128717, fy=190.9733070521226,
                 cx=254.93170605935475, cy=256.8974428996504,
                 k1=0.0034823894022493434, k2=0.0007150348452162257,
                 k3=-0.0020532361418706202, k4=0.00020293673591811182)


def _T(a):
    a = np.asarray(a)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind == "i"
                           else torch.float32 if a.dtype.kind == "f" else None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _test_cameras_points():
    """tests/test_cameras.py's KB8 cases: up to 80 degrees at 1-10 m, 32
    rays at 91-100 degrees at 3 m and frustum points for the Jacobian."""
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 1.4, 256)
    phi = rng.uniform(0, 2 * np.pi, 256)
    d = rng.uniform(1, 10, 256)
    pts = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                    np.cos(theta)], -1) * d[:, None]
    theta_w = np.radians(rng.uniform(91.0, 100.0, 32))
    phi_w = rng.uniform(0, 2 * np.pi, 32)
    wide = np.stack([np.sin(theta_w) * np.cos(phi_w),
                     np.sin(theta_w) * np.sin(phi_w), np.cos(theta_w)], -1) * 3.0
    front = np.stack([rng.uniform(-0.8, 0.8, 8), rng.uniform(-0.8, 0.8, 8),
                      np.ones(8)], -1) * rng.uniform(2, 10, 8)[:, None]
    return np.concatenate([pts, wide, front]).astype(np.float32)


@pytest.mark.parametrize("points", ["wide", "test_cameras"])
def test_kb8_model_matches_reference(points):
    """project within 1e-4 px, unproject within 1e-5 and project_jac (the
    port's closed form against the reference's jacfwd) within 1e-4 of the
    Jacobian's scale, from 0 to 100 degrees off-axis, the optical axis and
    the 1e-16 floor of x^2 + y^2 included."""
    X = (wide_angle_points(1, 600) if points == "wide"
         else _test_cameras_points())
    uv_j = np.asarray(jkb8.project(J_P, jnp.asarray(X)))
    uv_t = kb8.project(T_P, torch.as_tensor(X)).numpy()
    assert np.abs(uv_t - uv_j).max() < 1e-4
    b_j = np.asarray(jkb8.unproject(J_P, jnp.asarray(uv_j)))
    b_t = kb8.unproject(T_P, torch.as_tensor(uv_j)).numpy()
    assert np.abs(b_t - b_j).max() < 1e-5
    J_j = np.asarray(jkb8.project_jac(J_P, jnp.asarray(X)))
    J_t = kb8.project_jac(T_P, torch.as_tensor(X)).numpy()
    scale = np.abs(J_j).max(axis=(-1, -2), keepdims=True)
    assert (np.abs(J_t - J_j) / scale).max() < 1e-4


def test_camera_dispatch_matches_reference():
    """make_pinhole / make_kb8 and the project / unproject / project_jac
    dispatch: the same params, K and results within the bars above; the
    port's camera lives on the device it names."""
    X = _test_cameras_points()
    pairs = [(jcameras.make_kb8(**TUMVI_KB8),
              cameras.make_kb8(**TUMVI_KB8, device="cpu")),
             (jcameras.make_pinhole(400.0, 400.0, 376.0, 240.0, k1=-0.1),
              cameras.make_pinhole(400.0, 400.0, 376.0, 240.0, k1=-0.1,
                                   device="cpu"))]
    for jc, tc in pairs:
        assert tc.kind.value == jc.kind.value
        assert (tc.width, tc.height) == (jc.width, jc.height)
        assert tc.params.device.type == "cpu"
        np.testing.assert_array_equal(tc.params.numpy(), np.asarray(jc.params))
        np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
        pts = X if tc.kind == cameras.CameraKind.KB8 else X[X[:, 2] > 0.5]
        uv_j = np.asarray(jcameras.project(jc, jnp.asarray(pts)))
        uv_t = cameras.project(tc, torch.as_tensor(pts)).numpy()
        assert np.abs(uv_t - uv_j).max() < 1e-4 * max(1.0, np.abs(uv_j).max())
        r_j = np.asarray(jcameras.unproject(jc, jnp.asarray(uv_j)))
        r_t = cameras.unproject(tc, torch.as_tensor(uv_j)).numpy()
        assert np.abs(r_t - r_j).max() < 1e-5 * max(1.0, np.abs(r_j).max())
        J_j = np.asarray(jcameras.project_jac(jc, jnp.asarray(pts)))
        J_t = cameras.project_jac(tc, torch.as_tensor(pts)).numpy()
        assert _rel(J_t, J_j) < 1e-4


def test_kb8_tracker_config_matches_reference():
    """ideal_params (the virtual pinhole of the bootstrap), K (built from
    it, not from fx, fy, cx, cy), focal, max_theta_deg and the identity
    undistortion exactly as the reference's; the lens functions are KB8 on
    cam_params."""
    for kw in (kb8_kw(), kb8_kw(fov_max_deg=60.0, fisheye_half_fov_deg=95.0)):
        jc = jtracking.TrackerConfig(**kw)
        tc = tracking.TrackerConfig(**kw, device="cpu")
        tc.check_supported()
        for name in ("cam_params", "ideal_params", "K"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)), name)
        assert tc.focal == jc.focal and tc.max_theta_deg == jc.max_theta_deg
        assert tc.is_kb8
        uv = torch.tensor([[256.0, 256.0], [40.0, 470.0], [2.0, 2.0]])
        assert tc.undistort_px_fn(uv) is uv
        X = torch.as_tensor(wide_angle_points(2, 16))
        np.testing.assert_array_equal(tc.project_fn(X).numpy(),
                                      kb8.project(tc.cam_params, X).numpy())
        np.testing.assert_array_equal(
            tc.unproject_fn(uv).numpy(), kb8.unproject(tc.cam_params, uv).numpy())
    pin = tracking.TrackerConfig(device="cpu")
    assert pin.max_theta_deg is None and not pin.is_kb8
    np.testing.assert_array_equal(
        pin.K.numpy(), np.asarray(jtracking.TrackerConfig().K))


def test_kb8_bootstrap_helpers_match_reference():
    """_ray_roundtrip_ok and _kb8_central_virtual on a grid over the whole
    512x512 sensor (corners past the lens model included): masks exact,
    virtual-pinhole coordinates within 1e-3 px where inside the cone."""
    jc = jtracking.TrackerConfig(**kb8_kw())
    tc = tracking.TrackerConfig(**kb8_kw(), device="cpu")
    g = np.linspace(0.0, 511.0, 40, dtype=np.float32)
    uv = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    uv = np.concatenate([uv, [[256.0, 256.0], [300.0, 220.0], [2.0, 2.0]]]
                        ).astype(np.float32)
    rt_j = np.asarray(jtracking._ray_roundtrip_ok(jc.cam_params,
                                                  jnp.asarray(uv)))
    rt_t = tracking._ray_roundtrip_ok(tc.cam_params, torch.as_tensor(uv)).numpy()
    np.testing.assert_array_equal(rt_t, rt_j)
    und_j, ok_j = jtracking._kb8_central_virtual(
        jc.cam_params, jc.ideal_params, jnp.asarray(uv),
        jnp.float32(jc.fov_max_deg))
    und_t, ok_t = tracking._kb8_central_virtual(
        tc.cam_params, tc.ideal_params, torch.as_tensor(uv), tc.fov_max_deg)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert 0 < ok_j.sum() < ok_j.size
    assert np.abs(und_t.numpy()[ok_j] - np.asarray(und_j)[ok_j]).max() < 1e-3


def _landmark_block(seed, L=256):
    """tests/test_fisheye_pipeline.py's three landmarks (on the axis, 95
    degrees off-axis toward the corner, straight behind) and a random set
    over the whole sphere; normals toward the camera, bands wide open."""
    th = np.radians(95.0)
    fixed = np.array([
        [0.0, 0.0, 3.0],
        [3.0 * np.sin(th) * np.cos(np.pi / 4),
         3.0 * np.sin(th) * np.sin(np.pi / 4), 3.0 * np.cos(th)],
        [0.0, 0.0, -3.0]], np.float32)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(L - 3, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lm = np.concatenate([fixed, d * rng.uniform(1.0, 8.0, (L - 3, 1))]
                        ).astype(np.float32)
    normal = lm / np.linalg.norm(lm, axis=-1, keepdims=True)
    return (lm, normal.astype(np.float32),
            rng.uniform(0.1, 2.0, L).astype(np.float32),
            rng.uniform(4.0, 100.0, L).astype(np.float32),
            (rng.random(L) < 0.95).astype(np.float32))


def test_project_landmarks_theta_gate_matches_reference():
    """project_landmarks with max_theta_deg (the lens's 98 degrees):
    visible and the predicted level exact, uv within 1e-4 px; the 95-degree
    landmark is visible and the one behind is not."""
    tc = tracking.TrackerConfig(**kb8_kw(), device="cpu")
    jc = jtracking.TrackerConfig(**kb8_kw())
    lm, normal, min_d, max_d, mask = _landmark_block(4)
    R = np.asarray(jse3.exp_se3(jnp.asarray(
        [0.05, -0.03, 0.02, 0.1, -0.05, 0.2], jnp.float32))[0])
    t = np.array([0.1, -0.05, 0.2], np.float32)
    for Rc, tcw in ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
                    (R, t)):
        args = (Rc, tcw, lm, normal, min_d, max_d, mask)
        uv_j, vis_j, pred_j, _ = jtrack_match.project_landmarks(
            jc.project_fn, *[jnp.asarray(a) for a in args], 512, 512,
            max_theta_deg=jc.max_theta_deg)
        uv_t, vis_t, pred_t, _ = track_match.project_landmarks(
            tc.project_fn, *[torch.as_tensor(a) for a in args], 512, 512,
            max_theta_deg=tc.max_theta_deg)
        np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
        np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
        vis = np.asarray(vis_j)
        assert np.abs(uv_t.numpy()[vis] - np.asarray(uv_j)[vis]).max() < 1e-4
        assert 10 < vis.sum() < lm.shape[0]
    assert vis_t.shape[0] == lm.shape[0]
    _, vis0, _, _ = track_match.project_landmarks(
        tc.project_fn, torch.eye(3), torch.zeros(3),
        *[torch.as_tensor(a) for a in (lm, normal, min_d, max_d)],
        torch.ones(lm.shape[0]), 512, 512, max_theta_deg=tc.max_theta_deg)
    assert vis0[0] and vis0[1] and not vis0[2]


def _wide_ba_problem(seed=3, n_poses=4):
    """tests/test_parallel.py's KB8 map: 64 frontal points and 64 points
    95-110 degrees off-axis (z < 0) seen from 4 poses with 0.1 px noise;
    poses 1-3 and every landmark perturbed, pose 0 fixed."""
    rng = np.random.default_rng(seed)
    theta = np.concatenate([rng.uniform(0.2, 1.0, 64),
                            rng.uniform(np.radians(95), np.radians(110), 64)])
    phi = rng.uniform(0, 2 * np.pi, 128)
    rad = rng.uniform(4, 8, 128)
    X = np.stack([rad * np.sin(theta) * np.cos(phi),
                  rad * np.sin(theta) * np.sin(phi),
                  rad * np.cos(theta)], -1).astype(np.float32)
    Rs, ts = [], []
    for k in range(n_poses):
        xi = np.array([0.01 * k, -0.01 * k, 0.005 * k, 0.2 * k, 0.1 * k,
                       0.05 * k], np.float32)
        R, t = jse3.exp_se3(jnp.asarray(xi))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    op, ol, ouv = [], [], []
    for k in range(n_poses):
        uv = np.asarray(J_PROJECT(jnp.asarray(X @ R_gt[k].T + t_gt[k])))
        for j in range(128):
            op.append(k)
            ol.append(j)
            ouv.append(uv[j] + rng.normal(0, 0.1, 2))
    t0 = t_gt + rng.normal(0, 0.02, t_gt.shape).astype(np.float32)
    t0[0] = t_gt[0]
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    n = len(op)
    return dict(X=X, R=R_gt, t=t_gt, args=(
        R_gt.astype(np.float32), t0.astype(np.float32),
        np.array([1.0] + [0.0] * (n_poses - 1), np.float32),
        X0, np.ones(128, np.float32), np.array(op, np.int32),
        np.array(ol, np.int32), np.array(ouv, np.float32),
        rng.integers(0, 3, n).astype(np.int32), np.ones(n, np.float32)))


@pytest.mark.parametrize("assembly", ["dense", "pcg"])
def test_bundle_adjust_wide_fov_matches_reference(assembly):
    """bundle_adjust with wide_fov on the KB8 map: poses within 1e-3,
    points within 5e-3, final chi2 and cost within 1e-3 relative (the
    bars of test_torch_solvers.py); the observations of the points past 90
    degrees stay live and end under the 5.991 gate (with z > 0 they would
    carry no weight and keep their perturbation)."""
    prob = _wide_ba_problem()
    args = prob["args"]
    kw = dict(n_iters=10, assembly=assembly, wide_fov=True)
    Rj, tj, Xj, cj, costj = j_bundle_adjust(
        J_PROJECT, J_PROJECT_JAC, *[jnp.asarray(a) for a in args], **kw)
    Rt, tt, Xt, ct, costt = bundle_adjust(
        PROJECT, PROJECT_JAC, *[_T(a) for a in args], **kw)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5e-3)
    cj = np.asarray(cj)
    assert abs(ct.numpy().sum() - cj.sum()) <= 1e-3 * cj.sum()
    assert abs(float(costt) - float(costj)) <= 1e-3 * float(costj)
    wide = args[6] >= 64
    assert np.median(ct.numpy()[wide]) < 5.991


def _wide_pose_problem(seed, outliers=10):
    """Pose 2 of the KB8 map with its 128 observations, the first
    `outliers` moved 25 px, and a perturbed start."""
    prob = _wide_ba_problem(seed)
    X = prob["X"]
    uv = np.asarray(J_PROJECT(jnp.asarray(X @ prob["R"][2].T + prob["t"][2])))
    rng = np.random.default_rng(seed + 100)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:outliers] += 25.0
    level = rng.integers(0, 3, X.shape[0]).astype(np.int32)
    return prob, X, uv, level


def test_optimize_pose_wide_fov_matches_reference():
    """optimize_pose with wide_fov: R, t within 1e-4, identical inliers,
    the observations past 90 degrees among them."""
    prob, X, uv, level = _wide_pose_problem(5)
    mask = np.ones(X.shape[0], np.float32)
    R0 = np.asarray(jse3.exp_se3(jnp.asarray(
        [0.01, 0.0, -0.01, 0.0, 0.0, 0.0], jnp.float32))[0]) @ prob["R"][2]
    t0 = prob["t"][2] + np.array([0.03, -0.02, 0.02], np.float32)
    args = (R0.astype(np.float32), t0.astype(np.float32), X, uv, level, mask)
    Rj, tj, inj, nj = j_optimize_pose(J_PROJECT, J_PROJECT_JAC,
                                      *[jnp.asarray(a) for a in args],
                                      wide_fov=True)
    Rt, tt, int_, nt = optimize_pose(PROJECT, PROJECT_JAC,
                                     *[_T(a) for a in args], wide_fov=True)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 100 and int_.numpy()[64:].sum() > 50


def test_ransac_pnp_bearings_matches_reference():
    """ransac_pnp with the KB8 bearings and the reference's uniforms
    injected: the same success and inliers, R and t within 1e-4, the
    observations past 90 degrees among the inliers."""
    prob, X, uv, level = _wide_pose_problem(6, outliers=20)
    mask = np.ones(X.shape[0], np.float32)
    key = jax.random.PRNGKey(7)
    ref = j_ransac_pnp(key, J_PROJECT, J_PROJECT_JAC, jnp.eye(3),
                       jnp.asarray(X), jnp.asarray(uv), jnp.asarray(level),
                       jnp.asarray(mask),
                       bearings=jkb8.unproject(J_P, jnp.asarray(uv)))
    uniforms = np.asarray(jax.random.uniform(key, (256, X.shape[0])))
    out = ransac_pnp(PROJECT, PROJECT_JAC, torch.eye(3), _T(X), _T(uv),
                     _T(level), _T(mask), uniforms,
                     bearings=kb8.unproject(T_P, _T(uv)))
    assert bool(ref["success"]) and bool(out["success"])
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    np.testing.assert_allclose(out["R"].numpy(), np.asarray(ref["R"]), atol=1e-4)
    np.testing.assert_allclose(out["t"].numpy(), np.asarray(ref["t"]), atol=1e-4)
    assert out["inliers"].numpy()[64:].sum() > 50


def _wide_inertial_pose_problem(seed):
    """tests/test_torch_inertial.py's frame solve with a KB8 lens: 100
    frontal landmarks and 100 at 95-110 degrees off-axis (body == camera),
    10 gross outliers, mixed levels."""
    rng = np.random.default_rng(seed)
    R_kf, p_kf, v_kf, pre_stack, _, _ = _simulate_trajectory(
        rng, n_kf=2, g_tilt=(0.0, 0.0))
    pre = jax.tree_util.tree_map(lambda a: a[0], pre_stack)
    N = 200
    theta = np.concatenate([rng.uniform(0.1, 1.0, N // 2),
                            rng.uniform(np.radians(95), np.radians(110), N // 2)])
    phi = rng.uniform(0, 2 * np.pi, N)
    r = rng.uniform(4, 10, N)
    pc = np.stack([r * np.sin(theta) * np.cos(phi),
                   r * np.sin(theta) * np.sin(phi),
                   r * np.cos(theta)], -1).astype(np.float32)
    R1, p1, v1 = R_kf[1], p_kf[1], v_kf[1]
    X = (pc @ R1.T + p1).astype(np.float32)
    uv = np.asarray(J_PROJECT(jnp.asarray(pc)))
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    uv[:10] += 25.0
    dR = np.asarray(jse3.exp_se3(jnp.asarray(
        [0.01, -0.02, 0.01, 0, 0, 0], jnp.float32))[0])
    init = ((R1 @ dR).astype(np.float32),
            (p1 + np.asarray([0.05, -0.04, 0.06])).astype(np.float32),
            (v1 + np.asarray([0.2, -0.1, 0.1])).astype(np.float32))
    anchor = (R_kf[0].astype(np.float32), p_kf[0].astype(np.float32),
              v_kf[0].astype(np.float32), np.zeros(6, np.float32))
    level = rng.integers(0, 3, N).astype(np.int32)
    common = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
              level, np.ones(N, np.float32))
    return pre, anchor, init, common


@pytest.mark.parametrize("last_frame", [False, True],
                         ids=["anchored", "last_frame"])
def test_pose_inertial_wide_fov_matches_reference(last_frame):
    """pose_inertial_optimization and its last-frame form with wide_fov:
    rotation and position within 1e-5, velocity within 1e-4, bias within
    1e-5, identical inliers (the 100 observations past 90 degrees among
    them), info within 1e-3 relative (test_torch_inertial.py's bars)."""
    pre, anchor, init, common = _wide_inertial_pose_problem(2)
    jargs = [jnp.asarray(a) for a in common]
    targs = [_T(a) for a in common]
    if last_frame:
        prior = np.asarray(jinertial.pose_inertial_optimization(
            J_PROJECT, *map(jnp.asarray, anchor), pre,
            *map(jnp.asarray, init), *jargs, wide_fov=True)[5], np.float32)
        ref = jinertial.pose_inertial_optimization_last_frame(
            J_PROJECT, *map(jnp.asarray, anchor), jnp.asarray(prior), pre,
            *map(jnp.asarray, init), *jargs, n_iters=10, wide_fov=True)
        out = inertial.pose_inertial_optimization_last_frame(
            PROJECT, *map(_T, anchor), _T(prior), pre_from_jax(pre),
            *map(_T, init), *targs, n_iters=10, wide_fov=True)
    else:
        ref = jinertial.pose_inertial_optimization(
            J_PROJECT, *map(jnp.asarray, anchor), pre,
            *map(jnp.asarray, init), *jargs, n_iters=10, wide_fov=True)
        out = inertial.pose_inertial_optimization(
            PROJECT, *map(_T, anchor), pre_from_jax(pre), *map(_T, init),
            *targs, n_iters=10, wide_fov=True)
    R, p, v, b, inl, info = out
    Rr, pr, vr, br, inlr, infor = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(R.numpy(), Rr, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), pr, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), vr, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), br, atol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), inlr)
    assert _rel(info, infor) < 1e-3
    assert inl.numpy()[100:].sum() > 80


def test_inertial_ba_wide_fov_matches_reference():
    """inertial_bundle_adjust (per-keyframe biases) with wide_fov on
    tests/test_inertial_ba.py's chain, its landmarks replaced by 32 points
    in front of the first keyframe and 32 at 95-110 degrees off its axis,
    observed through the KB8 lens: every output within
    test_torch_inertial.py's BA_TOL."""
    from test_torch_inertial import BA_TOL, _ba_args, _check_ba
    rng = np.random.default_rng(4)
    prob = _problem(rng)
    traj, K = prob["traj"], prob["K"]
    R0c, t0c = traj["R_cw"][0], traj["t_cw"][0]
    theta = np.concatenate([rng.uniform(0.1, 0.9, 32),
                            rng.uniform(np.radians(95), np.radians(110), 32)])
    phi = rng.uniform(0, 2 * np.pi, 64)
    r = rng.uniform(4, 8, 64)
    pc0 = np.stack([r * np.sin(theta) * np.cos(phi),
                    r * np.sin(theta) * np.sin(phi), r * np.cos(theta)], -1)
    prob["X"] = ((pc0 - t0c) @ R0c).astype(np.float32)
    kf_idx = np.arange(0, 41, 4)
    uv = []
    for i in kf_idx:
        pc = prob["X"] @ traj["R_cw"][i].T + traj["t_cw"][i]
        uv.append(np.asarray(J_PROJECT(jnp.asarray(pc, jnp.float32)))
                  + rng.normal(0, 0.3, (64, 2)))
    prob["obs_uv"] = np.concatenate(uv).astype(np.float32)
    R0, p0, v0, X0 = _perturb(rng, prob)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    args = _ba_args(prob, R0, p0, v0, np.zeros((K, 6), np.float32), X0, fixed)
    kw = dict(n_iters=12, shared_bias=False, wide_fov=True)
    ref = j_vi_ba(J_PROJECT, J_PROJECT_JAC,
                  *[a if i == 16 else jnp.asarray(a) for i, a in enumerate(args)],
                  **kw)
    out = inertial_bundle_adjust(
        PROJECT, PROJECT_JAC,
        *[pre_from_jax(a) if i == 16 else _T(a) for i, a in enumerate(args)],
        **kw)
    _check_ba(out, ref, BA_TOL)


def test_fisheye_stereo_matcher_matches_reference():
    """match_stereo_fisheye on test_fisheye_stereo_matching's rig: idx_r
    and ok identical, X within 1e-4 m where accepted (a ray DLT through
    LAPACK's SVD against XLA's), depth within 1e-4 relative; >= 80 % of the
    visible points accepted, points past 90 degrees among them."""
    X, theta, prob = stereo_rig_problem()
    p = functools.partial(jkb8.project, J_P)
    side = [jnp.asarray(prob[k]) for k in ("level", "desc", "valid", "angle")]
    ref = j_match_stereo_fisheye(
        p, p, jnp.float32(KB8[0]), jnp.asarray(prob["R_rl"]),
        jnp.asarray(prob["t_rl"]), jnp.asarray(prob["uv_l"]),
        jkb8.unproject(J_P, jnp.asarray(prob["uv_l"])), *side,
        jnp.asarray(prob["uv_r"]),
        jkb8.unproject(J_P, jnp.asarray(prob["uv_r"])), *side)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = run_fisheye_matcher("cpu", prob)
    np.testing.assert_array_equal(out["idx_r"], ref["idx_r"])
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    ok = ref["ok"]
    assert np.abs(out["X"][ok] - ref["X"][ok]).max() < 1e-4
    assert _rel(out["depth"][ok], ref["depth"][ok]) < 1e-4
    assert ok.sum() >= 0.8 * prob["valid"].sum()
    assert (ok & (theta > np.radians(90.0))).any()


def test_kb8_render_matches_reference():
    """io/synthetic's KB8 world and render (the renderer's own Newton
    unprojection) equal the reference's: world textures identical, image
    within 1e-3 gray levels."""
    jw = jsynthetic.make_textured_world(np.random.default_rng(8), width=512,
                                        height=512, depth=6.0, kb8_params=KB8)
    tw = synthetic.make_textured_world(np.random.default_rng(8), width=512,
                                       height=512, depth=6.0, kb8_params=KB8)
    for a, b in zip(jw.planes, tw.planes):
        np.testing.assert_array_equal(a["tex"], b["tex"])
    R, t = jsynthetic.lateral_trajectory(5, x_span=1.0, z_span=0.0, y_amp=0.05)
    for i in (0, 4):
        a = jsynthetic.render_textured(jw, R[i], t[i],
                                       rng=np.random.default_rng(i))
        b = synthetic.render_textured(tw, R[i], t[i],
                                      rng=np.random.default_rng(i))
        assert a.shape == b.shape == (512, 512)
        assert np.abs(a - b).max() < 1e-3
