"""Loop-closing solvers of the torch port against the JAX reference: Sim3
Lie maps, Horn, RANSAC PnP and Sim3 (with the reference's jax.random
uniforms injected), OptimizeSim3, the essential-graph solve (7- and
4-DoF), the PCG bundle adjustment and global BA.  The problems are those
of tests/test_loop_solvers.py and tests/test_global_ba.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.pipeline import global_ba as jgba
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_study_kr_tpu.solvers import bundle_adjust as j_bundle_adjust
from orb_slam3_study_kr_tpu.solvers import pnp as jpnp
from orb_slam3_study_kr_tpu.solvers import pose_graph as jpg
from orb_slam3_study_kr_tpu.solvers import sim3_solver as jsim3
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.lie import sim3 as tsim3
from orb_slam3_study_kr_tpu_torch.pipeline import global_ba as tgba
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState as TMapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust as t_bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers import pnp as tpnp
from orb_slam3_study_kr_tpu_torch.solvers import pose_graph as tpg
from orb_slam3_study_kr_tpu_torch.solvers import sim3_solver as tsim3s

torch.set_num_threads(2)

K_MAT = np.array([[458.0, 0, 376.0], [0, 457.0, 240.0], [0, 0, 1.0]], np.float32)
PARAMS = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
J_PROJ = functools.partial(jpinhole.project, jnp.asarray(PARAMS))
J_JAC = functools.partial(jpinhole.project_jac, jnp.asarray(PARAMS))
T_PROJ = functools.partial(tpinhole.project, torch.as_tensor(PARAMS))
T_JAC = functools.partial(tpinhole.project_jac, torch.as_tensor(PARAMS))


def _T(a):
    return torch.as_tensor(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


def test_sim3_lie_matches_reference():
    """exp/log/inverse/compose/apply within 1e-5 over generic, small-angle
    and small-scale tangents."""
    rng = np.random.default_rng(0)
    z = rng.normal(0, 0.5, (64, 7)).astype(np.float32)
    z[:8, :3] *= 1e-5          # theta -> 0
    z[8:16, 6] *= 1e-7         # sigma -> 0
    jR, jt, js = jlie.exp_sim3(jnp.asarray(z))
    tR, tt, ts = tsim3.exp_sim3(_T(z))
    for a, b in ((tR, jR), (tt, jt), (ts, js)):
        _close(a, b, 1e-5)
    _close(tsim3.log_sim3(tR, tt, ts), jlie.log_sim3(jR, jt, js), 1e-5)
    for a, b in zip(tsim3.sim3_compose(tR, tt, ts, tR.flip(0), tt.flip(0),
                                       ts.flip(0)),
                    jlie.sim3_compose(jR, jt, js, jR[::-1], jt[::-1], js[::-1])):
        _close(a, b, 1e-5)
    for a, b in zip(tsim3.sim3_inverse(tR, tt, ts), jlie.sim3_inverse(jR, jt, js)):
        _close(a, b, 1e-5)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    _close(tsim3.sim3_apply(tR, tt, ts, _T(p)),
           jlie.sim3_apply(jR, jt, js, jnp.asarray(p)), 1e-5)


def test_horn_sim3_matches_reference(rng):
    P = rng.normal(size=(50, 3)).astype(np.float32)
    R, t, s = jlie.exp_sim3(jnp.asarray([0.2, -0.1, 0.3, 1.0, -2.0, 0.5, 0.4],
                                        jnp.float32))
    Q = np.asarray(jlie.sim3_apply(R, t, s, jnp.asarray(P)))
    w = (rng.random(50) > 0.3).astype(np.float32)
    for kw in (dict(), dict(fix_scale=True)):
        jo = jsim3.horn_sim3(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w), **kw)
        to = tsim3s.horn_sim3(_T(P), _T(Q), _T(w), **kw)
        for a, b in zip(to, jo):
            _close(a, b, 1e-5)


def test_ransac_pnp_matches_reference(rng):
    """tests/test_loop_solvers.py's PnP problem (30 % outliers), the
    reference's draws for PRNGKey(1) injected: identical inlier mask and
    count, pose within 1e-4."""
    n = 150
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 12, n)], -1).astype(np.float32)
    R_gt, t_gt = jlie.exp_se3(jnp.asarray([0.2, -0.3, 0.1, 0.4, 0.2, -0.3],
                                          jnp.float32))
    p = np.asarray(jlie.se3_apply(R_gt, t_gt, jnp.asarray(X)))
    uv = np.array(J_PROJ(jnp.asarray(p)))
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    n_out = int(0.3 * n)
    uv[:n_out] = rng.uniform(0, 700, (n_out, 2))
    level = rng.integers(0, 3, n).astype(np.int32)
    mask = (rng.random(n) > 0.05).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jo = jpnp.ransac_pnp(key, J_PROJ, J_JAC, jnp.asarray(K_MAT), jnp.asarray(X),
                         jnp.asarray(uv), jnp.asarray(level), jnp.asarray(mask))
    u = np.array(jax.random.uniform(key, (256, n)))
    to = tpnp.ransac_pnp(T_PROJ, T_JAC, _T(K_MAT), _T(X), _T(uv), _T(level),
                         _T(mask), uniforms=u)
    np.testing.assert_array_equal(to["inliers"].numpy(), np.asarray(jo["inliers"]))
    assert int(to["n_inliers"]) == int(jo["n_inliers"]) > n - n_out - 15
    assert bool(to["success"]) == bool(jo["success"])
    _close(to["R"], jo["R"], 1e-4)
    _close(to["t"], jo["t"], 1e-4)


def _sim3_problem(rng, n, z, n_out):
    P2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], -1).astype(np.float32)
    R12, t12, s12 = jlie.exp_sim3(jnp.asarray(z, jnp.float32))
    P1 = np.array(jlie.sim3_apply(R12, t12, s12, jnp.asarray(P2)))
    return P1, P2, (R12, t12, s12)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_sim3_matches_reference(rng, fix_scale):
    """tests/test_loop_solvers.py's Sim3 problem (25 % permuted outliers;
    unit scale for the fixed-scale solve), the reference's draws for
    PRNGKey(0) injected: identical inliers, (R, t, s) within 1e-4."""
    n = 120
    z = [0.1, -0.05, 0.15, 0.5, -0.3, 0.2, 0.0 if fix_scale else 0.3]
    P1, P2, _ = _sim3_problem(rng, n, z, 0)
    P1[: n // 4] = rng.permutation(P1[: n // 4])
    uv1 = np.asarray(J_PROJ(jnp.asarray(P1)))
    uv2 = np.asarray(J_PROJ(jnp.asarray(P2)))
    mask = np.ones(n, np.float32)
    mask[-10:] = 0.0
    key = jax.random.PRNGKey(0)
    jo = jsim3.ransac_sim3(key, jnp.asarray(P1), jnp.asarray(P2),
                           jnp.asarray(mask), jnp.asarray(uv1),
                           jnp.asarray(uv2), jnp.asarray(K_MAT),
                           fix_scale=fix_scale)
    u = np.array(jax.random.uniform(key, (128, n)))
    to = tsim3s.ransac_sim3(_T(P1), _T(P2), _T(mask), _T(uv1), _T(uv2),
                            _T(K_MAT), uniforms=u, fix_scale=fix_scale)
    np.testing.assert_array_equal(to["inliers"].numpy(),
                                  np.asarray(jo["inliers"]))
    assert int(to["n_inliers"]) == int(jo["n_inliers"]) >= n - n // 4 - 15
    for k in ("R12", "t12", "s12"):
        _close(to[k], jo[k], 1e-4)


def test_optimize_sim3_matches_reference(rng):
    """tests/test_loop_solvers.py's OptimizeSim3 problem (coarse start, 20 %
    outliers), free and fixed scale: (R, t, s) within 1e-4, identical
    inliers."""
    n = 150
    P1, P2, (R12, t12, s12) = _sim3_problem(
        rng, n, [0.08, -0.04, 0.12, 0.4, -0.25, 0.15, 0.25], 0)
    n_out = n // 5
    P1_obs = P1.copy()
    P1_obs[:n_out] = rng.permutation(P1_obs[:n_out]) + rng.normal(0, 1.0, (n_out, 3))
    uv1 = np.asarray(J_PROJ(jnp.asarray(P1)))
    uv2 = np.asarray(J_PROJ(jnp.asarray(P2)))
    dR, dt, ds = jlie.exp_sim3(jnp.asarray([0.02, -0.015, 0.01, 0.05, 0.03,
                                            -0.04, 0.05], jnp.float32))
    R0 = (np.asarray(R12) @ np.asarray(dR)).astype(np.float32)
    t0 = (np.asarray(t12) + np.asarray(dt)).astype(np.float32)
    s0 = np.float32(float(s12) * float(ds))
    for kw in (dict(n_iters=12), dict(fix_scale=True)):
        jo = jsim3.optimize_sim3(
            jnp.asarray(P1_obs), jnp.asarray(P2), jnp.ones(n), jnp.asarray(uv1),
            jnp.asarray(uv2), jnp.asarray(K_MAT), jnp.asarray(R0),
            jnp.asarray(t0), jnp.asarray(s0), **kw)
        to = tsim3s.optimize_sim3(
            _T(P1_obs), _T(P2), torch.ones(n), _T(uv1), _T(uv2), _T(K_MAT),
            _T(R0), _T(t0), _T(s0), **kw)
        for k in ("R12", "t12", "s12"):
            _close(to[k], jo[k], 1e-4)
        np.testing.assert_array_equal(to["inliers"].numpy(),
                                      np.asarray(jo["inliers"]))
    assert float(to["s12"]) == float(s0)


def _ring_pose_graph(rng, K, drift_per_step):
    """tests/test_loop_solvers.py's drifting ring (reference Lie maps)."""
    true = []
    for k in range(K):
        a = 2 * np.pi * k / K
        true.append(jlie.exp_sim3(jnp.asarray(
            [0, 0.5 * a, 0, np.cos(a), 0, np.sin(a), 0.0], jnp.float32)))
    R_t, t_t, s_t = (jnp.stack([x[i] for x in true]) for i in range(3))
    R_e, t_e, s_e = [np.asarray(R_t[0])], [np.asarray(t_t[0])], [1.0]
    for k in range(1, K):
        Rm, tm, sm = jpg.relative_sim3(R_t[k], t_t[k], s_t[k],
                                       R_t[k - 1], t_t[k - 1], s_t[k - 1])
        dz = jnp.asarray(np.concatenate([rng.normal(0, 0.004, 3),
                                         rng.normal(0, 0.01, 3),
                                         [drift_per_step]]), jnp.float32)
        Rm, tm, sm = jlie.sim3_compose(*jlie.exp_sim3(dz), Rm, tm, sm)
        Rk, tk, sk = jlie.sim3_compose(Rm, tm, sm, jnp.asarray(R_e[-1]),
                                       jnp.asarray(t_e[-1]),
                                       jnp.asarray(s_e[-1], jnp.float32))
        R_e.append(np.asarray(Rk)); t_e.append(np.asarray(tk)); s_e.append(float(sk))
    return (R_t, t_t, s_t), (np.stack(R_e), np.stack(t_e),
                             np.asarray(s_e, np.float32))


@pytest.mark.parametrize("dof", [7, 4])
def test_optimize_pose_graph_matches_reference(rng, dof):
    """Sequential edges from the drifted estimates plus one true loop edge;
    a zero-weight padding edge as the loop closer adds.  (R, t, s) within
    1e-4 of the reference after 25 iterations."""
    K = 12 if dof == 7 else 10
    (R_t, t_t, s_t), (R_0, t_0, s_0) = _ring_pose_graph(
        rng, K, 0.02 if dof == 7 else 0.0)
    if dof == 4:
        s_0 = np.ones(K, np.float32)
    ei = list(range(1, K)) + [K - 1, 0]
    ej = list(range(0, K - 1)) + [0, 0]
    w = np.ones(len(ei), np.float32)
    w[-1] = 0.0
    Rm, tm, sm = (np.array(a) for a in jpg.relative_sim3(
        R_0[ei], t_0[ei], s_0[ei], R_0[ej], t_0[ej], s_0[ej]))
    loop = jpg.relative_sim3(R_t[K - 1], t_t[K - 1], s_t[K - 1],
                             R_t[0], t_t[0], s_t[0])
    Rm[K - 1], tm[K - 1], sm[K - 1] = (np.asarray(a) for a in loop)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    args = (R_0, t_0, s_0, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            Rm, tm, sm, w, fixed)
    jo = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args), n_iters=25,
                                 dof=dof)
    to = tpg.optimize_pose_graph(*(_T(a) for a in args), n_iters=25, dof=dof)
    for a, b in zip(to, jo):
        _close(a, b, 1e-4)
    # The measured edges, batched, as the loop closer builds them.
    for a, b in zip(tpg.relative_sim3(*(_T(x) for x in (
            R_0[ei], t_0[ei], s_0[ei], R_0[ej], t_0[ej], s_0[ej]))),
            (Rm, tm, sm)):
        _close(a[: K - 1], b[: K - 1], 1e-6)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _noisy_map(map_cls):
    """tests/test_global_ba.py's noisy 8-keyframe map."""
    cfg = JTrackerConfig()
    rng = np.random.default_rng(7)
    n_kf, n_lm, max_kp = 8, 400, 512
    X_gt = rng.uniform([-3, -2, 5], [3, 2, 10], (n_lm, 3)).astype(np.float32)
    m = map_cls(max_kf=16, max_kp=max_kp, max_lm=4096)
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
        uv_full = np.zeros((max_kp, 2), np.float32)
        uv_full[:n_lm] = uv
        valid = np.zeros(max_kp, bool)
        valid[:n_lm] = True
        kp_lm = np.full(max_kp, -1, np.int32)
        kp_lm[:n_lm] = lm_ids
        m.add_keyframe(Rn, tn, uv_full, np.zeros(max_kp, np.int32),
                       np.zeros(max_kp, np.float32), valid,
                       rng.integers(0, 2, (max_kp, 256)).astype(np.uint8),
                       frame_id=k, timestamp=0.1 * k, kp_lm=kp_lm)
    return cfg, m, X_gt, lm_ids


def test_bundle_adjust_pcg_matches_reference():
    """The matrix-free PCG assembly on the noisy map's global-BA problem:
    poses and points within 1e-3 of the reference's, final chi2 within
    1e-3 relative."""
    cfg, m, _, _ = _noisy_map(JMapState)
    s = jgba._assemble_gba(cfg, m, None)
    names = ("R_all", "t_all", "fixed_p", "X", "lm_mask", "op", "ol", "ouv",
             "olev", "omask")
    jo = j_bundle_adjust(J_PROJ, J_JAC, *(jnp.asarray(s[k]) for k in names),
                         n_iters=6, assembly="pcg")
    to = t_bundle_adjust(T_PROJ, T_JAC, *(_T(s[k]) for k in names),
                         n_iters=6, assembly="pcg")
    for a, b in zip(to[:3], jo[:3]):
        _close(a, b, 1e-3)
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("force_pcg", [False, True])
def test_global_bundle_adjustment_matches_reference(force_pcg):
    """Whole-map GBA on the same noisy map in both packages (dense and
    forced-PCG assembly): keyframe poses and landmarks within 1e-3 of the
    reference's and of the ground truth."""
    jcfg, jm, X_gt, lm_ids = _noisy_map(JMapState)
    _, tm, _, _ = _noisy_map(TMapState)
    cfg = TrackerConfig(device="cpu")
    old_j, old_t = jgba.DENSE_CROSS_BLOCK_FLOATS, tgba.DENSE_CROSS_BLOCK_FLOATS
    try:
        if force_pcg:
            jgba.DENSE_CROSS_BLOCK_FLOATS = tgba.DENSE_CROSS_BLOCK_FLOATS = 1
        assert jgba.global_bundle_adjustment(jcfg, jm, n_iters=12)
        assert tgba.global_bundle_adjustment(cfg, tm, n_iters=12)
    finally:
        jgba.DENSE_CROSS_BLOCK_FLOATS, tgba.DENSE_CROSS_BLOCK_FLOATS = old_j, old_t
    kfs = np.arange(8)
    np.testing.assert_allclose(tm.kf_R[kfs], jm.kf_R[kfs], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[kfs], jm.kf_t[kfs], atol=1e-3)
    np.testing.assert_allclose(tm.lm_pos[lm_ids], jm.lm_pos[lm_ids], atol=1e-3)
    np.testing.assert_array_equal(tm.kf_kp_lm, jm.kf_kp_lm)
    assert np.median(np.linalg.norm(tm.lm_pos[lm_ids] - X_gt, axis=1)) < 1e-3
    assert tm.change_idx == jm.change_idx
