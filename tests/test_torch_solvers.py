"""Parity of the torch port's KLT refinement, pose solver, bundle
adjustment and two-view reconstruction with the JAX reference package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.cameras import twoview as jtwoview
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.lie import se3 as jse3
from orb_slam3_study_kr_tpu.ops import klt as jklt
from orb_slam3_study_kr_tpu.solvers import bundle_adjust as j_bundle_adjust
from orb_slam3_study_kr_tpu.solvers import optimize_pose as j_optimize_pose
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.cameras import twoview as ttwoview
from orb_slam3_study_kr_tpu_torch.ops import klt as tklt
from orb_slam3_study_kr_tpu_torch.ops import cuda_schur
from orb_slam3_study_kr_tpu_torch.ops import orb as torb
from orb_slam3_study_kr_tpu_torch.solvers import local_ba as tlocal_ba
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust as t_bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers import optimize_pose as t_optimize_pose

torch.set_num_threads(2)

PARAMS = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
j_proj = functools.partial(jpinhole.project, jnp.asarray(PARAMS))
j_jac = functools.partial(jpinhole.project_jac, jnp.asarray(PARAMS))
t_proj = functools.partial(tpinhole.project, torch.as_tensor(PARAMS))
t_jac = functools.partial(tpinhole.project_jac, torch.as_tensor(PARAMS))
K = np.array([[458.0, 0, 376.0], [0, 457.0, 240.0], [0, 0, 1]], np.float32)


def _T(a):
    return torch.as_tensor(np.asarray(a))


def test_klt_refine_matches_reference():
    """Templates from frame A, alignment in frame B (0.6 px lateral shift).
    Tolerances: refined uv 2e-3 px, zncc / distinct 1e-3, shift 2e-3 px,
    aligned window 5e-2 gray levels — 5 GN iterations amplify the ulp-level
    differences of bilinear samples (gathers here, hat-weight matmuls in
    the reference)."""
    rng = np.random.default_rng(1)
    H, W = 240, 320
    Ks = np.array([[230.0, 0, 160.0], [0, 230.0, 120.0], [0, 0, 1]])
    world = synthetic.make_textured_world(rng, K=Ks, width=W, height=H, depth=6.0)
    img_a = synthetic.render_textured(world, np.eye(3), np.zeros(3), rng=rng)
    img_b = synthetic.render_textured(world, np.eye(3), np.array([-0.01, 0, 0]),
                                      rng=rng)
    cfg = torb.OrbConfig(n_features=400, height=H, width=W)
    fa = torb.extract_orb(_T(img_a), cfg)
    _, pyr_b = torb.extract_orb(_T(img_b), cfg, with_pyramid=True)
    v = fa.valid.numpy()
    uv = fa.uv.numpy()[v]
    level = fa.level.numpy()[v]
    angle = fa.angle.numpy()[v]
    tmpl = fa.patch.numpy()[v]
    mask = rng.random(v.sum()) < 0.9
    level_wh = tklt.make_level_wh(cfg)
    np.testing.assert_array_equal(level_wh, jklt.make_level_wh(cfg))
    args = (pyr_b.numpy(), level_wh, uv, level, angle, tmpl, mask)
    jout = [np.asarray(x) for x in jklt.klt_refine(*[jnp.asarray(a) for a in args])]
    tout = [x.numpy() for x in tklt.klt_refine(*[_T(a) for a in args])]
    tols = dict(uv_ref=2e-3, zncc=1e-3, shift=2e-3, win=5e-2, distinct=1e-3)
    for (name, tol), a, b in zip(tols.items(), tout, jout):
        assert np.abs(a - b).max() < tol, (name, np.abs(a - b).max())
    good = mask & (jout[1] >= 0.5) & (jout[2] < 3.0)
    assert good.sum() > 50


def _pose_problem(seed, n=150, outliers=20):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 10, n)], -1).astype(np.float32)
    xi = np.array([0.02, -0.03, 0.01, 0.1, -0.05, 0.08], np.float32)
    R, t = [np.asarray(a) for a in jse3.exp_se3(jnp.asarray(xi))]
    uv = np.asarray(j_proj(jnp.asarray(X @ R.T + t)))
    level = rng.integers(0, 4, n).astype(np.int32)
    uv = uv + rng.normal(0, 0.7, uv.shape).astype(np.float32) * 1.2 ** level[:, None]
    uv[:outliers] += rng.uniform(20, 40, (outliers, 2)).astype(np.float32)
    mask = (rng.random(n) < 0.95).astype(np.float32)
    return X, uv.astype(np.float32), level, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose_matches_reference(seed):
    """4 rounds x 10 GN steps from identity: R, t within 1e-4; inlier masks
    equal."""
    X, uv, level, mask = _pose_problem(seed)
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    args = (R0, t0, X, uv, level, mask)
    Rj, tj, inj, nj = j_optimize_pose(j_proj, j_jac, *[jnp.asarray(a) for a in args])
    Rt, tt, int_, nt = t_optimize_pose(t_proj, t_jac, *[_T(a) for a in args])
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 100


def _ba_problem(seed, K_=4, M=120):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                  rng.uniform(4, 8, M)], -1).astype(np.float32)
    Rs, ts, obs = [], [], []
    for k in range(K_):
        xi = np.array([0, 0.02 * k, 0, -0.1 * k, 0, 0], np.float32)
        R, t = [np.asarray(a) for a in jse3.exp_se3(jnp.asarray(xi))]
        Rs.append(R)
        ts.append(t)
        uv = np.asarray(j_proj(jnp.asarray(X @ R.T + t)))
        for m in range(M):
            if rng.random() < 0.85:
                obs.append((k, m, *(uv[m] + rng.normal(0, 0.5, 2))))
    obs = np.asarray(obs)
    Rs = np.stack(Rs)
    ts = np.stack(ts) + rng.normal(0, 0.01, (K_, 3)).astype(np.float32)
    ts[0] = 0
    Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return (Rs.astype(np.float32), ts.astype(np.float32),
            np.array([1.0, 1.0] + [0.0] * (K_ - 2), np.float32),
            Xn, np.ones(M, np.float32),
            obs[:, 0].astype(np.int32), obs[:, 1].astype(np.int32),
            obs[:, 2:4].astype(np.float32),
            rng.integers(0, 3, len(obs)).astype(np.int32),
            np.ones(len(obs), np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_matches_reference(seed):
    """Dense Schur LM, 10 iterations: poses within 1e-3, points within 5e-3,
    final chi2 relative within 1e-3 — the segment sums and the 24x24 dense
    solve accumulate in a different order than XLA's."""
    args = _ba_problem(seed)
    Rj, tj, Xj, cj, costj = j_bundle_adjust(
        j_proj, j_jac, *[jnp.asarray(a) for a in args], n_iters=10)
    Rt, tt, Xt, ct, costt = t_bundle_adjust(
        t_proj, t_jac, *[_T(a) for a in args], n_iters=10)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5e-3)
    cj, ct = np.asarray(cj), ct.numpy()
    assert abs(ct.sum() - cj.sum()) <= 1e-3 * cj.sum()
    assert abs(float(costt) - float(costj)) <= 1e-3 * float(costj)


def _two_view(seed, n=300):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 9, n)], -1).astype(np.float32)
    xi = np.array([0.01, 0.04, -0.01, -0.3, 0.02, 0.05], np.float32)
    R, t = [np.asarray(a) for a in jse3.exp_se3(jnp.asarray(xi))]
    uv1 = np.asarray(j_proj(jnp.asarray(X)))
    uv2 = np.asarray(j_proj(jnp.asarray(X @ R.T + t)))
    uv1 = uv1 + rng.normal(0, 0.5, uv1.shape)
    uv2 = uv2 + rng.normal(0, 0.5, uv2.shape)
    uv2[:25] += rng.uniform(-30, 30, (25, 2))
    mask = (rng.random(n) < 0.95).astype(np.float32)
    return uv1.astype(np.float32), uv2.astype(np.float32), mask, R, t


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_two_views_with_injected_sets(seed):
    """The reference's jax.random minimal sets are injected into the port:
    same model choice and success; R21, t21 within 1e-3 (the decomposition
    picks the same motion; SVD/eigh signs differ and cancel); >= 98% of the
    triangulation validity mask agrees."""
    uv1, uv2, mask, R, t = _two_view(seed)
    key = jax.random.PRNGKey(seed)
    jout = jtwoview.reconstruct_two_views(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(mask), jnp.asarray(K))
    kh, kf = jax.random.split(key)
    sets = [np.asarray(jtwoview._sample_minimal_sets(k, jnp.asarray(mask), 200))
            for k in (kh, kf)]
    tout = ttwoview.reconstruct_two_views(_T(uv1), _T(uv2), _T(mask), _T(K),
                                          sets=sets)
    assert bool(tout["success"]) == bool(jout["success"])
    assert bool(tout["used_homography"]) == bool(jout["used_homography"])
    np.testing.assert_allclose(tout["R21"].numpy(), np.asarray(jout["R21"]), atol=1e-3)
    np.testing.assert_allclose(tout["t21"].numpy(), np.asarray(jout["t21"]), atol=1e-3)
    assert abs(float(tout["score_h"]) - float(jout["score_h"])) <= 1e-3 * float(jout["score_h"])
    assert abs(float(tout["score_f"]) - float(jout["score_f"])) <= 1e-3 * float(jout["score_f"])
    gj, gt = np.asarray(jout["good"]), tout["good"].numpy()
    assert (gj == gt).mean() >= 0.98
    # And the recovered motion is the true one (up to monocular scale).
    np.testing.assert_allclose(tout["R21"].numpy(), R, atol=5e-3)
    tn = t / np.linalg.norm(t)
    assert float(tout["t21"].numpy() @ tn) > 0.999


def test_reconstruct_two_views_generator_draws():
    """Without injected sets the port draws its own (torch.Generator)
    minimal sets and still recovers the motion."""
    uv1, uv2, mask, R, t = _two_view(3)
    g = torch.Generator().manual_seed(0)
    out = ttwoview.reconstruct_two_views(_T(uv1), _T(uv2), _T(mask), _T(K),
                                         generator=g)
    assert bool(out["success"])
    np.testing.assert_allclose(out["R21"].numpy(), R, atol=5e-3)


def _schur_graph(seed, K=7, M=50):
    """A random reduced camera system in float64: poses 0-1 fixed (their E
    rows left nonzero, so that only the masking cuts them out), pose K - 1
    unobserved, landmark 0 unobserved, landmark 1 seen once, the rest by 2-5
    poses; observations in a shuffled order.
    Returns (Hpp_d, Hll_inv, E, obs_pose, obs_lm, fixed, S) with S the
    dense (6K, 6K) free-pose Schur complement built from W (K, M, 6, 3)."""
    rng = np.random.default_rng(seed)
    obs = [(0 if m == 1 else k, m) for m in range(1, M)
           for k in rng.choice(K - 1, size=1 if m == 1 else rng.integers(2, 6),
                               replace=False)]
    obs = np.asarray(obs)[rng.permutation(len(obs))]
    op, ol = torch.as_tensor(obs[:, 0]), torch.as_tensor(obs[:, 1])
    fixed = torch.zeros(K, dtype=torch.float64)
    fixed[:2] = 1
    g = torch.Generator().manual_seed(seed)
    E = torch.randn(len(obs), 6, 3, generator=g, dtype=torch.float64)
    A = torch.randn(M, 3, 3, generator=g, dtype=torch.float64)
    Hll_inv = torch.linalg.inv(A @ A.transpose(1, 2) + torch.eye(3))
    B = torch.randn(K, 6, 6, generator=g, dtype=torch.float64)
    Hpp_d = B @ B.transpose(1, 2) + torch.eye(6)
    W = torch.zeros(K, M, 6, 3, dtype=torch.float64)
    W[op, ol] = E
    S = torch.block_diag(*Hpp_d) - torch.einsum(
        "kmab,mbc,lmdc->kald", W, Hll_inv, W).reshape(6 * K, 6 * K)
    free = (1 - fixed).repeat_interleave(6)
    return Hpp_d, Hll_inv, E, op, ol, fixed, S * free[:, None] * free[None]


@pytest.mark.parametrize("seed", [0, 1])
def test_schur_matvec_matches_dense_schur_complement(seed):
    """The PCG loop's plain matvec (two segment-sum sweeps, W never formed)
    equals S v with S built densely from W, fixed poses cut out; and so
    does the CUDA kernel's plain twin, computed from the kernel's index
    arrays and landmark-sorted E planes.  Float64: 1e-10 relative."""
    Hpp_d, Hll_inv, E, op, ol, fixed, S = _schur_graph(seed)
    K, M = Hpp_d.shape[0], Hll_inv.shape[0]
    v = torch.randn(K, 6, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    ref = (S @ v.reshape(-1)).reshape(K, 6)
    tol = 1e-10 * float(ref.abs().max())
    got = tlocal_ba._schur_matvec(v, Hpp_d, (1 - fixed)[:, None],
                                  [(Hll_inv, None, E, op, ol)],
                                  [(None, None)], tlocal_ba._only)
    assert float((got - ref).abs().max()) <= tol
    idx = cuda_schur.schur_index(K, M, op, ol)
    twin = cuda_schur.schur_matvec_plain(
        v, Hpp_d, Hll_inv, cuda_schur.landmark_planes(E, idx), fixed, idx)
    assert float((twin - ref).abs().max()) <= tol


def test_schur_index_describes_the_observation_graph():
    """The kernel's once-per-solve index arrays, built in plain torch,
    describe the graph of (obs_pose, obs_lm): landmark-sorted positions
    with each landmark's run, their poses, and pose by pose the positions
    of the pose's observations, with the segment plans' stable orders."""
    _, _, _, op, ol, _, _ = _schur_graph(0)
    K, M, O = 7, 50, op.numel()
    idx = cuda_schur.schur_index(K, M, op, ol)
    assert idx.lm_off.dtype == idx.op_lm.dtype == torch.int32
    assert idx.pose_pos.dtype == idx.pose_off.dtype == torch.int32
    lm_off, pose_off = idx.lm_off.long(), idx.pose_off.long()
    assert lm_off[0] == 0 and lm_off[-1] == O and bool((lm_off.diff() >= 0).all())
    assert pose_off[0] == 0 and pose_off[-1] == O
    np.testing.assert_array_equal(np.sort(idx.lm_perm.numpy()), np.arange(O))
    np.testing.assert_array_equal(np.sort(idx.pose_pos.numpy()), np.arange(O))
    lm_of = torch.repeat_interleave(torch.arange(M), lm_off.diff())
    pose_of = torch.repeat_interleave(torch.arange(K), pose_off.diff())
    # Position q holds observation lm_perm[q]: its landmark and its pose.
    np.testing.assert_array_equal(ol[idx.lm_perm].numpy(), lm_of.numpy())
    np.testing.assert_array_equal(op[idx.lm_perm].numpy(), idx.op_lm.numpy())
    # Within a landmark, observations keep their input order (stable).
    assert bool((idx.lm_perm.diff()[lm_of[1:] == lm_of[:-1]] > 0).all())
    # Pose by pose: each listed position is one of the pose's observations,
    # in input order, and every observation is listed once.
    pos_obs = idx.lm_perm[idx.pose_pos.long()]
    np.testing.assert_array_equal(op[pos_obs].numpy(), pose_of.numpy())
    assert bool((pos_obs.diff()[pose_of[1:] == pose_of[:-1]] > 0).all())
    assert int(pose_off[K] - pose_off[K - 1]) == 0          # unobserved pose
    assert int(lm_off[1] - lm_off[0]) == 0                  # unobserved landmark
    assert int(lm_off[2] - lm_off[1]) == 1                  # seen once
    # The segment plans' sorts, where given, give the same arrays.
    from orb_slam3_study_kr_tpu_torch.ops.segment import SegmentPlan
    again = cuda_schur.schur_index(K, M, op, ol, SegmentPlan(K, op),
                                   SegmentPlan(M, ol))
    for a, b in zip(idx, again):
        assert torch.equal(a, b)


def test_schur_index_keeps_masked_observations_out_of_the_ranges():
    """Masked observations, the padding of a bucketed map (pose 0,
    landmark 0, weight 0), sit in a tail of both orders that no range
    covers: with the padding at the end the live part equals the index of
    the unpadded graph, and the kernel's plain twin reads none of it (NaN
    E blocks there leave S v as the dense S without the padding gives)."""
    Hpp_d, Hll_inv, E, op, ol, fixed, S = _schur_graph(1)
    K, M, O = Hpp_d.shape[0], Hll_inv.shape[0], op.numel()
    pad = 37
    op_p = torch.cat([op, torch.zeros(pad, dtype=op.dtype)])
    ol_p = torch.cat([ol, torch.zeros(pad, dtype=ol.dtype)])
    E_p = torch.cat([E, torch.full((pad, 6, 3), float("nan"),
                                   dtype=E.dtype)])
    mask = torch.cat([torch.ones(O), torch.zeros(pad)])
    live = cuda_schur.schur_index(K, M, op, ol)
    idx = cuda_schur.schur_index(K, M, op_p, ol_p, obs_mask=mask)
    assert int(idx.lm_off[M]) == int(idx.pose_off[K]) == O
    for name in ("lm_off", "pose_off"):
        assert torch.equal(getattr(idx, name), getattr(live, name))
    for name in ("lm_perm", "op_lm", "pose_pos"):
        assert torch.equal(getattr(idx, name)[:O], getattr(live, name))
    np.testing.assert_array_equal(np.sort(idx.lm_perm[O:].numpy()),
                                  np.arange(O, O + pad))
    np.testing.assert_array_equal(np.sort(idx.pose_pos.numpy()),
                                  np.arange(O + pad))
    # Interleaved padding: the same ranges, over the live observations.
    order = torch.randperm(O + pad, generator=torch.Generator().manual_seed(4))
    mixed = cuda_schur.schur_index(K, M, op_p[order], ol_p[order],
                                   obs_mask=mask[order])
    assert torch.equal(mixed.lm_off, live.lm_off)
    assert torch.equal(mixed.pose_off, live.pose_off)
    assert bool((mask[order][mixed.lm_perm[:O]] == 1).all())
    v = torch.randn(K, 6, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    ref = (S @ v.reshape(-1)).reshape(K, 6)
    for ix, Es in ((idx, E_p), (mixed, E_p[order])):
        twin = cuda_schur.schur_matvec_plain(
            v, Hpp_d, Hll_inv, cuda_schur.landmark_planes(Es, ix), fixed, ix)
        assert float((twin - ref).abs().max()) <= 1e-10 * float(
            ref.abs().max())
