"""The reference's rule for a singular linear system, caller by caller.

``jnp.linalg.solve`` / ``inv`` return non-finite values where LU meets an
exactly zero pivot, and the reference carries on; ``torch.linalg.solve`` /
``inv`` raise for the whole batch.  The port's callers go through
``solvers/linalg_nan`` (the ``*_ex`` forms, NaN where the factorization
failed).  Each case feeds one caller an exactly singular system, shows
that the call as it was (the raising form) raises on it, and holds what the
port's caller returns to what the reference's returns: the same non-finite
elements, the finite ones within the tolerance of that caller's parity
test.  The damped callers are made singular with their damping at 0 and a
block that nothing observes.  A last test runs every caller on a
non-singular input through the helpers and through the raising forms and
asserts bit-identical outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.cameras import twoview as jtwoview
from orb_slam3_study_kr_tpu.lie import sim3 as jsim3lie
from orb_slam3_study_kr_tpu.parallel import dist_ba as jdist
from orb_slam3_study_kr_tpu.solvers import bundle_adjust as j_bundle_adjust
from orb_slam3_study_kr_tpu.solvers import optimize_pose as j_optimize_pose
from orb_slam3_study_kr_tpu.solvers import pose_graph as jpg
from orb_slam3_study_kr_tpu.solvers import sim3_solver as jsim3
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.cameras import twoview as ttwoview
from orb_slam3_study_kr_tpu_torch.lie import sim3 as tsim3lie
from orb_slam3_study_kr_tpu_torch.parallel import dist_ba as tdist
from orb_slam3_study_kr_tpu_torch.solvers import linalg_nan
from orb_slam3_study_kr_tpu_torch.solvers import local_ba as tlocal_ba
from orb_slam3_study_kr_tpu_torch.solvers import pose_graph as tpg
from orb_slam3_study_kr_tpu_torch.solvers import pose_opt as tpose_opt
from orb_slam3_study_kr_tpu_torch.solvers import sim3_solver as tsim3

torch.set_num_threads(2)

K_MAT = np.array([[458.0, 0, 376.0], [0, 457.0, 240.0], [0, 0, 1.0]], np.float32)
PARAMS = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)
J_PROJ = functools.partial(jpinhole.project, jnp.asarray(PARAMS))
J_JAC = functools.partial(jpinhole.project_jac, jnp.asarray(PARAMS))
T_PROJ = functools.partial(tpinhole.project, torch.as_tensor(PARAMS))
T_JAC = functools.partial(tpinhole.project_jac, torch.as_tensor(PARAMS))
RAISING = {"solve_nan": torch.linalg.solve, "inv_nan": torch.linalg.inv}


def _T(a):
    return torch.as_tensor(np.array(a))


def _raising(monkeypatch, module):
    """``module``'s calls as they were: the raising, syncing forms."""
    for name, fn in RAISING.items():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, fn)


def _same(t, j, atol, rtol=0.0):
    """Same non-finite elements; the finite ones within atol + rtol |j|."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    if t.dtype == bool or np.issubdtype(t.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t[fin], j[fin], atol=atol, rtol=rtol)


# ---------------------------------------------------------------- problems


def _pose_problem(n=60):
    rng = np.random.default_rng(4)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 10, n)], -1).astype(np.float32)
    R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        [0.02, -0.03, 0.01, 0.1, -0.05, 0.08], jnp.float32)))
    uv = np.asarray(J_PROJ(jnp.asarray(X @ R.T + t)))
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    level = rng.integers(0, 4, n).astype(np.int32)
    return (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
            level, np.ones(n, np.float32))


def _sim3_problem(n=60):
    rng = np.random.default_rng(5)
    P2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], -1).astype(np.float32)
    R12, t12, s12 = jlie.exp_sim3(jnp.asarray(
        [0.08, -0.04, 0.12, 0.4, -0.25, 0.15, 0.25], jnp.float32))
    P1 = np.array(jlie.sim3_apply(R12, t12, s12, jnp.asarray(P2)))
    uv1 = np.asarray(J_PROJ(jnp.asarray(P1)))
    uv2 = np.asarray(J_PROJ(jnp.asarray(P2)))
    dR, dt, ds = jlie.exp_sim3(jnp.asarray(
        [0.02, -0.015, 0.01, 0.05, 0.03, -0.04, 0.05], jnp.float32))
    R0 = (np.asarray(R12) @ np.asarray(dR)).astype(np.float32)
    t0 = (np.asarray(t12) + np.asarray(dt)).astype(np.float32)
    s0 = np.float32(float(s12) * float(ds))
    return P1, P2, np.ones(n, np.float32), uv1, uv2, K_MAT, R0, t0, s0


def _pose_graph_problem(K=6, lonely=None):
    """A drifted chain with one loop edge; vertex ``lonely`` (free) keeps
    no live edge."""
    rng = np.random.default_rng(6)
    zs = [np.concatenate([rng.normal(0, 0.05, 3), [np.cos(k), 0.1 * k,
                                                   np.sin(k)], [0.0]])
          for k in range(K)]
    R, t, s = (np.stack([np.asarray(x[i]) for x in
                         (jlie.exp_sim3(jnp.asarray(z, jnp.float32)) for z in zs)])
               for i in range(3))
    ei = np.asarray(list(range(1, K)) + [K - 1], np.int32)
    ej = np.asarray(list(range(0, K - 1)) + [0], np.int32)
    Rm, tm, sm = (np.array(a) for a in jpg.relative_sim3(
        R[ei], t[ei], s[ei], R[ej], t[ej], s[ej]))
    tm = (tm + rng.normal(0, 0.02, tm.shape)).astype(np.float32)
    w = np.ones(len(ei), np.float32)
    if lonely is not None:
        w[(ei == lonely) | (ej == lonely)] = 0.0
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    return (R, t, s.astype(np.float32), ei, ej, Rm, tm, sm, w, fixed)


def _ba_problem(unseen_pose=False, unseen_lm=False, K=3, M=24):
    """K posed cameras observing all M landmarks; ``unseen_pose`` adds a
    free camera that observes nothing, ``unseen_lm`` a live landmark that
    nothing observes."""
    rng = np.random.default_rng(8)
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                  rng.uniform(4, 8, M)], -1).astype(np.float32)
    Rs, ts, obs = [], [], []
    for k in range(K):
        R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
            [0, 0.02 * k, 0, -0.1 * k, 0, 0], jnp.float32)))
        Rs.append(R)
        ts.append(t)
        uv = np.asarray(J_PROJ(jnp.asarray(X @ R.T + t)))
        obs += [(k, m, *(uv[m] + rng.normal(0, 0.5, 2))) for m in range(M)]
    if unseen_pose:
        Rs.append(Rs[-1])
        ts.append(ts[-1] + np.float32(0.1))
    if unseen_lm:
        X = np.concatenate([X, [[0.0, 0.0, 6.0]]]).astype(np.float32)
    obs = np.asarray(obs)
    Kp = len(Rs)
    ts = np.stack(ts) + rng.normal(0, 0.01, (Kp, 3)).astype(np.float32)
    ts[0] = 0
    Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(Kp, np.float32)
    fixed[0] = 1.0
    return (np.stack(Rs).astype(np.float32), ts.astype(np.float32), fixed,
            Xn, np.ones(len(X), np.float32), obs[:, 0].astype(np.int32),
            obs[:, 1].astype(np.int32), obs[:, 2:4].astype(np.float32),
            np.zeros(len(obs), np.int32), np.ones(len(obs), np.float32))


def _homography_problem(n=80):
    rng = np.random.default_rng(9)
    H = np.array([[1.01, 0.02, 3.0], [0.01, 0.99, -2.0], [1e-5, 2e-5, 1.0]],
                 np.float32)
    kp1 = rng.uniform([0, 0], [752, 480], (n, 2)).astype(np.float32)
    x = np.concatenate([kp1, np.ones((n, 1), np.float32)], 1) @ H.T
    kp2 = (x[:, :2] / x[:, 2:] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    return H, kp1, kp2, np.ones(n, np.float32)


def _two_view(seed=0, n=300):
    """tests/test_torch_solvers.py's two-view problem on integer pixels,
    shifted so that image 2's masked mean is exactly (0, 0) (K's principal
    point moves with it): integer sums are exact in any order, so a match
    placed at (0, 0) in image 2 normalizes to exactly 0."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 9, n)], -1).astype(np.float32)
    R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        [0.01, 0.04, -0.01, -0.3, 0.02, 0.05], jnp.float32)))
    uv1 = np.asarray(J_PROJ(jnp.asarray(X))) + rng.normal(0, 0.5, (n, 2))
    uv2 = np.asarray(J_PROJ(jnp.asarray(X @ R.T + t))) + rng.normal(0, 0.5, (n, 2))
    uv2[:25] += rng.uniform(-30, 30, (25, 2))
    mask = (rng.random(n) < 0.95).astype(np.float32)
    off = np.round((uv2 * mask[:, None]).sum(0) / mask.sum())
    uv1 = (np.round(uv1) - off).astype(np.float32)
    uv2 = (np.round(uv2) - off).astype(np.float32)
    K = K_MAT.copy()
    K[:2, 2] -= off
    return uv1, uv2, mask, K


def _zero_mean(uv2, mask, keep):
    """Move one masked match outside ``keep`` so that image 2's masked sum
    is exactly 0."""
    j = next(i for i in range(len(mask)) if mask[i] > 0 and i not in keep)
    uv2[j] -= (uv2 * mask[:, None]).sum(0)
    return uv2


def _reference_sets(seed, mask, iters=200):
    kh, kf = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jtwoview._sample_minimal_sets(k, jnp.asarray(mask), iters))
            for k in (kh, kf)]


def _reference_two_views(monkeypatch, sets, kp1, kp2, mask, K):
    """The reference's reconstruct_two_views with ``sets`` in place of its
    own draws (its minimal-set sampler patched, the function run
    unjitted)."""
    it = iter(sets)
    monkeypatch.setattr(jtwoview, "_sample_minimal_sets",
                        lambda key, m, iters: jnp.asarray(next(it)))
    out = jtwoview.reconstruct_two_views.__wrapped__(
        jax.random.PRNGKey(0), jnp.asarray(kp1), jnp.asarray(kp2),
        jnp.asarray(mask), jnp.asarray(K))
    monkeypatch.undo()
    return out


def _two_view_outputs_agree(tout, jout):
    """tests/test_torch_solvers.py's two-view bar: the same success and
    model; scores within 1e-3 relative; the chosen motion within 1e-3."""
    assert bool(tout["success"]) == bool(jout["success"])
    assert bool(tout["used_homography"]) == bool(jout["used_homography"])
    for k in ("score_h", "score_f"):
        _same(tout[k], jout[k], atol=1e-3, rtol=1e-3)
    if bool(jout["success"]):
        for k in ("R21", "t21"):
            _same(tout[k], jout[k], atol=1e-3)


# ------------------------------------------------------------------- cases
# Each case maps ``singular`` to (port call, reference call, port module,
# atol); a call returns a tuple of outputs.


def _case_score_homography(singular):
    H, kp1, kp2, mask = _homography_problem()
    H2 = np.diag([1.0, 1.0, 0.0]).astype(np.float32) @ H if singular \
        else H + np.float32(1e-3)
    Hs = np.stack([H, H2])
    return (lambda: ttwoview._score_homography(_T(Hs), _T(kp1), _T(kp2),
                                               _T(mask), 1.0),
            lambda: jtwoview._score_homography(jnp.asarray(Hs), jnp.asarray(kp1),
                                               jnp.asarray(kp2),
                                               jnp.asarray(mask), 1.0),
            ttwoview, 1e-3)


def _case_two_view_T2(singular):
    """T2 is singular where image 2's masked spread overflows to inf (its x
    scale becomes 0); below that the clamp keeps it invertible."""
    kp1, kp2, mask, K = _two_view(1)
    if singular:
        live = np.nonzero(mask)[0]
        kp2[live[0], 0], kp2[live[1], 0] = 3.0e38, -3.0e38
    sets = _reference_sets(1, mask)
    return (lambda: ttwoview.reconstruct_two_views(_T(kp1), _T(kp2), _T(mask),
                                                   _T(K), sets=sets),
            lambda mp: _reference_two_views(mp, sets, kp1, kp2, mask, K),
            ttwoview, None)


def _case_two_view_K(singular):
    """K with a zero last row: K^-1 is singular, the pixel bearings (fx,
    fy, cx, cy) are not."""
    kp1, kp2, mask, K = _two_view(2)
    if singular:
        K[2, 2] = 0.0
    sets = _reference_sets(2, mask)
    return (lambda: ttwoview.reconstruct_two_views(_T(kp1), _T(kp2), _T(mask),
                                                   _T(K), sets=sets),
            lambda mp: _reference_two_views(mp, sets, kp1, kp2, mask, K),
            ttwoview, None)


def _case_refine_essential(singular):
    kp1, kp2, mask, K = _two_view(3)
    xn1 = ((kp1 - K[:2, 2]) / K[[0, 1], [0, 1]]).astype(np.float32)
    xn2 = ((kp2 - K[:2, 2]) / K[[0, 1], [0, 1]]).astype(np.float32)
    R, t = (np.asarray(a) for a in jlie.exp_se3(jnp.asarray(
        [0.01, 0.04, -0.01, -0.3, 0.02, 0.05], jnp.float32)))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                  np.float32)
    E0 = (tx @ R).astype(np.float32)
    w = mask * (0.0 if singular else 1.0)
    damping = 0.0 if singular else 1e-4
    return (lambda: (ttwoview._refine_essential(_T(E0), _T(xn1), _T(xn2), _T(w),
                                                damping=damping),),
            lambda: (jtwoview._refine_essential(jnp.asarray(E0), jnp.asarray(xn1),
                                                jnp.asarray(xn2), jnp.asarray(w),
                                                damping=damping),),
            ttwoview, 1e-3)


def _case_pose_opt(singular):
    R0, t0, X, uv, level, mask = _pose_problem()
    if singular:
        mask = np.zeros_like(mask)
    damping = 0.0 if singular else 1e-3
    args = (R0, t0, X, uv, level, mask)
    return (lambda: tpose_opt.optimize_pose(T_PROJ, T_JAC, *map(_T, args),
                                            damping=damping),
            lambda: j_optimize_pose(J_PROJ, J_JAC, *map(jnp.asarray, args),
                                    damping=damping),
            tpose_opt, 1e-4)


def _case_sim3(singular):
    P1, P2, mask, uv1, uv2, K, R0, t0, s0 = _sim3_problem()
    if singular:
        mask = np.zeros_like(mask)
    damping = 0.0 if singular else 1e-4
    args = (P1, P2, mask, uv1, uv2, K, R0, t0, s0)
    keys = ("R12", "t12", "s12", "inliers")

    def port():
        o = tsim3.optimize_sim3(*map(_T, args), damping=damping)
        return tuple(o[k] for k in keys)

    def ref():
        o = jsim3.optimize_sim3(*map(jnp.asarray, args), damping=damping)
        return tuple(o[k] for k in keys)
    return port, ref, tsim3, 1e-4


def _case_pose_graph(singular):
    args = _pose_graph_problem(lonely=3 if singular else None)
    damping = 0.0 if singular else 1e-6
    return (lambda: tpg.optimize_pose_graph(*map(_T, args), n_iters=8,
                                            damping=damping),
            lambda: jpg.optimize_pose_graph(*map(jnp.asarray, args), n_iters=8,
                                            damping=damping),
            tpg, 1e-4)


def _ba_case(assembly, unseen):
    def case(singular):
        args = _ba_problem(**({unseen: True} if singular else {}))
        lam = 0.0 if singular else 1e-4
        return (lambda: tlocal_ba.bundle_adjust(
                    T_PROJ, T_JAC, *map(_T, args), n_iters=1, init_lambda=lam,
                    assembly=assembly),
                lambda: j_bundle_adjust(
                    J_PROJ, J_JAC, *map(jnp.asarray, args), n_iters=1,
                    init_lambda=lam, assembly=assembly),
                tlocal_ba, 1e-3)
    return case


def _dist_ba_case(assembly, unseen):
    """The port over 2 CPU shards against the reference's solver over a
    1-device mesh; the port's landmarks are read back in the caller's
    order."""
    def case(singular):
        (R, t, fixed, X, lmm, op, ol, ouv, olev, om) = _ba_problem(
            **({unseen: True} if singular else {}))
        lam = 0.0 if singular else 1e-4
        sh = tdist.shard_ba_problem(2, X, lmm, op, ol, ouv, olev, om)
        rows = sh[7] * sh[9] + sh[8]

        def port():
            mesh = tdist.make_ba_mesh(["cpu"] * 2)
            Rt, tt, Xt, _ = tdist.distributed_bundle_adjust(
                mesh, T_PROJ, T_JAC, _T(R), _T(t), _T(fixed),
                *map(_T, sh[:7]), n_iters=1, init_lambda=lam, assembly=assembly)
            return Rt, tt, Xt[torch.as_tensor(rows)]

        def ref():
            mesh = jdist.make_ba_mesh(jax.devices()[:1])
            Rj, tj, Xj, _ = jdist.distributed_bundle_adjust(
                mesh, J_PROJ, J_JAC, *map(jnp.asarray, (R, t, fixed, X, lmm, op,
                                                         ol, ouv, olev, om)),
                n_iters=1, init_lambda=lam, assembly=assembly)
            return Rj, tj, Xj
        return port, ref, tdist, 1e-3
    return case


def _case_log_sim3(singular):
    """No finite (R, t, s) makes W exactly singular (its phi-axis
    eigenvalue (s - 1) / sigma is 0 only at sigma = +-inf, where W is
    NaN), so both packages' W is replaced by the same matrix: rank 2 when
    ``singular``."""
    W = np.array([[2.0, 0.3, 0.0], [0.1, 1.5, 0.0],
                  [0.0, 0.0, 0.0 if singular else 0.7]], np.float32)
    R = np.asarray(jlie.exp_so3(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    t = np.array([0.4, -0.1, 0.2], np.float32)
    s = np.float32(1.3)

    def port():
        orig = tsim3lie._sim3_W
        tsim3lie._sim3_W = lambda phi, sigma: _T(W).expand(*phi.shape[:-1], 3, 3)
        try:
            return (tsim3lie.log_sim3(_T(R), _T(t), _T(s)),)
        finally:
            tsim3lie._sim3_W = orig

    def ref():
        orig = jsim3lie._sim3_W
        jsim3lie._sim3_W = lambda phi, sigma: jnp.broadcast_to(
            jnp.asarray(W), phi.shape[:-1] + (3, 3))
        try:
            return (jsim3lie.log_sim3(jnp.asarray(R), jnp.asarray(t),
                                      jnp.asarray(s)),)
        finally:
            jsim3lie._sim3_W = orig
    return port, ref, tsim3lie, 1e-5


CASES = {
    # table A, by caller and the system it solves
    "twoview_H12": _case_score_homography,
    "twoview_T2": _case_two_view_T2,
    "twoview_Kinv": _case_two_view_K,
    "twoview_sampson_gn": _case_refine_essential,
    "pose_opt": _case_pose_opt,
    "sim3_lm": _case_sim3,
    "pose_graph": _case_pose_graph,
    "local_ba_Hll": _ba_case("dense", "unseen_lm"),
    "local_ba_S": _ba_case("dense", "unseen_pose"),
    "local_ba_Dk": _ba_case("pcg", "unseen_pose"),
    "dist_ba_Hll": _dist_ba_case("dense", "unseen_lm"),
    "dist_ba_S": _dist_ba_case("dense", "unseen_pose"),
    "log_sim3_W": _case_log_sim3,
}


def _call_ref(ref, monkeypatch):
    try:
        return ref(monkeypatch)
    except TypeError:
        return ref()


@pytest.mark.parametrize("name", list(CASES))
def test_singular_input_follows_the_reference(name, monkeypatch):
    port, ref, module, atol = CASES[name](True)
    with monkeypatch.context() as mp:
        _raising(mp, module)
        with pytest.raises(torch.linalg.LinAlgError):
            port()
    tout = port()
    jout = _call_ref(ref, monkeypatch)
    if atol is None:
        _two_view_outputs_agree(tout, jout)
        assert not bool(tout["success"])
        return
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        _same(a, b, atol, rtol=atol)


def test_singular_hypothesis_in_reconstruct_two_views(monkeypatch):
    """One of the 200 homography hypotheses is exactly singular: its eight
    matches sit at (0, 0) in image 2, the masked mean, so they normalize to
    exactly 0 and the DLT gives a homography with two zero rows.  The port
    raised for the whole batch; now it scores that hypothesis as the
    reference does (its reverse transfer is non-finite, no match counts
    twice) and both recover the same model."""
    kp1, kp2, mask, K = _two_view(0)
    live = [i for i in np.nonzero(mask)[0] if i >= 25][:8]
    kp2[live] = 0.0
    kp2 = _zero_mean(kp2, mask, set(live))
    sets = _reference_sets(0, mask)
    sets[0][7] = live
    args = (_T(kp1), _T(kp2), _T(mask), _T(K))
    with monkeypatch.context() as mp:
        mp.setattr(ttwoview, "inv_nan", torch.linalg.inv)
        with pytest.raises(torch.linalg.LinAlgError):
            ttwoview.reconstruct_two_views(*args, sets=sets)
    tout = ttwoview.reconstruct_two_views(*args, sets=sets)
    jout = _reference_two_views(monkeypatch, sets, kp1, kp2, mask, K)
    _two_view_outputs_agree(tout, jout)
    assert bool(tout["success"])
    # The singular hypothesis itself: non-finite inverse, the same score.
    kp1n, T1 = ttwoview._normalize_points(args[0], args[2])
    kp2n, T2 = ttwoview._normalize_points(args[1], args[2])
    idx = torch.as_tensor(live)
    Hn = ttwoview._homography_dlt(kp1n[idx], kp2n[idx])
    H21 = torch.linalg.inv(T2) @ Hn @ T1
    assert torch.linalg.inv_ex(H21).info != 0
    jH21 = jnp.asarray(H21.numpy())[None]
    ts, ti = ttwoview._score_homography(H21[None], *args[:3], 1.0)
    js, ji = jtwoview._score_homography(jH21, *map(jnp.asarray, (kp1, kp2, mask)), 1.0)
    _same(ts, js, atol=1e-3)
    _same(ti, ji, atol=0)


def test_helpers_give_the_reference_non_finite_pattern():
    """A (2, 3, 3) batch whose second matrix has rank 2: element 0 equals
    the raising form's result bit for bit, element 1 is non-finite in both
    packages (the helpers fill it with NaN; jnp leaves some entries
    finite); a NaN input reaches ``svd_nan`` as NaN factors."""
    A = np.stack([np.array([[4, 1, 0], [1, 3, 1], [0, 1, 2]], np.float32),
                  np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], np.float32)])
    b = np.ones((2, 3, 1), np.float32)
    for t, j, ok in ((linalg_nan.inv_nan(_T(A)), jnp.linalg.inv(A),
                      torch.linalg.inv(_T(A[:1]))),
                     (linalg_nan.solve_nan(_T(A), _T(b)), jnp.linalg.solve(A, b),
                      torch.linalg.solve(_T(A[:1]), _T(b[:1])))):
        assert torch.equal(t[:1], ok)
        assert torch.isnan(t[1]).all()
        assert not np.isfinite(np.asarray(j)[1]).all()
    S = np.stack([A[0] @ A[0].T, np.diag([1.0, -1.0, 1.0]).astype(np.float32)])
    L = linalg_nan.cholesky_nan(_T(S))
    assert torch.equal(L[0], torch.linalg.cholesky(_T(S[0])))
    assert torch.isnan(L[1]).all()
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(S))[1]).all()
    U, d, Vh = linalg_nan.svd_nan(torch.stack([_T(A[0]), torch.full((3, 3), float("nan"))]))
    for f in (U, d, Vh):
        assert torch.isnan(f[1]).all() and torch.isfinite(f[0]).all()
    ju, jd, jv = jnp.linalg.svd(jnp.full((3, 3), jnp.nan))
    assert np.isnan(np.asarray(jd)).all()
    assert torch.equal(d[0], torch.linalg.svd(_T(A[0])).S)


@pytest.mark.parametrize("name", list(CASES))
def test_non_singular_input_is_bit_identical(name, monkeypatch):
    """Every caller on a non-singular input: the helpers return exactly
    what the raising forms returned."""
    port, _, module, _ = CASES[name](False)
    new = port()
    with monkeypatch.context() as mp:
        _raising(mp, module)
        old = port()
    if isinstance(new, dict):
        new, old = list(new.values()), list(old.values())
    for a, b in zip(new, old):
        assert torch.equal(a, b)
