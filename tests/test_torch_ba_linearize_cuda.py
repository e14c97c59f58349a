"""K5, the global BA's reprojection pass as a CUDA kernel
(``ops/cuda_reproj.py``, ``csrc/reproj_lin.cu``), against its plain twin
and the solvers on the card.  No JAX in this file: the card's machine has
none.  ``k5_problem`` and ``k5_state`` also serve the CPU tests of
``tests/test_torch_ba_linearize.py``.

    python -m pytest -q -m gpu tests/test_torch_ba_linearize_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.cameras.camera import Camera, CameraKind
from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    ImuCalib, preintegrate_batch_scan)
from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3
from orb_slam3_study_kr_tpu_torch.ops import cuda_reproj, cuda_schur
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, robust
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
    inertial_bundle_adjust)
from test_torch_schur_pcg_cuda import _ba_problem

pytestmark = pytest.mark.gpu

BF = 50.45      # fx * baseline, EuRoC's Camera.bf
PAD = 8191      # a bucketed map's padding, at its largest
# The rig's camera <- body extrinsic of the body parametrisation.
R_CB = exp_so3(torch.tensor([0.02, -0.05, 0.03], dtype=torch.float64)).numpy()
T_CB = np.array([0.02, -0.06, 0.01])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda", 0)


def k5_problem(K=24, M=3000, track=6, seed=3, pad=0, stereo=True):
    """``_ba_problem`` (poses 0 and 1 fixed, landmark 5 masked, every 64th
    landmark seen once, the last pose unobserved) with what K5 must also
    handle: a right coordinate on about 55 % of the observations (bf
    ``BF``), the others mono; landmark 7 behind its cameras (z < 0),
    landmark 8 0.5 mm in front of its first camera (under the 1e-3
    cheirality); ``pad``
    masked rows of pose 0 and landmark 0 appended, as a bucketed map pads
    its observations.  Returns the camera parameters, bundle_adjust's
    arrays (numpy) and the right coordinates (-1: mono)."""
    params, arrays = _ba_problem(K, M, track, seed)
    R, t, fixed, X, lm_mask, op, ol, uv, level, mask = arrays
    X = X.copy()
    for m, pc in ((7, (0.1, -0.2, -3.0)), (8, (0.1, 0.1, 5e-4))):
        k = op[ol == m][0]               # placed in its first camera
        X[m] = R[k].T @ (np.asarray(pc, np.float32) - t[k])
    rng = np.random.default_rng(seed + 100)
    pc = np.einsum("nab,nb->na", R[op], X[ol]) + t[op]
    z = np.maximum(pc[:, 2], 1e-6)
    ur = uv[:, 0] - BF / z + rng.normal(0, 0.5, z.shape)
    ur = np.where(rng.random(z.shape) < 0.55, ur, -1.0).astype(np.float32)
    if not stereo:
        ur[:] = -1.0
    arrays = (R, t, fixed, X, lm_mask, op, ol, uv, level, mask)
    if pad:
        fill = (0, 0, 0.0, 0, 0.0)       # pose, landmark, uv, level, mask
        arrays = arrays[:5] + tuple(
            np.concatenate([a, np.full((pad, *a.shape[1:]), f, a.dtype)])
            for a, f in zip(arrays[5:], fill))
        ur = np.concatenate([ur, np.full(pad, -1.0, np.float32)])
    return params, arrays, ur


def to_body(R, t):
    """Camera poses (R_cw, t_cw) as body states (R_wb, p_wb) through the
    rig's (R_CB, T_CB): R_wb = R_cw^T R_cb, p_wb = R_cw^T (t_cb - t_cw)."""
    R = R.astype(np.float64)
    R_wb = np.einsum("kba,bc->kac", R, R_CB)
    p_wb = np.einsum("kba,kb->ka", R, T_CB[None] - t)
    return R_wb.astype(np.float32), p_wb.astype(np.float32)


def k5_state(problem, dev, dtype=torch.float32, body=False, huber=True):
    """(state, R, t, X) of K5 on ``problem`` (``k5_problem``'s) on dev in
    dtype: the solve's ``Reproj`` as the solvers build it and the poses in
    the parametrisation's form."""
    params, arrays, ur = problem
    R, t, fixed, X, lm_mask, op, ol, uv, level, mask = arrays
    if body:
        R, t = to_body(R, t)
    T = lambda a: torch.as_tensor(a, device=dev)            # noqa: E731
    F = lambda a: torch.as_tensor(a, device=dev, dtype=dtype)  # noqa: E731
    K, M = R.shape[0], X.shape[0]
    op_t, ol_t = T(op).long(), T(ol).long()
    index = cuda_schur.schur_index(K, M, op_t, ol_t, obs_mask=T(mask))
    cam = Camera(params.to(dev), CameraKind.PINHOLE)
    ext = ((F(R_CB.astype(np.float32)), F(T_CB.astype(np.float32))) if body
           else None)
    s = cuda_reproj.setup(cam, index, op_t, ol_t, F(uv),
                          robust.octave_inv_sigma2(T(level)), F(mask),
                          F(lm_mask), F(fixed), obs_ur=F(ur), bf=BF,
                          extrinsic=ext, use_huber=huber)
    return s, F(R), F(t), F(X)


def _live(s):
    return int(s.index.lm_off[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("body", [False, True], ids=["T_cw", "body"])
@pytest.mark.parametrize("huber", [True, False], ids=["huber", "l2"])
def test_kernel_gives_the_twins_bits(dev, dtype, body, huber):
    """The linearize and cost passes on the card give the plain twin's bits
    on the card: each of the twin's operations rounds as one of the
    kernel's steps and its sums run in the kernel's order.  Mono and
    stereo rows, the padding, fixed poses, a masked landmark and points
    behind the camera; two launches give the same bits; each pass counts
    one launch."""
    s, R, t, X = k5_state(k5_problem(pad=PAD), dev, dtype, body, huber)
    L = _live(s)
    ix = s.index
    n0 = (cuda_reproj.linearize.launches, cuda_reproj.cost.launches)
    got = cuda_reproj.linearize(s, R, t, X)
    got = [g.clone() for g in got]
    again = cuda_reproj.linearize(s, R, t, X)
    c, chi2 = cuda_reproj.cost(s, R, t, X, chi2=True)
    c2 = cuda_reproj.cost(s, R, t, X)
    torch.cuda.synchronize()
    assert (cuda_reproj.linearize.launches - n0[0],
            cuda_reproj.cost.launches - n0[1]) == (2, 2)
    twin = cuda_reproj.linearize_plain(
        s.cam, s.rec, ix.lm_off, ix.pose_pos, ix.pose_off, R, t, X,
        s.lm_mask, s.free, body, huber)
    c_p, chi2_p = cuda_reproj.cost_plain(s.cam, s.rec, R, t, X, s.lm_mask,
                                         body, huber)
    names = ("Hpp", "bp", "Hll", "bl", "E")
    for name, a, b, r in zip(names, got, twin, again):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
        assert torch.equal(a, r), name
    assert torch.equal(got[5][:, :L], twin[5][:, :L])
    assert torch.equal(got[5][:, :L].t(), got[4].reshape(-1, 18)[
        ix.lm_perm[:L]])
    assert torch.equal(c, c_p) and torch.equal(c, c2), (float(c), float(c_p))
    assert torch.equal(chi2, chi2_p)
    # The fixed poses' blocks and the masked landmark's are exactly 0, and
    # so are the padding's E rows and the points behind the camera's.
    assert not got[0][:2].any() and not got[1][:2].any()
    assert not got[2][5].any() and not got[3][5].any()
    assert not got[4][-PAD:].any()
    assert got[0][2:-1].abs().amax(dim=(1, 2)).min() > 0


def _solve(problem, dev, camera, n_iters=4, **kw):
    params, arrays, ur = problem
    p = params.to(dev)
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    return bundle_adjust(functools.partial(pinhole.project, p),
                         functools.partial(pinhole.project_jac, p), *args,
                         assembly="pcg", n_iters=n_iters,
                         obs_ur=torch.as_tensor(ur, device=dev), bf=BF,
                         camera=camera, **kw)


def test_bundle_adjust_through_k5_matches_the_cpu(dev):
    """bundle_adjust(assembly="pcg") on the card with its camera, 4 LM
    steps through K5 and K4, against the CPU's einsum path: the bars are
    those of K4's test of the same solve; one linearize pass an LM step and
    a cost pass at the start, after each step and at the end; two solves
    give the same bits."""
    problem = k5_problem(pad=PAD)
    cam = Camera(problem[0].to(dev), CameraKind.PINHOLE)
    cpu = _solve(problem, torch.device("cpu"), None)
    n0 = (cuda_reproj.linearize.launches, cuda_reproj.cost.launches)
    card = [o.cpu() for o in _solve(problem, dev, cam)]
    again = [o.cpu() for o in _solve(problem, dev, cam)]
    assert (cuda_reproj.linearize.launches - n0[0],
            cuda_reproj.cost.launches - n0[1]) == (2 * 4, 2 * (4 + 2))
    for a, b in zip(card, again):
        assert torch.equal(a, b)
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(), atol=3e-4)
    np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(), atol=3e-3)
    np.testing.assert_allclose(card[2].numpy(), cpu[2].numpy(), atol=1e-2)
    assert abs(float(card[4]) - float(cpu[4])) <= 5e-6 * float(cpu[4])
    _chi2_is_the_states(problem, card[0], card[1], card[2], card[3])


def _chi2_is_the_states(problem, R, t, X, chi2):
    """chi2, which decides the cull, is that of the returned state: the
    CPU's einsum pass there gives it within float32 rounding (a residual
    of a few pixels and its square rounded apart)."""
    params, arrays, ur = problem
    at = (R.numpy(), t.numpy(), arrays[2], X.numpy()) + arrays[4:]
    ref = _solve((params, at, ur), torch.device("cpu"), None, n_iters=0)[3]
    live = arrays[-1] > 0
    np.testing.assert_allclose(chi2.numpy()[live], ref.numpy()[live],
                               rtol=1e-4, atol=1e-5)


def vi_chain(problem, dev):
    """The body states of ``problem`` and an inertial chain over its K
    poses in index order: intervals of 20 rows at 200 Hz whose gyro and
    accelerometer rows follow the states' relative rotations and
    displacements, so the inertial edges hold; zero biases; the problem's
    fixed poses, every velocity and bias free.  Returns
    inertial_bundle_adjust's positional arguments after project_jac_fn."""
    params, arrays, ur = problem
    R, t, fixed, X, lm_mask, op, ol, uv, level, mask = arrays
    R_wb, p_wb = to_body(R, t)
    K, n, dt = R.shape[0], 20, 0.005
    T = 0.1
    v = np.zeros((K, 3), np.float32)
    v[:-1] = (p_wb[1:] - p_wb[:-1]) / T
    v[-1] = v[-2]
    rows = np.zeros((K - 1, n, 7), np.float32)
    rows[..., 0] = dt
    from orb_slam3_study_kr_tpu_torch.lie.so3 import log_so3
    rel = torch.as_tensor(np.einsum("kba,kbc->kac", R_wb[:-1], R_wb[1:]))
    rows[..., 4:7] = (log_so3(rel).numpy() / T)[:, None, :]
    a_w = np.zeros((K - 1, 3))
    a_w[:-1] = (v[1:-1] - v[:-2]) / T
    f_w = a_w + np.array([0.0, 0.0, 9.81])
    rows[..., 1:4] = np.einsum("kba,kb->ka", R_wb[:-1], f_w)[:, None, :]
    calib = ImuCalib.make(device=dev)
    r = torch.as_tensor(rows, device=dev)
    pre = preintegrate_batch_scan(
        r[..., 1:4], r[..., 4:7], r[..., 0], torch.ones((K - 1, n), device=dev),
        torch.zeros((K - 1, 6), device=dev), calib)
    D = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
    return (D(R_wb), D(p_wb), D(v), torch.zeros((K, 6), device=dev), D(fixed),
            D(R_CB.astype(np.float32)), D(T_CB.astype(np.float32)), D(X),
            D(lm_mask), D(op), D(ol), D(uv), D(level), D(mask),
            torch.arange(K - 1, device=dev), torch.arange(1, K, device=dev),
            pre, torch.ones(K - 1, device=dev))


def vi_solve(problem, dev, camera, n_iters=3, state=None):
    """inertial_bundle_adjust(assembly="pcg") on vi_chain's arguments;
    ``state`` (R_wb, p_wb, v, bias, X) replaces the starting states."""
    params, _, ur = problem
    p = params.to(dev)
    K = problem[1][0].shape[0]
    args = list(vi_chain(problem, dev))
    if state is not None:
        args[0:4] = [a.to(dev) for a in state[:4]]
        args[7] = state[4].to(dev)
    return inertial_bundle_adjust(
        functools.partial(pinhole.project, p),
        functools.partial(pinhole.project_jac, p), *args,
        n_iters=n_iters, fixed_vb=torch.zeros(K, device=dev),
        assembly="pcg", obs_ur=torch.as_tensor(ur, device=dev), bf=BF,
        camera=camera)


def test_inertial_bundle_adjust_through_k5_matches_the_cpu(dev):
    """inertial_bundle_adjust(assembly="pcg") on the card with its camera,
    3 LM steps through K5 (body parametrisation) and the 15-wide K4,
    against the CPU's einsum path; the launches as in the visual solve; two
    solves give the same bits."""
    problem = k5_problem(pad=PAD)
    cam = Camera(problem[0].to(dev), CameraKind.PINHOLE)
    cpu = vi_solve(problem, torch.device("cpu"), None)
    n0 = (cuda_reproj.linearize.launches, cuda_reproj.cost.launches)
    card = [o.cpu() for o in vi_solve(problem, dev, cam)]
    again = [o.cpu() for o in vi_solve(problem, dev, cam)]
    assert (cuda_reproj.linearize.launches - n0[0],
            cuda_reproj.cost.launches - n0[1]) == (2 * 3, 2 * (3 + 2))
    for a, b in zip(card, again):
        assert torch.equal(a, b)
    for i, atol in ((0, 3e-4), (1, 3e-3), (2, 3e-3), (3, 1e-3), (4, 1e-2)):
        np.testing.assert_allclose(card[i].numpy(), cpu[i].numpy(),
                                   atol=atol)
    assert abs(float(card[6]) - float(cpu[6])) <= 1e-5 * float(cpu[6])
    # chi2 is that of the returned state, as the CPU's einsum pass gives
    # it there.  The body chain (q = R_wb^T (X - p_wb), then R_cb q + t_cb)
    # cancels metre-scale coordinates, and the two passes round it in
    # other orders: at this problem's start (seeds 3-5, CPU) their chi2
    # differ by up to 4.8e-4 of each value, 7.5e-4 on the card after 3
    # steps; a wrong residual row moves chi2 by its whole size.
    ref = vi_solve(problem, torch.device("cpu"), None, n_iters=0,
                   state=card[:5])[5]
    live = problem[1][-1] > 0
    np.testing.assert_allclose(card[5].numpy()[live], ref.numpy()[live],
                               rtol=2e-3, atol=1e-4)
