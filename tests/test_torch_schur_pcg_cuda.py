"""K4, the global BA's PCG loop as CUDA kernels (``ops/cuda_schur.py``,
``csrc/schur_pcg.cu``), against the plain loop of
``solvers/local_ba._schur_pcg`` on the card.  No JAX in this file: the
card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_schur_pcg_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3
from orb_slam3_study_kr_tpu_torch.ops import cuda_schur
from orb_slam3_study_kr_tpu_torch.ops.segment import segment_plan
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, local_ba

pytestmark = pytest.mark.gpu

N_CG = 60


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda", 0)


def _ba_problem(K=24, M=3000, track=6, seed=3):
    """A small mono PCG bundle adjustment: K poses along x, landmarks each
    seen by `track` consecutive poses, 0.5 px noise; poses 0 and 1 fixed;
    pose K - 1 seen by no landmark; every 64th landmark seen once; landmark
    5 masked (lm_mask 0, so its Hll_inv is zero).  Returns the camera
    parameters and bundle_adjust's arrays, as numpy."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 3] = -0.2 * np.arange(K)
    xi[:, 1] = 0.01 * np.arange(K)
    R, t = (a.numpy() for a in exp_se3(torch.as_tensor(xi)))
    X = np.stack([rng.uniform(-3, 0.2 * K + 3, M), rng.uniform(-2, 2, M),
                  rng.uniform(4, 10, M)], -1).astype(np.float32)
    params = torch.tensor([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0])
    first = np.clip(((X[:, 0] + 1) / 0.2).astype(int) - track // 2, 0,
                    K - 1 - track)
    op = (first[:, None] + np.arange(track)).reshape(-1)
    ol = np.repeat(np.arange(M), track)
    keep = (ol % 64 != 0) | (op == first[ol])
    op, ol = op[keep], ol[keep]
    pc = np.einsum("nab,nb->na", R[op], X[ol]) + t[op]
    uv = pinhole.project(params, torch.as_tensor(pc)).numpy()
    uv = uv + rng.normal(0, 0.5, uv.shape)
    t_noisy = t + rng.normal(0, 0.02, t.shape).astype(np.float32)
    t_noisy[:2] = t[:2]
    fixed = np.zeros(K, np.float32)
    fixed[:2] = 1
    X_noisy = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    lm_mask = np.ones(M, np.float32)
    lm_mask[5] = 0
    arrays = (R, t_noisy.astype(np.float32), fixed, X_noisy, lm_mask,
              op.astype(np.int32), ol.astype(np.int32), uv.astype(np.float32),
              rng.integers(0, 3, op.size).astype(np.int32),
              np.ones(op.size, np.float32))
    return params, arrays


def _ba(params, arrays, dev, **kw):
    p = params.to(dev)
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    return bundle_adjust(functools.partial(pinhole.project, p),
                         functools.partial(pinhole.project_jac, p), *args,
                         assembly="pcg", **kw)


def schur_problem(dev, dtype, K=64, M=4096, track=8, lam=1e-2):
    """The reduced camera system of the first LM step of _ba_problem(K, M,
    track) at damping lam, taken on the CPU in float32: _schur_pcg's
    arguments but the plans, moved to dev as dtype.  CG works on it through
    all 60 iterations (r . z falls by 1e-15, never to the 1e-20 guard).  At
    lam 1e-4 its float32 CG turns chaotic: reordering the observations
    moves x by 10 times its scale (CPU, plain loop)."""
    got = []

    def record(*a, **kw):
        got.append(a[:8])
        return torch.zeros_like(a[1])

    orig = local_ba._schur_pcg
    local_ba._schur_pcg = record
    try:
        _ba(*_ba_problem(K, M, track), torch.device("cpu"), n_iters=1,
            init_lambda=lam)
    finally:
        local_ba._schur_pcg = orig
    return tuple(a.to(dev, dtype) if a.is_floating_point() else a.to(dev)
                 for a in got[0])


def _solve(args, fused):
    Hpp, bp, Hll_inv, bl, E, op, ol, fixed = args
    K, M = Hpp.shape[0], Hll_inv.shape[0]
    plans = [(segment_plan(K, op), segment_plan(M, ol))]
    if fused:
        return local_ba._schur_pcg(Hpp, bp, Hll_inv, bl, E, op, ol, fixed,
                                   N_CG, plans, index=cuda_schur.schur_index(
                                       K, M, op, ol, *plans[0]))
    # One shard through psum: the plain loop on the card.
    return local_ba._schur_pcg(Hpp, bp, [Hll_inv], [bl], [E], [op], [ol],
                               fixed, N_CG, plans, psum_fn=local_ba._only)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-3),
                                        (torch.float64, 1e-10)])
def test_kernel_matches_plain_loop(dev, dtype, rtol):
    """x within rtol of max |x| of the plain loop on the card: both run the
    same 60 iterations in `dtype`, their sums in other orders (and the
    kernel's fused multiply-adds) round apart, and CG carries the rounding
    through.  Reordering the observations moved the plain loop's x by up
    to 6.1e-5 of its scale in float32 and 4.7e-14 in float64 (three orders,
    CPU); rtol leaves 16 and 2000 times that.  A dropped term moves x by
    its whole scale.  Two calls give the same bits; one call launches 3
    kernels an iteration."""
    args = schur_problem(dev, dtype)
    plain = _solve(args, fused=False)
    before = cuda_schur.schur_pcg.launches
    x1 = _solve(args, fused=True)
    torch.cuda.synchronize()
    assert cuda_schur.schur_pcg.launches - before == 3 * N_CG
    x2 = _solve(args, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2)
    assert torch.isfinite(x1).all()
    scale = float(plain.abs().max())
    assert scale > 0
    err = float((x1 - plain).abs().max())
    assert err <= rtol * scale, (err, scale)
    # The fixed poses and the pose without observations stay where the
    # plain loop leaves them: fixed rows exactly 0.
    assert torch.equal(x1[:2], torch.zeros_like(x1[:2]))


def test_kernel_matvec_matches_index_plain(dev):
    """One iteration from p = z with Minv = I: the kernel's first step
    equals the plain step built from the kernel's own index arrays
    (schur_matvec_plain).  Float64: Ap = Hpp_d w - u2 cancels most of its
    terms on this system, which float32 rounding does not survive to a
    tight bar; in float64 the two agree to 1e-10 of the scale."""
    Hpp, bp, Hll_inv, bl, E, op, ol, fixed = schur_problem(dev, torch.float64)
    K, M = Hpp.shape[0], Hll_inv.shape[0]
    idx = cuda_schur.schur_index(K, M, op, ol)
    Ep = cuda_schur.landmark_planes(E, idx)
    Minv = torch.eye(6, dtype=Hpp.dtype, device=dev).expand(K, 6, 6).contiguous()
    rhs = bp * (1 - fixed)[:, None]
    x = cuda_schur.schur_pcg(Hpp, Hll_inv, Ep, Minv, rhs, fixed, idx, 1)
    Ap = cuda_schur.schur_matvec_plain(rhs, Hpp, Hll_inv, Ep, fixed, idx)
    ref = torch.sum(rhs * rhs) / torch.sum(rhs * Ap) * rhs
    assert float((x - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


def test_kernel_keeps_padding_out(dev):
    """A bucketed map's padding (observations of pose 0 and landmark 0 with
    mask 0, appended up to a bucket) does not reach the kernel: on the same
    system, the kernel over the padded observations with the mask gives
    the bits of the kernel over the live ones alone, with NaN E blocks in
    the padding (which any read would spread to x)."""
    Hpp, bp, Hll_inv, bl, E, op, ol, fixed = schur_problem(dev, torch.float32)
    K, M, O = Hpp.shape[0], Hll_inv.shape[0], op.numel()
    pad = 8191
    op_p = torch.cat([op, torch.zeros(pad, dtype=op.dtype, device=dev)])
    ol_p = torch.cat([ol, torch.zeros(pad, dtype=ol.dtype, device=dev)])
    E_p = torch.cat([E, torch.full((pad, 6, 3), float("nan"),
                                   dtype=E.dtype, device=dev)])
    mask = torch.cat([torch.ones(O, device=dev), torch.zeros(pad, device=dev)])
    plans = [(segment_plan(K, op), segment_plan(M, ol))]
    rhs, Minv = local_ba._pcg_setup(Hpp, bp, fixed, [(Hll_inv, bl, E, op, ol)],
                                    plans, local_ba._only)
    live = cuda_schur.schur_index(K, M, op, ol)
    padded = cuda_schur.schur_index(K, M, op_p, ol_p, obs_mask=mask)
    x = cuda_schur.schur_pcg(Hpp, Hll_inv, cuda_schur.landmark_planes(E, live),
                             Minv, rhs, fixed, live, N_CG)
    x_p = cuda_schur.schur_pcg(Hpp, Hll_inv,
                               cuda_schur.landmark_planes(E_p, padded), Minv,
                               rhs, fixed, padded, N_CG)
    assert torch.isfinite(x).all() and float(x.abs().max()) > 0
    assert torch.equal(x, x_p)


def test_bundle_adjust_pcg_on_the_card_matches_the_cpu(dev):
    """bundle_adjust(assembly="pcg"), 6 LM iterations: the card (through
    the kernel, 3 launches per CG iteration) against the CPU's plain loop.
    Reordering the observations moved the CPU's own result by up to 3.0e-5
    in R, 2.6e-4 in t, 7.3e-4 in X and 5.3e-7 of the cost (three orders):
    float32 rounding through LM and CG.  The bars are about ten times that,
    against start errors of 0.02 in t and 0.05 in X."""
    _card_matches_cpu(*_ba_problem(), dev)


def test_bundle_adjust_pcg_padded_on_the_card_matches_the_cpu(dev):
    """As above on the observations padded as a bucketed map pads them:
    8,191 rows of pose 0 and landmark 0 with mask 0 appended, which the
    card's index keeps out of the kernel and the CPU adds as zero blocks."""
    params, arrays = _ba_problem()
    pad = 8191
    fill = (0, 0, 0.0, 0, 0.0)           # pose, landmark, uv, level, mask
    padded = arrays[:5] + tuple(
        np.concatenate([a, np.full((pad, *a.shape[1:]), f, a.dtype)])
        for a, f in zip(arrays[5:], fill))
    _card_matches_cpu(params, padded, dev)


def _card_matches_cpu(params, arrays, dev):
    cpu = _ba(params, arrays, torch.device("cpu"), n_iters=6)
    before = cuda_schur.schur_pcg.launches
    card = [o.cpu() for o in _ba(params, arrays, dev, n_iters=6)]
    assert cuda_schur.schur_pcg.launches - before == 6 * 3 * N_CG
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(), atol=3e-4)
    np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(), atol=3e-3)
    np.testing.assert_allclose(card[2].numpy(), cpu[2].numpy(), atol=1e-2)
    assert abs(float(card[4]) - float(cpu[4])) <= 5e-6 * float(cpu[4])
