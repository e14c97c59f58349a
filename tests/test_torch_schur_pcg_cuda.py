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
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, inertial_ba, local_ba

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


# ---------------------------------------------------------------------------
# The inertial BA's loop: 15-wide states [phi, p, v, bg, ba], the visual
# matvec on the pose slice, each state's 15x15 diagonal block and its
# coupling to the next state of a chain (ops/cuda_schur.vi_schur_pcg).

def vi_problem(dev, dtype, seed=5, **kw):
    """schur_problem's visual system (K = 64 poses) as the pose slice of
    15-wide states, plus an inertial chain over the states in a shuffled
    order (so nxt is no shift of the index): each edge a PSD block J^T J
    of a random (15, 30) J over its two states, scaled per dimension from
    1 to 1e4 as the inertial blocks' scales spread.  D = the visual Hpp_d
    on the pose slice + the edges' diagonal blocks + 1e-2 I; U the edges'
    couplings; Minv the inverses of the diagonal blocks of D less the
    visual correction (the block-Jacobi of the full system).  Poses 0 and
    1 fixed; state 0's velocity and biases frozen as well, state 1's
    free.  Built on the CPU in float64, moved to dev as dtype."""
    Hpp, bp, Hll_inv, bl, E, op, ol, fixed = schur_problem(
        torch.device("cpu"), torch.float64, **kw)
    K = Hpp.shape[0]
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    order = torch.randperm(K, generator=g)
    nxt = torch.full((K,), -1, dtype=torch.int32)
    nxt[order[:-1]] = order[1:].int()
    scale = torch.logspace(0, 4, 15, dtype=f64)
    J = torch.randn((K - 1, 15, 30), generator=g, dtype=f64)
    J = J * torch.cat([scale, scale]).sqrt()
    H = J.transpose(1, 2) @ J
    ei, ej = order[:-1], order[1:]
    D = torch.zeros((K, 15, 15), dtype=f64)
    D[:, :6, :6] = Hpp
    D.index_add_(0, ei, H[:, :15, :15])
    D.index_add_(0, ej, H[:, 15:, 15:])
    D = D + 1e-2 * torch.eye(15, dtype=f64)
    U = torch.zeros((K, 15, 15), dtype=f64)
    U[ei] = H[:, :15, 15:]
    free = torch.ones((K, 15), dtype=f64)
    free[:2, :6] = 0
    free[0] = 0
    plans = [(segment_plan(K, op), segment_plan(Hll_inv.shape[0], ol))]
    _, Dk = local_ba._schur_terms(Hpp, bp, [(Hll_inv, bl, E, op, ol)], plans,
                                  local_ba._only)
    P = D.clone()
    P[:, :6, :6] += Dk - Hpp
    P = P * free[:, :, None] * free[:, None, :] + torch.diag_embed(1 - free)
    rhs = torch.randn((K, 15), generator=g, dtype=f64) * scale.sqrt() * free
    out = dict(D=D, U=U, nxt=nxt, Minv=torch.linalg.inv(P), rhs=rhs,
               Hll_inv=Hll_inv, E=E, op=op, ol=ol, fixed=fixed, free=free)
    return {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev))
            for k, v in out.items()}


def _vi_plain(p, n_cg=N_CG):
    """The plain loop of solvers/inertial_ba on p's device."""
    K, M = p["D"].shape[0], p["Hll_inv"].shape[0]
    plans = [(segment_plan(K, p["op"]), segment_plan(M, p["ol"]))]
    shards = [(p["Hll_inv"], None, p["E"], p["op"], p["ol"])]
    return local_ba._pcg_plain(
        lambda v: inertial_ba._vi_matvec(v, p["D"], p["U"], p["nxt"],
                                         p["free"], shards, plans),
        p["Minv"], p["rhs"], n_cg)


def _vi_kernel(p, n_cg=N_CG):
    K, M = p["D"].shape[0], p["Hll_inv"].shape[0]
    idx = cuda_schur.schur_index(K, M, p["op"], p["ol"])
    return cuda_schur.vi_schur_pcg(
        p["D"], p["U"], p["nxt"], p["Hll_inv"],
        cuda_schur.landmark_planes(p["E"], idx), p["Minv"], p["rhs"],
        p["fixed"], p["free"], idx, n_cg)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-12)])
def test_vi_kernel_matches_plain_loop(dev, dtype, rtol):
    """15-wide states with an inertial chain: x within rtol of max |x| of
    the plain loop on the card, the same 60 iterations in `dtype` with
    sums in other orders.  On the CPU, reversing the observations' order
    moved the plain loop's x by up to 1.2e-7 of its scale in float32 and
    3.7e-16 in float64 (vi_problem, seeds 5-7); rtol leaves more than 800
    times that.  Leaving the chain's couplings out moves x by 0.43-0.71 of
    its scale.  Two calls give the same bits; 3 launches an iteration; frozen
    values stay exactly 0."""
    p = vi_problem(dev, dtype)
    plain = _vi_plain(p)
    before = cuda_schur.schur_pcg.launches
    x1 = _vi_kernel(p)
    torch.cuda.synchronize()
    assert cuda_schur.schur_pcg.launches - before == 3 * N_CG
    x2 = _vi_kernel(p)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2)
    scale = float(plain.abs().max())
    assert torch.isfinite(x1).all() and scale > 0
    err = float((x1 - plain).abs().max())
    assert err <= rtol * scale, (err, scale)
    assert torch.equal(x1[p["free"] == 0], torch.zeros_like(x1[p["free"] == 0]))
    uncoupled = dict(p, U=torch.zeros_like(p["U"]))
    assert float((_vi_kernel(uncoupled) - plain).abs().max()) > 0.1 * scale


def test_vi_kernel_first_step_matches_the_plain_matvec(dev):
    """One iteration from p = z with Minv = I: the kernel's first step
    equals the plain step through solvers/inertial_ba._vi_matvec, the plain
    loop's matvec, to 1e-10 of the scale in float64."""
    p = vi_problem(dev, torch.float64)
    K, M = p["D"].shape[0], p["Hll_inv"].shape[0]
    idx = cuda_schur.schur_index(K, M, p["op"], p["ol"])
    Ep = cuda_schur.landmark_planes(p["E"], idx)
    eye = torch.eye(15, dtype=torch.float64, device=dev).expand(K, 15, 15)
    rhs = p["rhs"]
    x = cuda_schur.vi_schur_pcg(p["D"], p["U"], p["nxt"], p["Hll_inv"], Ep,
                                eye.contiguous(), rhs, p["fixed"], p["free"],
                                idx, 1)
    plans = [(segment_plan(K, p["op"]), segment_plan(M, p["ol"]))]
    shards = [(p["Hll_inv"], None, p["E"], p["op"], p["ol"])]
    Ap = inertial_ba._vi_matvec(rhs, p["D"], p["U"], p["nxt"], p["free"],
                                shards, plans)
    ref = torch.sum(rhs * rhs) / torch.sum(rhs * Ap) * rhs
    assert float((x - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
