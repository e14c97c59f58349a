"""Plain reference of the global BA: Levenberg-Marquardt over every
keyframe pose and landmark, landmarks eliminated by the Schur complement,
the reduced camera system solved by block-Jacobi preconditioned conjugate
gradients; then the loop closer's culling.

It follows the algorithm the configuration states (ORB-SLAM3's global BA
with g2o's Huber edges, ``Optimizer::GlobalBundleAdjustemnt``, as the
reference package writes it as LM): the reprojection edge
r = pi(R X + t) - uv per observation, with the right-image row
u - bf / z - u_r where the observation has one; information
1.2^(-2 level); Huber with delta^2 = the chi2 gate (5.991 mono, 7.815
stereo); the two oldest keyframes fixed; lambda from 1e-4, halved on an
accepted step and quadrupled on a rejected one, within [1e-7, 1e3]; a
left-multiplied SE(3) update; 60 PCG iterations per LM iteration.  After
the solve an observation whose chi2 exceeds its gate is unbound, and a
landmark left with fewer than two observations is removed.

Sums are plain ``index_add_``; ``dtype`` sets the arithmetic: float64
for the reference, bfloat16 for the control (whose 3x3 and 6x6 inverses,
which bfloat16 lacks, run in float32 and are rounded back).
"""

import numpy as np
import torch

CHI2_MONO, CHI2_STEREO = 5.991, 7.815


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp_se3(xi):
    """(..., 6) [phi, rho] -> (R, t): Rodrigues, t = J_l(phi) rho."""
    phi, rho = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(phi * phi, -1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (
        th * th * th))
    W = _hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, torch.einsum("...ij,...j->...i", V, rho)


def _inv(A):
    Ai, info = torch.linalg.inv_ex(A if A.dtype in (torch.float32,
                                                    torch.float64)
                                   else A.float())
    Ai = Ai.to(A.dtype)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(Ai, float("nan")), Ai)


def _sum(n, idx, x):
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def solve(R, t, fixed, X, op, ol, uv, level, ur, intr, bf, n_iters=10,
          n_cg=60, init_lambda=1e-4, dtype=torch.float64):
    """Returns (R, t, X, chi2 per observation) as numpy float64."""
    dev = R.device
    f = dict(dtype=dtype, device=dev)
    R, t, fixed, X, uv, ur = (a.to(dtype) for a in (R, t, fixed, X, uv, ur))
    op, ol = op.long(), ol.long()
    K, M = R.shape[0], X.shape[0]
    fx, fy, cx, cy = intr
    bf = torch.tensor(bf, **f)
    info = torch.pow(torch.tensor(1.2, **f), -2.0 * level.to(dtype))
    has_ur = (ur >= 0).to(dtype)
    gate = torch.where(ur >= 0, torch.tensor(CHI2_STEREO, **f),
                       torch.tensor(CHI2_MONO, **f))
    delta = torch.sqrt(gate)

    def compute(R, t, X):
        Ro = R[op]
        p = torch.einsum("oij,oj->oi", Ro, X[ol]) + t[op]
        z = torch.clamp(p[:, 2], min=1e-6)
        u = fx * p[:, 0] / z + cx
        v = fy * p[:, 1] / z + cy
        r3 = (u - bf / z - ur) * has_ur
        r = torch.stack([u - uv[:, 0], v - uv[:, 1], r3], -1)
        zero = torch.zeros_like(z)
        Ju = torch.stack([fx / z, zero, -fx * p[:, 0] / (z * z)], -1)
        Jv = torch.stack([zero, fy / z, -fy * p[:, 1] / (z * z)], -1)
        J3 = (Ju + torch.stack([zero, zero, bf / (z * z)], -1)) * has_ur[:,
                                                                         None]
        Jp = torch.stack([Ju, Jv, J3], -2)                    # (O, 3, 3)
        J_pose = torch.cat([Jp @ -_hat(p), Jp], -1)           # (O, 3, 6)
        J_point = Jp @ Ro                                     # (O, 3, 3)
        chi2 = torch.sum(r * r, -1) * info
        valid = (p[:, 2] > 1e-3).to(dtype)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = info * valid * torch.where(s <= delta, torch.ones_like(s),
                                       delta / s)
        rho = torch.where(chi2 <= gate, chi2, 2 * delta * s - gate)
        return r, J_pose, J_point, w, chi2, torch.sum(rho * valid)

    free = 1.0 - fixed
    freeK = free[:, None]
    eye3 = torch.eye(3, **f)
    eye6 = torch.eye(6, **f)
    lam = torch.tensor(init_lambda, **f)
    cost = compute(R, t, X)[5]
    for _ in range(n_iters):
        r, Jc, Jl, w, _, _ = compute(R, t, X)
        Jc = Jc * free[op][:, None, None]
        Hpp = _sum(K, op, torch.einsum("nia,n,nib->nab", Jc, w, Jc))
        bp = _sum(K, op, torch.einsum("nia,n,ni->na", Jc, w, r))
        Hll = _sum(M, ol, torch.einsum("nia,n,nib->nab", Jl, w, Jl))
        bl = _sum(M, ol, torch.einsum("nia,n,ni->na", Jl, w, r))
        E = torch.einsum("nia,n,nib->nab", Jc, w, Jl)
        Hll_d = Hll + lam * (eye3 + eye3 * Hll * eye3)
        Hpp_d = Hpp + lam * (eye6 + eye6 * Hpp * eye6)
        Hli = _inv(Hll_d)
        # Reduced camera system S = Hpp_d - E Hll^-1 E^T, matrix-free.
        Y = torch.einsum("nab,nbc->nac", E, Hli[ol])
        rhs = -(bp - _sum(K, op, torch.einsum("nab,nb->na", Y, bl[ol])))
        rhs = rhs * freeK
        D = Hpp_d - _sum(K, op, torch.einsum("nab,ncb->nac", Y, E))
        D = D * freeK[..., None] + eye6 * fixed[:, None, None]
        Minv = _inv(D)

        def matvec(x):
            x = x * freeK
            tv = _sum(M, ol, torch.einsum("nab,na->nb", E, x[op]))
            zl = torch.einsum("mab,mb->ma", Hli, tv)
            u2 = _sum(K, op, torch.einsum("nab,nb->na", E, zl[ol]))
            return (torch.einsum("kab,kb->ka", Hpp_d, x) - u2) * freeK

        dp = torch.zeros((K, 6), **f)
        res = rhs
        zv = torch.einsum("kab,kb->ka", Minv, res)
        pv = zv
        rz = torch.sum(res * zv)
        zero = torch.zeros((), **f)
        for _ in range(n_cg):
            Ap = matvec(pv)
            den = torch.sum(pv * Ap)
            alpha = torch.where(torch.abs(den) > 1e-20, rz / den, zero)
            dp = dp + alpha * pv
            res = res - alpha * Ap
            zv = torch.einsum("kab,kb->ka", Minv, res)
            rz_new = torch.sum(res * zv)
            beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
            pv = zv + beta * pv
            rz = rz_new
        Wtdp = _sum(M, ol, torch.einsum("nab,na->nb", E, dp[op]))
        dl = -torch.einsum("mab,mb->ma", Hli, bl + Wtdp)
        dR, dt = exp_se3(dp)
        R_new = dR @ R
        t_new = torch.einsum("kij,kj->ki", dR, t) + dt
        X_new = X + dl
        cost_new = compute(R_new, t_new, X_new)[5]
        ok = cost_new < cost
        R = torch.where(ok, R_new, R)
        t = torch.where(ok, t_new, t)
        X = torch.where(ok, X_new, X)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e3))
        cost = torch.where(ok, cost_new, cost)
    chi2 = compute(R, t, X)[4]
    return tuple(a.double().cpu().numpy() for a in (R, t, X, chi2))


def culled(chi2, ur, obs_lm, n_lm):
    """(observations unbound, landmarks removed) by the loop closer's rule:
    chi2 above the edge's gate unbinds it; fewer than two remaining
    observations remove the landmark."""
    gate = np.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    bad = chi2 > gate
    count = np.bincount(obs_lm[~bad], minlength=n_lm)
    return bad, count < 2


def centres(R, t):
    return -np.einsum("kji,kj->ki", R, t)
