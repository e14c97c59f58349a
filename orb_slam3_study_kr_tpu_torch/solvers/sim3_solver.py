"""Sim3 estimation between matched 3-D point sets: batched Horn closed form
inside RANSAC plus reprojection-gated inliers, and the OptimizeSim3
reprojection refinement.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/sim3_solver.py`` (replaces
src/Sim3Solver.cc): all T minimal 3-point sets solve in one batched Horn
and score against all matches at once.  The caller passes the RANSAC
uniforms, as in ``solvers/pnp.py``.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import solve_nan
from orb_slam3_study_kr_tpu_torch.solvers.pnp import minimal_sets
from orb_slam3_study_kr_tpu_torch.solvers.pose_graph import forward_jacobian


def horn_sim3(P, Q, w=None, fix_scale=False):
    """Closed-form similarity Q ~ s R P + t for point sets (..., N, 3):
    Horn 1987 via SVD of the weighted correlation, scale from the
    symmetric ratio."""
    if w is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    muP = torch.sum(P * w[..., None], dim=-2) / wsum
    muQ = torch.sum(Q * w[..., None], dim=-2) / wsum
    Pc = (P - muP[..., None, :]) * w[..., None]
    Qc = (Q - muQ[..., None, :]) * w[..., None]
    W = torch.einsum("...ni,...nj->...ij", Qc, Pc)
    U, S, Vt = torch.linalg.svd(W)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones(P.shape[:-2], dtype=P.dtype, device=P.device)
    else:
        num = torch.sum(S * D, dim=-1)
        den = torch.sum(Pc * Pc, dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = muQ - s[..., None] * torch.einsum("...ij,...j->...i", R, muP)
    return R, t, s


def _pinhole(K):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def project(p):
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)
    return project


def ransac_sim3(P1, P2, mask, uv1, uv2, K, uniforms, chi2_th=9.21,
                fix_scale=False, project_fn=None):
    """Sim3 S12 aligning landmark sets of two keyframes (P2 -> P1 frame).

    P1, P2 (N, 3) matched landmarks in each keyframe's camera frame; mask
    (N,) valid matches; uv1, uv2 (N, 2) their keypoints; uniforms (iters,
    N) the RANSAC draws; project_fn the camera projection (ideal pinhole
    from K when None); chi2_th the two-sided reprojection gate.  Returns
    dict(R12, t12, s12, inliers, n_inliers, success) as tensors."""
    sets = minimal_sets(torch.as_tensor(uniforms, dtype=P1.dtype,
                                        device=P1.device), mask, 3)
    R_h, t_h, s_h = horn_sim3(P2[sets], P1[sets], fix_scale=fix_scale)
    project = _pinhole(K) if project_fn is None else project_fn

    # Score: P2 through S12 into image 1 and P1 through S21 into image 2.
    P2in1 = (s_h[:, None, None] * torch.einsum("tij,nj->tni", R_h, P2)
             + t_h[:, None, :])
    e1 = torch.sum((project(P2in1) - uv1[None]) ** 2, -1)
    R_inv = R_h.transpose(-1, -2)
    s_inv = 1.0 / s_h
    t_inv = -s_inv[:, None] * torch.einsum("tij,tj->ti", R_inv, t_h)
    P1in2 = (s_inv[:, None, None] * torch.einsum("tij,nj->tni", R_inv, P1)
             + t_inv[:, None, :])
    e2 = torch.sum((project(P1in2) - uv2[None]) ** 2, -1)
    inl = (e1 < chi2_th) & (e2 < chi2_th) & (mask[None] > 0)
    best = torch.argmax(inl.sum(dim=1))

    # Refit on the best hypothesis' inliers.
    w = inl[best].to(P1.dtype)
    R_f, t_f, s_f = horn_sim3(P2, P1, w=w, fix_scale=fix_scale)
    e1 = torch.sum((project(s_f * P2 @ R_f.T + t_f) - uv1) ** 2, -1)
    R_b = R_f.T
    s_b = 1.0 / s_f
    t_b = -s_b * R_b @ t_f
    e2 = torch.sum((project(s_b * P1 @ R_b.T + t_b) - uv2) ** 2, -1)
    inl_f = (e1 < chi2_th) & (e2 < chi2_th) & (mask > 0)
    n_inl = inl_f.sum()
    return dict(R12=R_f, t12=t_f, s12=s_f, inliers=inl_f, n_inliers=n_inl,
                success=n_inl >= 20)


def optimize_sim3(P1, P2, mask, uv1, uv2, K, R12, t12, s12, n_iters=10,
                  chi2_th=10.0, fix_scale=False, damping=1e-4, project_fn=None):
    """GN refinement of a Sim3 on two-sided reprojection residuals
    (Optimizer::OptimizeSim3): P2 through S12 into image 1 and P1 through
    S12^-1 into image 2, Huber(sqrt(10)), over [omega, upsilon, log_s]
    right-increments; two rounds with a hard chi2 > 10 cull between them.
    The Jacobian is forward-mode autodiff (``forward_jacobian``), as the
    reference's jax.jacfwd.  Returns dict(R12, t12, s12, inliers,
    n_inliers) as tensors."""
    project = _pinhole(K) if project_fn is None else project_fn
    dt, dev = P1.dtype, P1.device
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def unpack(x):
        # Slices keep a length-1 axis: a 0-d tensor times a Python float
        # would promote to float64 under the forward-mode transform.
        R = R12 @ exp_so3(x[None, 0:3])[0]
        t = t12 + x[3:6]
        ls = torch.zeros_like(x[6:7]) if fix_scale else x[6:7]
        return R, t, s12 * torch.exp(ls)

    def residuals(x):
        R, t, s = unpack(x)
        e1 = project(s * P2 @ R.T + t) - uv1
        Rb = R.T
        sb = 1.0 / s
        e2 = project(sb * P1 @ Rb.T - sb * Rb @ t) - uv2
        return e1, e2

    def chi2(x):
        e1, e2 = residuals(x)
        return torch.sum(e1 * e1, -1), torch.sum(e2 * e2, -1)

    delta = torch.sqrt(torch.tensor(chi2_th, dtype=dt, device=dev))

    def flat(x, w1, w2):
        e1, e2 = residuals(x)
        return torch.cat([(e1 * torch.sqrt(w1)[:, None]).reshape(-1),
                          (e2 * torch.sqrt(w2)[:, None]).reshape(-1)])

    def run(x, gate):
        lam = torch.tensor(damping, dtype=dt, device=dev)
        for _ in range(n_iters):
            c1, c2 = chi2(x)
            w1 = mask * gate * robust.huber_weight(c1, delta)
            w2 = mask * gate * robust.huber_weight(c2, delta)
            r = flat(x, w1, w2)
            J = forward_jacobian(lambda xx: flat(xx, w1, w2), x)
            H = J.T @ J + lam * eye7
            x_new = x - solve_nan(H, J.T @ r)
            better = torch.sum(flat(x_new, w1, w2) ** 2) < torch.sum(r ** 2)
            x = torch.where(better, x_new, x)
            lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 5.0, max=1e3))
        return x

    x = run(torch.zeros(7, dtype=dt, device=dev), torch.ones_like(mask))
    c1, c2 = chi2(x)
    x = run(x, ((c1 < chi2_th) & (c2 < chi2_th)).to(mask.dtype))
    R, t, s = unpack(x)
    c1, c2 = chi2(x)
    inl = (c1 < chi2_th) & (c2 < chi2_th) & (mask > 0)
    return dict(R12=R, t12=t, s12=s.reshape(()), inliers=inl,
                n_inliers=inl.sum())
