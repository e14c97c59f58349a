"""Pose-graph (essential-graph) optimization over Sim3 / 4-DoF vertices.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/pose_graph.py``
(Optimizer::OptimizeEssentialGraph and its 4-DoF inertial variant).
Vertices are (R, t, s) world->keyframe; an edge (i, j) constrains the
relative similarity S_ij = S_i . S_j^-1 to its measured value with residual
log_sim3(S_meas^-1 . S_i . S_j^-1).  Per-edge 7x2D Jacobians come from
forward-mode autodiff of the two touched tangents (the reference's
jax.jacfwd under vmap over edges; here ``forward_jacobian``, 2D jvp passes
over all edges at once) and scatter-add into the dense (DK, DK) normal
equations (``ops/segment.py``: in input order on the CPU, in a fixed
order on the card, its plans built once per solve).  The accept/reject of
each damped step stays on the device.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.sim3 import (exp_sim3, log_sim3,
                                                   sim3_compose, sim3_inverse)
from orb_slam3_study_kr_tpu_torch.ops.segment import segment_plan, segment_sum
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import solve_nan


def forward_jacobian(fn, x):
    """Jacobian of ``fn`` at ``x`` (..., n) by n forward-mode passes, one
    per tangent direction, each shared across the leading axes: for a
    function whose output row b depends only on input row b this is the
    per-row Jacobian (..., *out, n).  (torch.func.jacfwd would vmap the
    basis; under vmap, arithmetic of a 0-d tensor with a Python float
    promotes to float64, which breaks float32 geometry.)"""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    cols = [torch.func.jvp(fn, (x,), (basis[k].expand_as(x),))[1]
            for k in range(n)]
    return torch.stack(cols, dim=-1)


def _apply_tangent(d, R, t, s, dof):
    """Left-multiplicative update exp(d) . (R, t, s)."""
    if dof == 7:
        dR, dt, ds = exp_sim3(d)
    elif dof == 4:
        # yaw + translation (z-axis rotation only), scale fixed.
        yaw = d[..., 0]
        z = torch.zeros_like(yaw)
        phi = torch.stack([z, z, yaw], -1)
        dR, dt, ds = exp_sim3(torch.cat([phi, d[..., 1:4], z[..., None]], -1))
    else:
        raise ValueError(dof)
    return sim3_compose(dR, dt, ds, R, t, s)


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """log( S_meas^-1 . S_i . S_j^-1 )."""
    R_ij, t_ij, s_ij = sim3_compose(Ri, ti, si, *sim3_inverse(Rj, tj, sj))
    Re, te, se = sim3_compose(*sim3_inverse(Rm, tm, sm), R_ij, t_ij, s_ij)
    return log_sim3(Re, te, se)


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """Measured S_ij = S_i . S_j^-1 from current estimates (how the
    reference builds non-loop edges of the essential graph)."""
    return sim3_compose(Ri, ti, si, *sim3_inverse(Rj, tj, sj))


def _scatter_blocks(K, D, cell, plan, blocks):
    """Sum (E, D, D) blocks into a (K*D, K*D) matrix at block (row, col),
    ``cell`` = row * K + col (with its segment plan); repeated cells
    accumulate."""
    H = segment_sum(K * K, cell, blocks, plan)
    return H.reshape(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D)


def _normal_equations(K, D, Ji, Jj, w, r, plans):
    """One iteration's dense (K*D, K*D) H and (K, D) b from the per-edge
    Jacobians (E, 7, D) of the two vertices, weights and residuals.
    ``plans``: the four block cells and the vertex index of the edges' two
    ends (edge_i, then edge_j), each with its segment plan (built once per
    solve)."""
    cells, (ends, plan_b) = plans
    H = (_scatter_blocks(K, D, *cells[0], torch.einsum("eri,e,erj->eij", Ji, w, Ji))
         + _scatter_blocks(K, D, *cells[1], torch.einsum("eri,e,erj->eij", Jj, w, Jj))
         + _scatter_blocks(K, D, *cells[2], torch.einsum("eri,e,erj->eij", Ji, w, Jj))
         + _scatter_blocks(K, D, *cells[3], torch.einsum("eri,e,erj->eij", Jj, w, Ji)))
    b = segment_sum(K, ends, torch.cat([
        torch.einsum("eri,e,er->ei", Ji, w, r),
        torch.einsum("eri,e,er->ei", Jj, w, r)]), plan_b)
    return H, b


def optimize_pose_graph(R, t, s,            # (K,3,3), (K,3), (K,)
                        edge_i, edge_j,     # (E,) int
                        Rm, tm, sm,         # (E,...) measured relative i<-j
                        edge_w,             # (E,) weight (0 masks an edge)
                        fixed,              # (K,) 1.0 = frozen vertex
                        n_iters: int = 20, dof: int = 7,
                        damping: float = 1e-6):
    """Returns optimized (R, t, s)."""
    K = R.shape[0]
    D = dof
    dt, dev = R.dtype, R.device
    ei, ej = edge_i.long(), edge_j.long()
    w = edge_w

    def f(dij, Ri, ti, si, Rj, tj, sj, Rme, tme, sme):
        Ri, ti, si = _apply_tangent(dij[..., :D], Ri, ti, si, dof)
        Rj, tj, sj = _apply_tangent(dij[..., D:], Rj, tj, sj, dof)
        return _edge_residual(Ri, ti, si, Rj, tj, sj, Rme, tme, sme)

    def cost(R, t, s):
        r = _edge_residual(R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], Rm, tm, sm)
        return torch.sum(w[:, None] * r * r)

    fixd = fixed.repeat_interleave(D)
    free = 1 - fixd
    eye = torch.eye(K * D, dtype=dt, device=dev)
    lam = torch.tensor(damping, dtype=dt, device=dev)
    z = torch.zeros((ei.shape[0], 2 * D), dtype=dt, device=dev)
    # The four block cells and the two vertex indices, each with the
    # segment plan of its sums (None on the CPU), fixed once per solve.
    ends = torch.cat([ei, ej])
    plans = ([(c, segment_plan(K * K, c))
              for c in (ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei)],
             (ends, segment_plan(K, ends)))
    for _ in range(n_iters):
        args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], Rm, tm, sm)
        r_all = _edge_residual(*args)                        # (E, 7)
        J_all = forward_jacobian(lambda d: f(d, *args), z)  # (E, 7, 2D)
        Ji, Jj = J_all[:, :, :D], J_all[:, :, D:]
        H, b = _normal_equations(K, D, Ji, Jj, w, r_all, plans)

        H = H * free[:, None] * free[None, :] + torch.diag(fixd) + lam * eye
        d = -solve_nan(H, b.reshape(K * D)).reshape(K, D)
        d = d * (1 - fixed)[:, None]
        R_n, t_n, s_n = _apply_tangent(d, R, t, s, dof)

        better = cost(R_n, t_n, s_n) < cost(R, t, s)
        R = torch.where(better, R_n, R)
        t = torch.where(better, t_n, t)
        s = torch.where(better, s_n, s)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e2))
    return R, t, s
