"""Inertial optimizations: IMU initialization (gravity direction, scale,
biases, velocities) and pose-inertial frame tracking.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/inertial.py``
(Optimizer::InertialOptimization behind LocalMapping::InitializeIMU, and
PoseInertialOptimizationLastKeyFrame / LastFrame).  The states are small
(tens of dofs): Jacobians come from forward-mode autodiff, one jvp pass per
the tangent directions batched into one pass (``batched_jacobian``), and
each solve is a damped Gauss-Newton loop whose accept/reject stays on the
device.  The residual functions take a leading batch of states.

A near-singular matrix gives NaN here as in the reference (``*_ex``
factorizations, never an exception): a NaN step is never accepted, and a
NaN ``info`` tells the caller to drop the carried prior.

Conventions: body states (R_wb, p_wb, v_w); gravity g = R_wg @ [0,0,-9.81]
with R_wg a 2-dof rotation; the monocular scale s multiplies the visual
translations.
"""

import torch

from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    Preintegrated, gravity, inertial_residual)
from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3, log_so3
from orb_slam3_study_kr_tpu_torch.ops.stereo import nanmedian_midpoint
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import cholesky_nan, inv_nan, solve_nan


def edge_whitening(pre_stack: Preintegrated, eps=1e-8):
    """(E, 9, 9) whitening matrices W = chol(inv(cov9))^T per edge."""
    C = pre_stack.cov[..., :9, :9]
    C = C + eps * torch.eye(9, dtype=C.dtype, device=C.device)
    L = cholesky_nan(inv_nan(C))
    return L.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def batched_jacobian(fn, x):
    """Jacobian of ``fn`` at ``x`` (..., n) in one forward-mode pass over
    all n tangent directions: ``fn`` maps a leading batch of inputs (B,
    ...) to (B, ...) row by row, and is evaluated on n copies of x, copy k
    carrying tangent e_k.  Returns (*out, n).  (One pass where
    ``pose_graph.forward_jacobian`` makes n; the batch axis also keeps
    every intermediate at least 1-d: under torch.func a 0-d tensor times
    a Python float promotes to float64.)"""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    tangents = eye.reshape(n, *([1] * (x.dim() - 1)), n).expand(
        n, *x.shape).contiguous()
    _, t = torch.func.jvp(fn, (x.expand(n, *x.shape).contiguous(),),
                          (tangents,))
    return t.movedim(0, -1)


def _linear_init(R_wb, p_vis, pre_stack, fix_scale):
    """Closed-form seed for (scale, gravity, velocities): the
    preintegration constraints are linear in (s, g, v_0..v_{K-1}); solved
    as the minimum-norm least-squares solution (the reference's
    jnp.linalg.lstsq)."""
    K = R_wb.shape[0]
    dt_, dev = R_wb.dtype, R_wb.device
    dt = pre_stack.dT
    dV = _mv(R_wb[:-1], pre_stack.dV)
    dP = _mv(R_wb[:-1], pre_stack.dP)
    dp_vis = p_vis[1:] - p_vis[:-1]
    n_unk = 4 + 3 * K
    eye = torch.eye(3, dtype=dt_, device=dev)
    A = torch.zeros((K - 1, 2, 3, n_unk), dtype=dt_, device=dev)
    for i in range(K - 1):
        A[i, 0, :, 1:4] = -eye * dt[i]
        A[i, 0, :, 4 + 3 * i:7 + 3 * i] = -eye
        A[i, 0, :, 4 + 3 * (i + 1):7 + 3 * (i + 1)] = eye
        A[i, 1, :, 0] = dp_vis[i]
        A[i, 1, :, 1:4] = -0.5 * eye * dt[i] * dt[i]
        A[i, 1, :, 4 + 3 * i:7 + 3 * i] = -eye * dt[i]
    A = A.reshape(-1, n_unk)
    b = torch.stack([dV, dP], 1).reshape(-1)
    if fix_scale:
        b = b - A[:, 0]
        A = A.clone()
        A[:, 0] = 0.0
    x = torch.linalg.pinv(A) @ b
    s = torch.ones((), dtype=dt_, device=dev) if fix_scale else x[0]
    return s, x[1:4], x[4:].reshape(K, 3)




def inertial_only_optimization(R_wb, p_vis, pre_stack: Preintegrated,
                               prior_gyro=1e2, prior_acc=1e10, n_iters=40,
                               fix_scale=False, damping=1e-4):
    """Gravity direction, scale, biases and velocities from visual keyframe
    poses and preintegrated IMU (the core of IMU init).

    R_wb (K, 3, 3), p_vis (K, 3) visual body positions (scaled by s);
    pre_stack: Preintegrated with leading axis K-1 (window i -> i+1);
    prior_gyro / prior_acc: the bias prior's information (1e2/1e10, then
    1/1e5, then 0/0); fix_scale for stereo and RGB-D.

    Returns dict(R_wg, scale, bias (6,), v (K, 3), cost, edge_norms)."""
    K = R_wb.shape[0]
    dt_, dev = R_wb.dtype, R_wb.device
    Wm = edge_whitening(pre_stack)
    g0 = gravity(dev, dt_)

    s_lin, g_lin, v0 = _linear_init(R_wb, p_vis, pre_stack, fix_scale)
    ghat = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dt_, device=dev)
    axis = torch.linalg.cross(gI, ghat)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(gI, ghat)
    angle = torch.atan2(sin_a, cos_a)
    theta0 = torch.where(sin_a > 1e-6, axis / torch.clamp(sin_a, min=1e-9) * angle,
                         torch.zeros(3, dtype=dt_, device=dev))
    log_s0 = torch.log(torch.clamp(s_lin, 1e-2, 1e2))

    def unpack(x):
        """(B, n) states -> R_wg (B, 3, 3), s (B,), bias (B, 6), v (B, K, 3)."""
        th_g = torch.cat([x[:, :2], torch.zeros_like(x[:, :1])], -1)
        s = torch.ones_like(x[:, 2]) if fix_scale else torch.exp(x[:, 2])
        return exp_so3(th_g), s, x[:, 3:9], x[:, 9:].reshape(-1, K, 3)

    def edge_block(x):
        R_wg, s, bias, v = unpack(x)
        g = _mv(R_wg, g0)[:, None]
        p = p_vis * s[:, None, None]
        r = inertial_residual(R_wb[:-1], p[:, :-1], v[:, :-1], R_wb[1:],
                              p[:, 1:], v[:, 1:], bias[:, None], pre_stack, g)
        return _mv(Wm, r)                                   # (B, K-1, 9)

    def edge_weights_robust(x):
        """Huber kernel scaled by the current median edge norm (the
        whitened edges carry visual pose noise of unknown scale)."""
        norms = torch.linalg.norm(edge_block(x[None])[0], dim=-1)
        ok = torch.ones_like(norms, dtype=torch.bool)
        delta = 2.5 * nanmedian_midpoint(norms, ok) + 1e-6
        return torch.sqrt(robust.huber_weight(norms ** 2, delta))

    sq_g = float(prior_gyro) ** 0.5
    sq_a = float(prior_acc) ** 0.5

    def residuals(x, w_edge):
        r_edges = (edge_block(x) * w_edge[:, None]).reshape(x.shape[0], -1)
        bias = x[:, 3:9]
        return torch.cat([r_edges, sq_g * bias[:, :3], sq_a * bias[:, 3:]], -1)

    def cost(x, w_edge):
        return torch.sum(residuals(x[None], w_edge) ** 2)

    bias_ref = pre_stack.bias[0]
    x = torch.cat([theta0[:2], log_s0[None], bias_ref, v0.reshape(-1)]).to(dt_)
    lam = torch.tensor(damping, dtype=dt_, device=dev)
    eye = torch.eye(x.shape[0], dtype=dt_, device=dev)
    for _ in range(n_iters):
        w_edge = edge_weights_robust(x)
        r = residuals(x[None], w_edge)[0]
        J = batched_jacobian(lambda xx: residuals(xx, w_edge), x)
        H = J.T @ J
        H = H + lam * (eye + H * eye)
        x_new = x - solve_nan(H, J.T @ r)
        better = cost(x_new, w_edge) < torch.sum(r ** 2)
        x = torch.where(better, x_new, x)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e4))
    R_wg, s, bias, v = (a[0] for a in unpack(x[None]))
    edge_norms = torch.linalg.norm(edge_block(x[None])[0], dim=-1)
    return dict(R_wg=R_wg, scale=s, bias=bias, v=v,
                cost=cost(x, edge_weights_robust(x)), edge_norms=edge_norms)


def _visual_rows(project_fn, R, p, R_cb, t_cb, X, uv_obs):
    """Reprojection residuals (B, N, 2) and camera points (B, N, 3) of the
    landmarks X (N, 3) from body poses R (B, 3, 3), p (B, 3)."""
    R_cw = R_cb @ R.transpose(-1, -2)
    t_cw = -_mv(R_cw, p) + t_cb
    pc = torch.einsum("nj,bij->bni", X, R_cw) + t_cw[:, None]
    return project_fn(pc) - uv_obs, pc


def _frame_weights(project_fn, R, p, R_cb, t_cb, X, uv_obs, inv_sigma2,
                   obs_mask, wide_fov):
    """sqrt IRLS weights (N,) and chi2 of one body pose's monocular rows
    (Huber at sqrt(5.991), the cheirality of robust.cheirality)."""
    r, pc = _visual_rows(project_fn, R[None], p[None], R_cb, t_cb, X, uv_obs)
    r, pc = r[0], pc[0]
    chi2 = torch.sum(r * r, -1) * inv_sigma2
    w = obs_mask * inv_sigma2 * robust.huber_weight(chi2, robust.HUBER_MONO)
    w = w * robust.cheirality(pc, wide_fov)
    return torch.sqrt(torch.clamp(w, min=0.0)), chi2


def _bias_walk_weights(pre):
    """Bias random-walk whitening over one window (EdgeGyroRW/AccRW)."""
    w_bg = 1.0 / torch.sqrt(torch.clamp(pre.cov[9, 9], min=1e-12))
    w_ba = 1.0 / torch.sqrt(torch.clamp(pre.cov[12, 12], min=1e-12))
    return torch.cat([w_bg.expand(3), w_ba.expand(3)])


def _damped_gn(residuals, weights, x, n_iters, damping):
    """Damped Gauss-Newton with accept/reject on the device; the IRLS
    weights are re-evaluated at the start of every step."""
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    lam = torch.tensor(damping, dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        w_vis = weights(x)
        r = residuals(x[None], w_vis)[0]
        J = batched_jacobian(lambda xx: residuals(xx, w_vis), x)
        H = J.T @ J + lam * eye
        x_new = x - solve_nan(H, J.T @ r)
        better = (torch.sum(residuals(x_new[None], w_vis) ** 2)
                  < torch.sum(r ** 2))
        x = torch.where(better, x_new, x)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e4))
    return x


def pose_inertial_optimization(
        project_fn,
        R_wb0, p_wb0, v_w0, bias0,       # previous (anchor) body state, fixed
        pre: Preintegrated,              # window anchor -> current
        R_wb_init, p_wb_init, v_w_init,  # current-state initialization
        R_cb, t_cb,                      # camera <- body extrinsic
        X, uv_obs, level, obs_mask,      # visual observations of the frame
        n_iters=10, damping=1e-3, wide_fov=False):
    """The current frame's (R, p, v, bias) against its matched landmarks and
    the preintegration edge from the fixed anchor state
    (PoseInertialOptimizationLastKeyFrame, visual rows monocular;
    ``wide_fov``: the fisheye cheirality |p| > 1e-3).

    Returns (R_wb, p_wb, v_w, bias, inliers, info (15, 15))."""
    inv_sigma2 = robust.octave_inv_sigma2(level)
    Wm = edge_whitening(pre.map(lambda a: a[None]))[0]
    g = gravity(R_wb0.device, R_wb0.dtype)
    w_bias = _bias_walk_weights(pre)

    def unpack(x):
        R = R_wb_init @ exp_so3(x[:, :3])
        return R, p_wb_init + x[:, 3:6], v_w_init + x[:, 6:9], bias0 + x[:, 9:15]

    def weights(x):
        R, p, _, _ = unpack(x[None])
        return _frame_weights(project_fn, R[0], p[0], R_cb, t_cb, X, uv_obs,
                              inv_sigma2, obs_mask, wide_fov)[0]

    def residuals(x, w_vis):
        R, p, v, bias = unpack(x)
        r_vis = _visual_rows(project_fn, R, p, R_cb, t_cb, X, uv_obs)[0]
        r_inr = _mv(Wm, inertial_residual(R_wb0, p_wb0, v_w0, R, p, v, bias,
                                          pre, g))
        r_bias = (bias - bias0) * w_bias
        return torch.cat([(r_vis * w_vis[:, None]).reshape(x.shape[0], -1),
                          r_inr, r_bias], -1)

    x = torch.zeros(15, dtype=R_wb0.dtype, device=R_wb0.device)
    x = _damped_gn(residuals, weights, x, n_iters, damping)
    R, p, v, bias = (a[0] for a in unpack(x[None]))
    w_vis, chi2 = _frame_weights(project_fn, R, p, R_cb, t_cb, X, uv_obs,
                                 inv_sigma2, obs_mask, wide_fov)
    inliers = (chi2 <= robust.CHI2_MONO) & (obs_mask > 0)
    # The Gauss-Newton information at the optimum: the 15-D marginal prior
    # carried to the next frame's solve (the anchor is fixed, so the Schur
    # reduction is H_cc itself).
    J = batched_jacobian(lambda xx: residuals(xx, w_vis), x)
    return R, p, v, bias, inliers, J.T @ J


def estimate_gyro_bias(R1, R2, pre_stack: Preintegrated, edge_mask=None,
                       n_iters=10):
    """Robust gyro-bias-only estimate from visual rotations: min over bg of
    sum_e huber(|log((dR_e exp(JRg_e (bg - b_e)))^T R1_e^T R2_e)|), the
    Huber delta re-derived from the median edge norm each iteration.

    R1, R2: (E, 3, 3) body rotations at the edge endpoints.
    Returns (bg (3,), edge_weights (E,))."""
    E = R1.shape[0]
    if edge_mask is None:
        edge_mask = torch.ones(E, dtype=R1.dtype, device=R1.device)
    eye = torch.eye(3, dtype=R1.dtype, device=R1.device)
    R12 = R1.transpose(-1, -2) @ R2

    def res(bg):
        """(B, 3) gyro biases -> (B, E, 3) rotation residuals."""
        dbg = bg[:, None] - pre_stack.bias[:, :3]
        dR = pre_stack.dR @ exp_so3(_mv(pre_stack.JRg, dbg))
        return log_so3(dR.transpose(-1, -2) @ R12)

    def robust_w(nrm):
        ok = (edge_mask > 0) & torch.isfinite(nrm)
        delta = 3.0 * torch.clamp(nanmedian_midpoint(nrm, ok), min=1e-5)
        return edge_mask * torch.clamp(delta / torch.clamp(nrm, min=1e-12),
                                       max=1.0)

    bg = pre_stack.bias[0, :3]
    for _ in range(n_iters):
        r = res(bg[None])[0]
        w = robust_w(torch.linalg.norm(r, dim=1))
        J = batched_jacobian(res, bg)                     # (E, 3, 3)
        H = torch.einsum("eij,e,eik->jk", J, w, J)
        gvec = torch.einsum("eij,e,ei->j", J, w, r)
        bg = bg - solve_nan(H + 1e-9 * eye, gvec)
    return bg, robust_w(torch.linalg.norm(res(bg[None])[0], dim=1))


def pose_inertial_optimization_last_frame(
        project_fn,
        R_wb0, p_wb0, v_w0, bias0,       # previous-frame body state (free)
        prior_info,                      # (15, 15) marginal information on it
        pre: Preintegrated,              # window previous frame -> current
        R_wb_init, p_wb_init, v_w_init,  # current-state initialization
        R_cb, t_cb,
        X, uv_obs, level, obs_mask,
        n_iters=10, damping=1e-3, wide_fov=False):
    """PoseInertialOptimizationLastFrame: a joint 30-dof solve over
    [previous frame, current frame]; the previous frame carries the 15-D
    marginal prior of its own solve and is marginalized out afterwards
    (Schur complement), giving the next frame's prior.

    Returns (R, p, v, bias, inliers, new_prior_info) of the current frame."""
    inv_sigma2 = robust.octave_inv_sigma2(level)
    Wm = edge_whitening(pre.map(lambda a: a[None]))[0]
    g = gravity(R_wb0.device, R_wb0.dtype)
    eye15 = torch.eye(15, dtype=prior_info.dtype, device=prior_info.device)
    prior_sqrt = cholesky_nan(prior_info + 1e-8 * eye15).T
    w_bias = _bias_walk_weights(pre)

    def unpack(x):
        prev = (R_wb0 @ exp_so3(x[:, 0:3]), p_wb0 + x[:, 3:6],
                v_w0 + x[:, 6:9], bias0 + x[:, 9:15])
        cur = (R_wb_init @ exp_so3(x[:, 15:18]), p_wb_init + x[:, 18:21],
               v_w_init + x[:, 21:24], bias0 + x[:, 24:30])
        return prev, cur

    def weights(x):
        _, (Rc, pc_, _, _) = unpack(x[None])
        return _frame_weights(project_fn, Rc[0], pc_[0], R_cb, t_cb, X,
                              uv_obs, inv_sigma2, obs_mask, wide_fov)[0]

    def residuals(x, w_vis):
        (Rp, pp, vp, bp), (Rc, pc_, vc, bc) = unpack(x)
        r_vis = _visual_rows(project_fn, Rc, pc_, R_cb, t_cb, X, uv_obs)[0]
        r_inr = _mv(Wm, inertial_residual(Rp, pp, vp, Rc, pc_, vc, bp, pre, g))
        r_rw = (bc - bp) * w_bias
        r_prior = _mv(prior_sqrt, x[:, 0:15])
        return torch.cat([(r_vis * w_vis[:, None]).reshape(x.shape[0], -1),
                          r_inr, r_rw, r_prior], -1)

    x = torch.zeros(30, dtype=R_wb0.dtype, device=R_wb0.device)
    x = _damped_gn(residuals, weights, x, n_iters, damping)
    _, cur = unpack(x[None])
    R, p, v, bias = (a[0] for a in cur)
    w_vis, chi2 = _frame_weights(project_fn, R, p, R_cb, t_cb, X, uv_obs,
                                 inv_sigma2, obs_mask, wide_fov)
    inliers = (chi2 <= robust.CHI2_MONO) & (obs_mask > 0)
    J = batched_jacobian(lambda xx: residuals(xx, w_vis), x)
    H = J.T @ J
    H_pp = H[:15, :15] + 1e-6 * eye15
    H_pc = H[:15, 15:]
    H_cc = H[15:, 15:]
    return R, p, v, bias, inliers, H_cc - H_pc.T @ solve_nan(H_pp, H_pc)
