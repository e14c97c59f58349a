"""Visual-inertial bundle adjustment: joint optimization of keyframe body
states (pose, velocity, IMU biases) and landmarks.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/inertial_ba.py``
(Optimizer::LocalInertialBA: a temporal window with the keyframe before it
fixed and fixed visual observers, per-keyframe biases with random-walk
edges; Optimizer::FullInertialBA: the whole chain, in init mode one shared
bias with the priorG/priorA prior and no random-walk edges; Huber
sqrt(16.92) on the 9-D preintegration edges).

Each keyframe is a 15-dof state [phi, dp, dv, dbg, dba] in one dense
(K*15, K*15) system; landmarks are eliminated with the batched Schur
complement through the dense (K, M, 6, 3) cross block, the correction
landing on the pose dims [0:6] of each state.  Visual Jacobians are closed
form; the 9-D preintegration edges get their 24-dim pair Jacobians from
forward-mode autodiff.  Blocks are scattered through ``ops/segment.py``:
``index_add_`` / ``index_put_(accumulate=True)`` in input order on the
CPU, a fixed order on the card (its plans built once per solve), so a run
on the card gives the same bits every time; they differ from the CPU's
by float32 rounding.  LM damping with accept/reject stays on the device.
"""

import torch

from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    Preintegrated, gravity, inertial_residual)
from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3, hat, normalize_rotation
from orb_slam3_study_kr_tpu_torch.ops.segment import (put_add_, put_plan,
                                                      segment_plan, segment_sum)
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.inertial import (
    batched_jacobian, edge_whitening)
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, solve_nan

# Huber delta^2 on the whitened 9-D inertial edges (Optimizer.cc:543).
CHI2_INERTIAL = 16.92


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _huber_rho(chi2, d2, d):
    rr = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= d2, chi2, 2 * d * rr - d2)


def _pairs(rows, cols):
    """The flat (row, col) index pair of broadcast rows and cols: H[rows,
    cols] += vals accumulates repeated pairs through put_add_."""
    rows, cols = torch.broadcast_tensors(rows, cols)
    return rows.reshape(-1), cols.reshape(-1)


def inertial_bundle_adjust(
        project_fn, project_jac_fn,
        R_wb, p_wb, v_w, bias,        # (K,3,3) (K,3) (K,3) (K,6) body states
        fixed,                        # (K,) 1.0 = frozen pose
        R_cb, t_cb,                   # camera <- body extrinsic
        X, lm_mask,                   # (M,3), (M,)
        obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # visual COO
        edge_i, edge_j, pre_stack: Preintegrated, edge_mask,  # (E,) chain
        n_iters: int = 10,
        shared_bias: bool = False,    # FullInertialBA init mode
        bias_src=None,                # state index holding the shared bias
        prior_gyro: float = 0.0,      # bias prior information
        prior_acc: float = 0.0,
        init_lambda: float = 1e-4,
        obs_ur=None, bf=None,
        fixed_vb=None,                # (K,) 1.0 = frozen velocity and bias
        wide_fov: bool = False):      # fisheye: |p| > 1e-3, not z > 1e-3
    """Returns (R_wb, p_wb, v_w, bias, X, chi2_vis (O,), cost).

    edge_i / edge_j index the K states (masked edges are no-ops).  In
    shared_bias mode every inertial edge reads the bias of state `bias_src`
    and the random-walk edges are dropped; otherwise edge e uses state
    edge_i[e]'s bias and a 6-D random-walk edge couples the two states'
    biases."""
    K = R_wb.shape[0]
    M = X.shape[0]
    E = edge_i.shape[0]
    dtype, dev = R_wb.dtype, R_wb.device
    g = gravity(dev, dtype)
    if bias_src is None:
        bias_src = K - 1
    fvb = fixed if fixed_vb is None else fixed_vb
    obs_pose, obs_lm = obs_pose.long(), obs_lm.long()
    ei, ej = edge_i.long(), edge_j.long()

    inv_sigma2 = robust.octave_inv_sigma2(obs_level)
    if obs_ur is None:
        chi2_gate = torch.tensor(robust.CHI2_MONO, dtype=dtype, device=dev)
    else:
        chi2_gate = torch.where(
            obs_ur >= 0, torch.tensor(robust.CHI2_STEREO, dtype=dtype, device=dev),
            torch.tensor(robust.CHI2_MONO, dtype=dtype, device=dev))
    huber_delta = torch.sqrt(chi2_gate)
    d2_in = torch.tensor(CHI2_INERTIAL, dtype=dtype, device=dev)
    d_in = torch.sqrt(d2_in)

    W9 = edge_whitening(pre_stack)
    # Bias random-walk whitening from the accumulated walk covariance
    # (EdgeGyroRW/EdgeAccRW information, diagonal by construction).
    w_rw = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(pre_stack.cov, dim1=-2, dim2=-1)[:, 9:15], min=1e-14))

    ebias_src = (torch.full((E,), bias_src, dtype=torch.long, device=dev)
                 if shared_bias else ei)
    ar15 = torch.arange(15, device=dev)
    all_edge_cols = torch.cat([ei[:, None] * 15 + ar15[None, 0:9],
                               ebias_src[:, None] * 15 + ar15[None, 9:15],
                               ej[:, None] * 15 + ar15[None, 0:9]], 1)
    rw_cols = torch.cat([ei[:, None] * 15 + ar15[None, 9:15],
                         ej[:, None] * 15 + ar15[None, 9:15]], 1)
    free = (1.0 - fixed).to(dtype)
    n_dim = K * 15
    pose_dims = (torch.arange(K, device=dev)[:, None] * 15
                 + ar15[None, :6]).reshape(-1)
    fixd = torch.where((ar15 < 6).repeat(K), fixed.repeat_interleave(15),
                       fvb.repeat_interleave(15))
    pr = torch.cat([torch.full((3,), float(prior_gyro), dtype=dtype, device=dev),
                    torch.full((3,), float(prior_acc), dtype=dtype, device=dev)])
    pcols = bias_src * 15 + ar15[9:15]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    # Every scatter's index with the segment plan of its sums (None on the
    # CPU), fixed once per solve.
    HS = (n_dim, n_dim)
    edge_pairs = _pairs(all_edge_cols[:, :, None], all_edge_cols[:, None, :])
    rw_pairs = _pairs(rw_cols[:, :, None], rw_cols[:, None, :])
    pose_pairs = _pairs(pose_dims[:, None], pose_dims[None, :])
    plan = dict(
        pose=segment_plan(K, obs_pose), lm=segment_plan(M, obs_lm),
        W=put_plan((K, M), (obs_pose, obs_lm)),
        edge_H=put_plan(HS, edge_pairs),
        edge_b=segment_plan(n_dim, all_edge_cols.reshape(-1)),
        rw_H=None if shared_bias else put_plan(HS, rw_pairs),
        rw_b=None if shared_bias else segment_plan(n_dim, rw_cols.reshape(-1)),
        prior_H=put_plan(HS, (pcols, pcols)),
        prior_b=segment_plan(n_dim, pcols),
        pose_H=put_plan(HS, pose_pairs),
        pose_b=segment_plan(n_dim, pose_dims))

    def vis_terms(R_all, p_all, X_all):
        """Residuals and closed-form Jacobians of the visual edges w.r.t.
        right-multiplicative body increments: with q = R_wb^T (X - p_wb),
        p_cam = R_cb q + t_cb: dp_cam/dphi = R_cb hat(q), dp_cam/ddp =
        -R_cb R_wb^T, dp_cam/dX = R_cb R_wb^T."""
        Ro = R_all[obs_pose]
        po = p_all[obs_pose]
        Xo = X_all[obs_lm]
        q = torch.einsum("nji,nj->ni", Ro, Xo - po)
        pc = torch.einsum("ab,nb->na", R_cb, q) + t_cb
        uv_hat = project_fn(pc)
        r = uv_hat - obs_uv
        Jp = project_jac_fn(pc)                          # (O, 2, 3)
        if obs_ur is not None:
            z = torch.clamp(pc[..., 2], min=1e-6)
            ur_hat = uv_hat[..., 0] - bf / z
            has_ur = (obs_ur >= 0).to(dtype)
            r3 = (ur_hat - obs_ur) * has_ur
            zero = torch.zeros_like(z)
            J3 = Jp[..., 0, :] + torch.stack([zero, zero, bf / (z * z)], -1)
            J3 = J3 * has_ur[..., None]
            r = torch.cat([r, r3[..., None]], -1)
            Jp = torch.cat([Jp, J3[..., None, :]], -2)
        RcRbw = torch.einsum("ab,ncb->nac", R_cb, Ro)      # R_cb @ R_wb^T
        J_phi = torch.einsum("nda,ab,nbc->ndc", Jp, R_cb, hat(q))
        J_dp = -torch.einsum("nda,nab->ndb", Jp, RcRbw)
        J_X = torch.einsum("nda,nab->ndb", Jp, RcRbw)
        depth_ok = robust.cheirality(pc, wide_fov).to(dtype)
        return r, torch.cat([J_phi, J_dp], -1), J_X, depth_ok

    def edge_res(dx, R_all, p_all, v_all, b_all):
        """(..., E, 9) whitened inertial residuals at the states moved by
        the local increments dx (..., E, 24) = [phi_i, dp_i, dv_i,
        dbias_src, phi_j, dp_j, dv_j]."""
        R1 = R_all[ei] @ exp_so3(dx[..., 0:3])
        p1 = p_all[ei] + dx[..., 3:6]
        v1 = v_all[ei] + dx[..., 6:9]
        b = b_all[ebias_src] + dx[..., 9:15]
        R2 = R_all[ej] @ exp_so3(dx[..., 15:18])
        p2 = p_all[ej] + dx[..., 18:21]
        v2 = v_all[ej] + dx[..., 21:24]
        return _mv(W9, inertial_residual(R1, p1, v1, R2, p2, v2, b,
                                         pre_stack, g))

    z24 = torch.zeros((E, 24), dtype=dtype, device=dev)

    def full_cost(R_all, p_all, v_all, b_all, X_all):
        r_v, _, _, depth_ok = vis_terms(R_all, p_all, X_all)
        chi2 = torch.sum(r_v * r_v, -1) * inv_sigma2
        valid = obs_mask * lm_mask[obs_lm] * depth_ok
        c_vis = torch.sum(_huber_rho(chi2, chi2_gate, huber_delta) * valid)
        r_i = edge_res(z24, R_all, p_all, v_all, b_all)
        chi2_i = torch.sum(r_i * r_i, -1)
        c_in = torch.sum(_huber_rho(chi2_i, d2_in, d_in) * edge_mask)
        if not shared_bias:
            r_rw = (b_all[ej] - b_all[ei]) * w_rw
            c_in = c_in + torch.sum(torch.sum(r_rw * r_rw, -1) * edge_mask)
        bsb = b_all[bias_src]
        c_pr = (prior_gyro * torch.sum(bsb[:3] ** 2)
                + prior_acc * torch.sum(bsb[3:] ** 2))
        return c_vis + c_in + c_pr

    R_all, p_all, v_all, b_all, X_all = R_wb, p_wb, v_w, bias, X
    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    cost = full_cost(R_all, p_all, v_all, b_all, X_all)
    for _ in range(n_iters):
        # Visual part and the landmark Schur complement.
        r_v, J_pose6, J_X, depth_ok = vis_terms(R_all, p_all, X_all)
        chi2 = torch.sum(r_v * r_v, -1) * inv_sigma2
        valid = obs_mask * lm_mask[obs_lm] * depth_ok
        w = inv_sigma2 * valid * robust.huber_weight(chi2, huber_delta)
        Jp6 = J_pose6 * free[obs_pose][:, None, None]
        Hd = torch.zeros((n_dim, n_dim), dtype=dtype, device=dev)
        bvec = torch.zeros((n_dim,), dtype=dtype, device=dev)
        Hpp6 = segment_sum(K, obs_pose, torch.einsum(
            "nia,n,nib->nab", Jp6, w, Jp6), plan["pose"])
        bp6 = segment_sum(K, obs_pose, torch.einsum(
            "nia,n,ni->na", Jp6, w, r_v), plan["pose"])
        Hll = segment_sum(M, obs_lm, torch.einsum(
            "nia,n,nib->nab", J_X, w, J_X), plan["lm"])
        bl = segment_sum(M, obs_lm, torch.einsum(
            "nia,n,ni->na", J_X, w, r_v), plan["lm"])
        Eob = torch.einsum("nia,n,nib->nab", Jp6, w, J_X)   # (O, 6, 3)

        # Inertial edges.
        args = (R_all, p_all, v_all, b_all)
        r_i = edge_res(z24, *args)
        J_i = batched_jacobian(lambda dx: edge_res(dx, *args), z24)  # (E,9,24)
        chi2_i = torch.sum(r_i * r_i, -1)
        w_i = edge_mask * robust.huber_weight(chi2_i, d_in)
        put_add_(Hd, edge_pairs,
                 torch.einsum("eia,e,eib->eab", J_i, w_i, J_i).reshape(-1),
                 plan["edge_H"])
        put_add_(bvec, (all_edge_cols.reshape(-1),),
                 torch.einsum("eia,e,ei->ea", J_i, w_i, r_i).reshape(-1),
                 plan["edge_b"])
        if not shared_bias:
            # Bias random-walk edges: linear, J = [-W_rw | W_rw].
            r_rw = (b_all[ej] - b_all[ei]) * w_rw
            Wd = w_rw * edge_mask[:, None] ** 0.5
            Jrw = torch.cat([-torch.diag_embed(Wd), torch.diag_embed(Wd)], -1)
            put_add_(Hd, rw_pairs, torch.einsum(
                "eia,eib->eab", Jrw, Jrw).reshape(-1), plan["rw_H"])
            put_add_(bvec, (rw_cols.reshape(-1),), torch.einsum(
                "eia,ei->ea", Jrw, r_rw * edge_mask[:, None] ** 0.5).reshape(-1),
                plan["rw_b"])

        # Bias priors.
        put_add_(Hd, (pcols, pcols), pr, plan["prior_H"])
        put_add_(bvec, (pcols,), pr * b_all[bias_src], plan["prior_b"])

        # Assemble and damp.
        Hll_d = Hll + lam * (eye3[None] + Hll * eye3[None])
        Hll_inv = inv_nan(Hll_d) * lm_mask[:, None, None]
        Wc = torch.zeros((K, M, 6, 3), dtype=dtype, device=dev)
        put_add_(Wc, (obs_pose, obs_lm), Eob, plan["W"])
        Wi = torch.einsum("kmab,mbc->kmac", Wc, Hll_inv)
        corr = torch.einsum("kmac,lmbc->kalb", Wi, Wc).reshape(6 * K, 6 * K)
        rhs_corr = torch.einsum("kmab,mb->ka", Wi, bl).reshape(-1)
        blk = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
        ar = torch.arange(K, device=dev)
        blk[ar, :, ar, :] = Hpp6
        put_add_(Hd, pose_pairs, (blk.reshape(6 * K, 6 * K) - corr).reshape(-1),
                 plan["pose_H"])
        put_add_(bvec, (pose_dims,), bp6.reshape(-1) - rhs_corr,
                 plan["pose_b"])
        Hd = Hd + torch.diag(lam * (1.0 + torch.diagonal(Hd)) + 1e-8)

        # Freeze fixed dims: identity rows and columns.
        Hd = Hd * (1 - fixd)[:, None] * (1 - fixd)[None, :] + torch.diag(fixd)
        bvec = bvec * (1 - fixd)

        dx = -solve_nan(Hd, bvec).reshape(K, 15)
        dl = -torch.einsum("mab,mb->ma", Hll_inv,
                           bl + torch.einsum("kmab,ka->mb", Wc, dx[:, :6]))

        # Apply, accept or reject.
        R_new = normalize_rotation(R_all @ exp_so3(dx[:, 0:3]))
        p_new = p_all + dx[:, 3:6]
        v_new = v_all + dx[:, 6:9]
        b_new = b_all + dx[:, 9:15]
        X_new = X_all + dl * lm_mask[:, None]
        cost_new = full_cost(R_new, p_new, v_new, b_new, X_new)
        accept = cost_new < cost
        R_all = torch.where(accept, R_new, R_all)
        p_all = torch.where(accept, p_new, p_all)
        v_all = torch.where(accept, v_new, v_all)
        b_all = torch.where(accept, b_new, b_all)
        X_all = torch.where(accept, X_new, X_all)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(accept, cost_new, cost)
    r_v = vis_terms(R_all, p_all, X_all)[0]
    chi2_f = torch.sum(r_v * r_v, -1) * inv_sigma2
    return R_all, p_all, v_all, b_all, X_all, chi2_f, cost
