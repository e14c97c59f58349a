"""Pose-only optimization: the tracking hot loop's solver.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/pose_opt.py``
(Optimizer::PoseOptimization): 4 rounds x 10 damped Gauss-Newton steps on
one SE3 (a 6x6 solve) over all matched landmarks, outliers re-classified at
chi2 5.991 (mono) or 7.815 (stereo rows) between rounds, Huber IRLS on
rounds 0-1.  A step is kept only when it lowers the robust-weighted cost;
the choice stays on the device.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import solve_nan
from orb_slam3_study_kr_tpu_torch.solvers.reproj import residual_and_jacobians

N_ROUNDS = 4
ITERS_PER_ROUND = 10


def optimize_pose(project_fn, project_jac_fn, R_cw, t_cw, X, uv_obs, level,
                  mask, damping=1e-3, ur_obs=None, bf=None, wide_fov=False):
    """Optimize one camera pose against fixed landmarks.

    R_cw (3, 3), t_cw (3); X (N, 3); uv_obs (N, 2); level (N,); mask (N,)
    float weights (1.0 for real observations).  ur_obs (N,) with bf =
    fx * baseline adds the stereo row on observations with ur_obs >= 0,
    gated at chi2 7.815 with Huber delta sqrt(7.815) there.  ``wide_fov``
    selects the fisheye cheirality (``robust.cheirality``).
    Returns (R, t, inlier_mask (N,) bool, n_inliers)."""
    inv_sigma2 = robust.octave_inv_sigma2(level)
    if ur_obs is None:
        chi2_gate = robust.CHI2_MONO
        huber_delta = robust.HUBER_MONO
    else:
        chi2_gate = torch.where(
            ur_obs >= 0,
            torch.tensor(robust.CHI2_STEREO, dtype=R_cw.dtype, device=R_cw.device),
            torch.tensor(robust.CHI2_MONO, dtype=R_cw.dtype, device=R_cw.device))
        huber_delta = torch.sqrt(chi2_gate)
    eye6 = torch.eye(6, dtype=R_cw.dtype, device=R_cw.device)

    def residuals(R, t):
        return residual_and_jacobians(project_jac_fn, project_fn, R[None],
                                      t[None], X, uv_obs, ur_obs=ur_obs, bf=bf)

    R, t = R_cw, t_cw
    inlier = torch.ones_like(mask)
    for rnd in range(N_ROUNDS):
        use_huber = rnd < 2
        for _ in range(ITERS_PER_ROUND):
            r, J_pose, _, p = residuals(R, t)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = inv_sigma2 * mask * inlier
            if use_huber:
                w = w * robust.huber_weight(chi2, huber_delta)
            w = w * robust.cheirality(p, wide_fov)
            H = torch.einsum("nia,n,nib->ab", J_pose, w, J_pose)
            b = torch.einsum("nia,n,ni->a", J_pose, w, r)
            H = H + damping * eye6
            delta = -solve_nan(H, b)
            dR, dt = exp_se3(delta)
            R_new, t_new = se3_compose(dR, dt, R, t)
            r_new = residuals(R_new, t_new)[0]
            c_old = torch.sum(w * torch.sum(r * r, dim=-1))
            c_new = torch.sum(w * torch.sum(r_new * r_new, dim=-1))
            better = c_new < c_old
            R = torch.where(better, R_new, R)
            t = torch.where(better, t_new, t)
        r, _, _, p = residuals(R, t)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        inlier = ((chi2 <= chi2_gate) & robust.cheirality(p, wide_fov)).to(R.dtype)
    inlier_b = (inlier > 0) & (mask > 0)
    return R, t, inlier_b, inlier_b.sum()
