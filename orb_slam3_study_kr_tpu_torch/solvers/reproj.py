"""Shared reprojection residual/Jacobian blocks for pose and BA solvers
(counterpart of ``orb_slam3_study_kr_tpu/solvers/reproj.py``, mono rows).

For a world point X, pose T_cw = (R, t), camera point p = R X + t and a
left-multiplicative update exp(delta) T_cw, delta = (omega, upsilon):
dp/ddelta = [-hat(p) | I_3], dp/dX = R, dr/d* = dproj/dp . dp/d*.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat


def camera_points(R_cw, t_cw, X):
    return torch.einsum("...ij,...j->...i", R_cw, X) + t_cw


def residual_and_jacobians(project_jac_fn, project_fn, R_cw, t_cw, X, uv_obs):
    """Batched residual r = proj(p) - uv and Jacobians.
    Returns (r (..., 2), J_pose (..., 2, 6), J_point (..., 2, 3), p_cam)."""
    p = camera_points(R_cw, t_cw, X)
    r = project_fn(p) - uv_obs
    Jp = project_jac_fn(p)
    J_pose = torch.cat([Jp @ -hat(p), Jp], dim=-1)
    J_point = Jp @ R_cw
    return r, J_pose, J_point, p
