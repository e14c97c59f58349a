"""Shared reprojection residual/Jacobian blocks for pose and BA solvers
(counterpart of ``orb_slam3_study_kr_tpu/solvers/reproj.py``).

For a world point X, pose T_cw = (R, t), camera point p = R X + t and a
left-multiplicative update exp(delta) T_cw, delta = (omega, upsilon):
dp/ddelta = [-hat(p) | I_3], dp/dX = R, dr/d* = dproj/dp . dp/d*.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat


def camera_points(R_cw, t_cw, X):
    return torch.einsum("...ij,...j->...i", R_cw, X) + t_cw


def residual_and_jacobians(project_jac_fn, project_fn, R_cw, t_cw, X, uv_obs,
                           ur_obs=None, bf=None):
    """Batched residual r = proj(p) - uv and Jacobians.

    With ur_obs (...,), the right-image u of a rectified stereo observation
    (< 0 where the observation is mono-only), and bf = fx * baseline, a
    third row u_hat - bf / z - ur is added (EdgeStereoSE3ProjectXYZ), with
    d/dp = dproj_u/dp + [0, 0, bf / z^2]; the row and its Jacobians are
    zero for mono-only observations.

    Returns (r (..., D), J_pose (..., D, 6), J_point (..., D, 3), p_cam)
    with D = 2 (mono) or 3 (stereo)."""
    p = camera_points(R_cw, t_cw, X)
    uv_hat = project_fn(p)
    r = uv_hat - uv_obs
    Jp = project_jac_fn(p)
    if ur_obs is not None:
        # A float32 tensor: a Python float on the left of `/` would run as a
        # reciprocal times bf, which rounds differently from bf / z.
        bf = torch.as_tensor(bf, dtype=p.dtype, device=p.device)
        z = torch.clamp(p[..., 2], min=1e-6)
        has_ur = (ur_obs >= 0).to(r.dtype)
        r3 = (uv_hat[..., 0] - bf / z - ur_obs) * has_ur
        zero = torch.zeros_like(z)
        J3 = Jp[..., 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
        J3 = J3 * has_ur[..., None]
        r = torch.cat([r, r3[..., None]], dim=-1)
        Jp = torch.cat([Jp, J3[..., None, :]], dim=-2)
    J_pose = torch.cat([Jp @ -hat(p), Jp], dim=-1)
    J_point = Jp @ R_cw
    return r, J_pose, J_point, p
