"""SE(3): rigid transforms as (R, t) pairs, R (..., 3, 3), t (..., 3).

Counterpart of ``orb_slam3_study_kr_tpu/lie/se3.py``; tangent ordering
xi = (phi, rho), rotation first.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import (
    _EPS, _eye_like, _theta, exp_so3, hat, left_jacobian_so3, log_so3)


def exp_se3(xi):
    """(..., 6) tangent [phi, rho] -> (R, t)."""
    phi, rho = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = left_jacobian_so3(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return R, t


def log_se3(R, t):
    """(R, t) -> (..., 6) tangent [phi, rho]."""
    phi = log_so3(R)
    Vinv = _left_jacobian_inv_so3(phi)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([phi, rho], dim=-1)


def _left_jacobian_inv_so3(w):
    th, th2 = _theta(w)
    small = th2 < _EPS
    cot_term = torch.where(
        small,
        1.0 / 12.0 + th2 / 720.0,
        1.0 / torch.clamp(th2, min=_EPS * _EPS)
        - (1.0 + torch.cos(th)) / torch.clamp(2.0 * th * torch.sin(th),
                                              min=_EPS),
    )
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * W2


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): apply b then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, p):
    """Transform points p (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def se3_matrix(R, t):
    """(R, t) -> (..., 4, 4) homogeneous matrix."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def se3_identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
