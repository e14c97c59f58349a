"""Sim(3): similarity transforms (R, t, s) for loop closing.

Counterpart of ``orb_slam3_study_kr_tpu/lie/sim3.py``: action
p -> s * R p + t, tangent zeta = (phi, rho, sigma) with s = exp(sigma), the
same guarded series for the W matrix.  All functions broadcast over leading
batch axes.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import _EPS, _theta, exp_so3, hat, log_so3
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import solve_nan


def _sim3_W(phi, sigma):
    """The Sim3 'V'-like matrix W with t = W rho (Eade / Strasdat form)."""
    th, th2 = _theta(phi)
    s = torch.exp(sigma)
    small_sig = torch.abs(sigma) < 1e-5
    small_th = th2 < _EPS
    one = torch.ones_like(sigma)
    sig2 = sigma * sigma

    C = torch.where(small_sig, 1.0 - sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))
    cos_th, sin_th = torch.cos(th), torch.sin(th)

    denom = torch.where(small_sig, one, sig2) + th2
    a_big = (s * sin_th * sigma + (1.0 - s * cos_th) * th) / (
        torch.clamp(th, min=_EPS) * denom)
    b_big = (C - ((s * cos_th - 1.0) * sigma + s * sin_th * th) / denom) / (
        torch.clamp(th2, min=_EPS * _EPS))

    # sigma -> 0 limits
    a_sig0 = torch.where(small_th, 0.5 - th2 / 24.0,
                         (1.0 - cos_th) / torch.clamp(th2, min=_EPS * _EPS))
    b_sig0 = torch.where(small_th, 1.0 / 6.0 - th2 / 120.0,
                         (th - sin_th) / torch.clamp(th2 * th, min=_EPS))
    # theta -> 0, sigma != 0 limits
    a_th0 = torch.where(small_sig, 0.5 - sigma / 6.0,
                        ((sigma - 1.0) * s + 1.0) / torch.where(small_sig, one, sig2))
    b_th0 = torch.where(
        small_sig, 1.0 / 6.0 - sigma / 24.0,
        (s * (0.5 * sig2 - sigma + 1.0) - 1.0)
        / torch.where(small_sig, one, sig2 * sigma))

    A = torch.where(small_th, a_th0, torch.where(small_sig, a_sig0, a_big))
    B = torch.where(small_th, b_th0, torch.where(small_sig, b_sig0, b_big))

    W = hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return A[..., None, None] * W + B[..., None, None] * W2 + C[..., None, None] * eye


def exp_sim3(zeta):
    """(..., 7) tangent [phi, rho, sigma] -> (R, t, s)."""
    phi, rho, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    R = exp_so3(phi)
    W = _sim3_W(phi, sigma)
    t = torch.einsum("...ij,...j->...i", W, rho)
    return R, t, torch.exp(sigma)


def log_sim3(R, t, s):
    """(R, t, s) -> (..., 7) tangent [phi, rho, sigma]."""
    phi = log_so3(R)
    sigma = torch.log(s)
    W = _sim3_W(phi, sigma)
    rho = solve_nan(W, t[..., None])[..., 0]
    return torch.cat([phi, rho, sigma[..., None]], dim=-1)


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """a . b : p -> sa Ra (sb Rb p + tb) + ta."""
    return (Ra @ Rb,
            sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta,
            sa * sb)


def sim3_apply(R, t, s, p):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def sim3_identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return R, t, torch.ones(batch_shape, dtype=dtype, device=device)
