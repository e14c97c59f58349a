"""SO(3): rotation group on (..., 3, 3) tensors.

Counterpart of ``orb_slam3_study_kr_tpu/lie/so3.py``: the same formulas,
small-angle series and near-pi branch, written on torch tensors.  All
functions broadcast over leading batch axes.
"""

import torch

_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """(..., 3, 3) skew matrix -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(w):
    """Rotation angle with a safe sqrt; returns (theta, theta^2)."""
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(torch.clamp(th2, min=_EPS * _EPS))
    return th, th2


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w):
    """Exponential map (..., 3) -> (..., 3, 3), Rodrigues with Taylor guard."""
    th, th2 = _theta(w)
    small = th2 < _EPS
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R):
    """Logarithm map (..., 3, 3) -> (..., 3), accurate over the whole group
    (atan2 angle, near-pi axis from the symmetric part)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - R.transpose(-1, -2))
    sin_th = 0.5 * torch.sqrt(torch.clamp(torch.sum(skew * skew, dim=-1),
                                          min=_EPS * _EPS))
    sin_th = torch.clamp(sin_th, 0.0, 1.0)
    th = torch.atan2(sin_th, cos_th)

    small = th < 1e-4
    scale = torch.where(small, 0.5 + th * th / 12.0,
                        th / torch.clamp(2.0 * sin_th, min=_EPS))
    w_generic = scale[..., None] * skew

    near_pi = cos_th < -1.0 + 1e-6
    B = (R + R.transpose(-1, -2)) * 0.5
    d = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    denom = torch.clamp(1.0 - cos_th, min=_EPS)
    ax2 = torch.clamp((d - cos_th[..., None]) / denom[..., None], 0.0, 1.0)
    ax = torch.sqrt(torch.clamp(ax2, min=_EPS))
    k = torch.argmax(ax, dim=-1)
    sym = torch.stack([B[..., 1, 0], B[..., 2, 1], B[..., 0, 2]], dim=-1)
    prods = torch.stack(
        [
            torch.stack([ax2[..., 0], sym[..., 0], sym[..., 2]], dim=-1),
            torch.stack([sym[..., 0], ax2[..., 1], sym[..., 1]], dim=-1),
            torch.stack([sym[..., 2], sym[..., 1], ax2[..., 2]], dim=-1),
        ],
        dim=-2,
    ) / denom[..., None, None]
    row = torch.take_along_dim(
        prods, k[..., None, None].expand(*k.shape, 1, 3), dim=-2)[..., 0, :]
    signs = torch.where(row >= 0, 1.0, -1.0)
    ax_signed = ax * signs
    flip = torch.where(torch.sum(ax_signed * skew, dim=-1) < 0.0, -1.0, 1.0)
    ax_signed = ax_signed * flip[..., None]
    w_pi = th[..., None] * ax_signed / torch.clamp(
        torch.linalg.norm(ax_signed, dim=-1, keepdim=True), min=_EPS)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian_so3(w):
    """Left Jacobian J_l of SO(3): exp(w+dw) ~ exp(J_l dw) exp(w)."""
    th, th2 = _theta(w)
    small = th2 < _EPS
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=_EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / torch.clamp(th2 * th, min=_EPS))
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def right_jacobian_so3(w):
    """Right Jacobian J_r(w) = J_l(-w) (ImuTypes.cc RightJacobianSO3)."""
    return left_jacobian_so3(-w)


def right_jacobian_inv_so3(w):
    """Inverse right Jacobian (InverseRightJacobianSO3): the coefficient of
    W is +1/2, of W^2 1/th^2 - (1 + cos th) / (2 th sin th)."""
    th, th2 = _theta(w)
    small = th2 < _EPS
    cot_term = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        1.0 / torch.clamp(th2, min=_EPS * _EPS)
        - (1.0 + torch.cos(th)) / torch.clamp(2.0 * th * torch.sin(th),
                                              min=_EPS))
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + 0.5 * W + cot_term[..., None, None] * W2


def normalize_rotation(R):
    """Project (..., 3, 3) onto SO(3) via SVD, flipping the last singular
    direction of a reflection."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def quat_to_matrix(q):
    """(..., 4) [w, x, y, z] quaternion, normalised first -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix_to_quat(R):
    """(..., 3, 3) -> (..., 4) [w, x, y, z], w >= 0 (Shepperd-style, best
    conditioned of the four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw = 0.5 * safe_sqrt(1.0 + tr)
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                      (m10 - m01) / (4 * qw)], -1)
    qx = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                      (m02 + m20) / (4 * qx)], -1)
    qy = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                      (m12 + m21) / (4 * qy)], -1)
    qz = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                      (m12 + m21) / (4 * qz), qz], -1)
    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    k = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(
        cands, k[..., None, None].expand(*k.shape, 1, 4), dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q * sign
