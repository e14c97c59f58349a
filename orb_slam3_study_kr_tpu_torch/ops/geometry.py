"""Multi-view geometry primitives: batched DLT triangulation from plane
coordinates and from bearing rays, the two-view matrices and the parallax
and reprojection measures (counterpart of
``orb_slam3_study_kr_tpu/ops/geometry.py``)."""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, svd_nan


def _dehomogenise(Xh):
    w = Xh[..., 3]
    safe_w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / safe_w[..., None]


def triangulate_dlt(xn1, xn2, R1w, t1w, R2w, t2w):
    """Batched DLT: xn1, xn2 (..., 2) normalized coords in cams 1, 2;
    world->camera poses broadcastable.  Returns (..., 3) world points;
    NaN for a non-finite input, as the reference's SVD gives."""
    P1 = torch.cat([R1w, t1w[..., None]], dim=-1)
    P2 = torch.cat([R2w, t2w[..., None]], dim=-1)
    rows = [
        xn1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        xn1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        xn2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        xn2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = torch.cat(torch.broadcast_tensors(*rows), dim=-2)
    Vh = svd_nan(A)[2]
    return _dehomogenise(Vh[..., 3, :])


def triangulate_rays(b1, b2, R1w, t1w, R2w, t2w):
    """Batched triangulation from bearing rays: the stacked (6, 4) cross-
    product constraints [b]_x (R X + t) = 0 of both cameras, solved by SVD.
    Returns (..., 3) world points."""
    P1 = torch.cat([R1w, t1w[..., None]], dim=-1)
    P2 = torch.cat([R2w, t2w[..., None]], dim=-1)
    b1n = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2n = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True), min=1e-12)
    A1 = hat(b1n) @ P1
    A2 = hat(b2n) @ P2
    A = torch.cat(torch.broadcast_tensors(A1, A2), dim=-2)
    Vh = torch.linalg.svd(A, full_matrices=True).Vh
    return _dehomogenise(Vh[..., 3, :])


def essential_from_pose(R12, t12):
    """E = hat(t12) @ R12 for the pose (R12, t12) of camera 2 in camera 1:
    x1n^T E x2n = 0."""
    return hat(t12) @ R12


def fundamental_from_poses(K1, K2, R1w, t1w, R2w, t2w):
    """F12 with x1^T F12 x2 = 0 for pixel coordinates
    (GeometricTools::ComputeF12); NaN for a singular K, as the reference."""
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = t1w - torch.einsum("...ij,...j->...i", R12, t2w)
    return inv_nan(K1).transpose(-1, -2) @ (hat(t12) @ R12) @ inv_nan(K2)


def reprojection_error(uv_obs, uv_proj):
    return torch.linalg.norm(uv_obs - uv_proj, dim=-1)


def parallax_cos(pw, c1, c2):
    """Cosine of the angle subtended at world point pw by camera centres."""
    r1 = pw - c1
    r2 = pw - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
