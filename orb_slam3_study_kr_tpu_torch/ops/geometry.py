"""Multi-view geometry primitives: batched DLT triangulation from plane
coordinates and from bearing rays (counterpart of
``orb_slam3_study_kr_tpu/ops/geometry.py``)."""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat


def _dehomogenise(Xh):
    w = Xh[..., 3]
    safe_w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / safe_w[..., None]


def triangulate_dlt(xn1, xn2, R1w, t1w, R2w, t2w):
    """Batched DLT: xn1, xn2 (..., 2) normalized coords in cams 1, 2;
    world->camera poses broadcastable.  Returns (..., 3) world points."""
    P1 = torch.cat([R1w, t1w[..., None]], dim=-1)
    P2 = torch.cat([R2w, t2w[..., None]], dim=-1)
    rows = [
        xn1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        xn1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        xn2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        xn2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = torch.cat(torch.broadcast_tensors(*rows), dim=-2)
    Vh = torch.linalg.svd(A).Vh
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
