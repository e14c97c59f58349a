"""Pinhole camera with optional radial-tangential distortion.

Counterpart of ``orb_slam3_study_kr_tpu/cameras/pinhole.py``.  Intrinsics
layout (params vector): [fx, fy, cx, cy, k1, k2, p1, p2, k3].  All
functions broadcast over leading point axes.
"""

import torch

_Z_MIN = 1e-6


def distort_normalized(params, xy):
    """Apply rad-tan distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = (params[..., 4], params[..., 5], params[..., 6],
                          params[..., 7], params[..., 8])
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(params, xy_d, iters: int = 8):
    """Invert rad-tan distortion by fixed-point iteration (the
    cv::undistortPoints scheme)."""
    k1, k2, p1, p2, k3 = (params[..., 4], params[..., 5], params[..., 6],
                          params[..., 7], params[..., 8])
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - dx) / radial,
                          (xy_d[..., 1] - dy) / radial], dim=-1)
    return xy


def project(params, pts):
    """3-D camera-frame points (..., 3) -> pixel coords (..., 2)."""
    z = torch.clamp(pts[..., 2], min=_Z_MIN)
    xy = pts[..., :2] / z[..., None]
    xy = distort_normalized(params, xy)
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


def unproject(params, uv):
    """Pixels (..., 2) -> unit-depth bearing (..., 3) with z = 1."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    xy_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xy = undistort_normalized(params, xy_d)
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def project_jac(params, pts):
    """d(pixel)/d(point): (..., 2, 3), closed form for the undistorted model
    (BA operates on undistorted keypoints)."""
    fx, fy = params[..., 0], params[..., 1]
    x, y = pts[..., 0], pts[..., 1]
    z = torch.clamp(pts[..., 2], min=_Z_MIN)
    z_inv = 1.0 / z
    z_inv2 = z_inv * z_inv
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * z_inv, zero, -fx * x * z_inv2], dim=-1)
    row1 = torch.stack([zero, fy * z_inv, -fy * y * z_inv2], dim=-1)
    return torch.stack([row0, row1], dim=-2)
