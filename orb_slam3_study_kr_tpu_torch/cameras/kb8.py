"""Kannala-Brandt 8-parameter fisheye (equidistant polynomial) camera.

Counterpart of ``orb_slam3_study_kr_tpu/cameras/kb8.py``
(KannalaBrandt8::project / unproject / projectJac).

Model: r = |(x, y)|, theta = atan2(r, z),
       theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8),
       u = fx * theta_d * x / r + cx,  v = fy * theta_d * y / r + cy.

Params layout: [fx, fy, cx, cy, k1, k2, k3, k4, 0].  All functions
broadcast over leading point axes.
"""

import math

import torch

_EPS = 1e-8


def _coeffs(params):
    return (params[..., 4], params[..., 5], params[..., 6], params[..., 7])


def _poly(k, th2):
    """1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8 and its theta-derivative
    factor d(theta * poly)/dtheta."""
    k1, k2, k3, k4 = k
    poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
    dpoly = 1.0 + th2 * (3.0 * k1 + th2 * (5.0 * k2 + th2 * (7.0 * k3
                                                            + th2 * 9.0 * k4)))
    return poly, dpoly


def _polar(pts):
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS * _EPS))
    return x, y, z, r2, r, torch.atan2(r, z)


def project(params, pts):
    """3-D camera-frame points (..., 3) -> pixels (..., 2)."""
    x, y, _, _, r, theta = _polar(pts)
    poly, _ = _poly(_coeffs(params), theta * theta)
    scale = theta * poly / r
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    return torch.stack([fx * scale * x + cx, fy * scale * y + cy], dim=-1)


def unproject(params, uv, iters: int = 10):
    """Pixels (..., 2) -> UNIT bearing vector (..., 3).

    Newton's method on theta_d(theta) - target = 0, ``iters`` steps from
    theta = theta_d (clipped to [0, pi]) with the derivative floored at
    1e-8.  Returns the unit ray (sin(theta) * dir_xy, cos(theta)), not a
    z = 1 point: rays beyond 90 degrees off-axis have no z = 1 form."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    td = torch.sqrt(torch.clamp(mx * mx + my * my, min=_EPS * _EPS))
    td = torch.clamp(td, 0.0, math.pi)
    k = _coeffs(params)
    theta = td
    for _ in range(iters):
        poly, dpoly = _poly(k, theta * theta)
        theta = theta - (theta * poly - td) / torch.clamp(dpoly, min=_EPS)
    s = torch.sin(theta) / torch.clamp(td, min=_EPS)
    return torch.stack([mx * s, my * s, torch.cos(theta)], dim=-1)


def project_jac(params, pts):
    """d(pixel)/d(point) (..., 2, 3) in closed form (KannalaBrandt8::
    projectJac).  With s = theta_d / r: du/dp = fx (s e_x + x ds/dp),
    dv/dp = fy (s e_y + y ds/dp), where ds/dx = A x / r, ds/dy = A y / r,
    A = dtheta_d/dtheta * z / (rho^2 r) - theta_d / r^2, ds/dz =
    -dtheta_d/dtheta / rho^2 and rho^2 = r^2 + z^2.  Where x^2 + y^2 sits
    at the 1e-16 floor, r is constant and only ds/dz remains."""
    x, y, z, r2, r, theta = _polar(pts)
    poly, dpoly = _poly(_coeffs(params), theta * theta)
    td = theta * poly
    s = td / r
    rho2 = r * r + z * z
    live = (r2 > _EPS * _EPS).to(pts.dtype)
    A = (dpoly * z / (rho2 * r) - td / (r * r)) * live / r
    ds_dx, ds_dy, ds_dz = A * x, A * y, -dpoly / rho2
    fx, fy = params[..., 0], params[..., 1]
    row0 = torch.stack([fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz],
                       dim=-1)
    row1 = torch.stack([fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz],
                       dim=-1)
    return torch.stack([row0, row1], dim=-2)
