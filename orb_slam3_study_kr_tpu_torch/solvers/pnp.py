"""RANSAC PnP for relocalization (replaces src/MLPnPsolver.cpp).

Counterpart of ``orb_slam3_study_kr_tpu/solvers/pnp.py``: every minimal
6-point sample solves the DLT for the projection matrix in one batched SVD,
poses come from orthogonalizing its left 3x3, inliers gate on reprojection
chi2, and the best hypothesis is polished by the pose-only GN solver.

The reference draws its samples with ``jax.random.uniform(key, (iters,
n))``; torch cannot reproduce that stream, so the caller passes the
(iters, n) uniforms (its own torch.Generator draws, or the reference's in
tests).  Masked entries are set to 2.0 and the stable argsort takes the
first 6, as the reference's ``jnp.argsort``.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import normalize_rotation
from orb_slam3_study_kr_tpu_torch.solvers.pose_opt import optimize_pose

CHI2_2D = 5.991


def _dlt_pose(X, b):
    """P (3,4) from >= 6 points: X (..., m, 3) world, b (..., m, 3) bearing
    vectors.  Rows are the bearing cross-product constraints."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], dim=-1)                          # (..., m, 4)
    z = torch.zeros_like(Xh)
    bx, by, bz = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    rows_u = torch.cat([bz * Xh, z, -bx * Xh], dim=-1)         # (..., m, 12)
    rows_v = torch.cat([z, bz * Xh, -by * Xh], dim=-1)
    rows_w = torch.cat([-by * Xh, bx * Xh, z], dim=-1)
    A = torch.cat([rows_u, rows_v, rows_w], dim=-2)            # (..., 3m, 12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    P = Vt[..., 11, :].reshape(*A.shape[:-2], 3, 4)
    # Fix sign and scale so that det(R) > 0.
    scale = torch.linalg.det(P[..., :3])
    sgn = torch.where(scale < 0, -1.0, 1.0)
    norm = torch.abs(scale) ** (1.0 / 3.0)
    P = P * (sgn / torch.clamp(norm, min=1e-12))[..., None, None]
    return normalize_rotation(P[..., :3]), P[..., 3]


def minimal_sets(uniforms, mask, m):
    """First m entries of the stable argsort of the draws, masked entries
    pushed back with 2.0."""
    u = torch.where(mask[None, :] > 0, uniforms, torch.full_like(uniforms, 2.0))
    return torch.argsort(u, dim=1, stable=True)[:, :m]


def ransac_pnp(project_fn, project_jac_fn, K, X, uv, level, mask, uniforms,
               min_inliers=15, bearings=None):
    """Pose from 2D-3D matches with no prior (Relocalization's solver).

    X (N, 3) world points, uv (N, 2) pixels in project_fn's convention,
    level (N,), mask (N,) float, uniforms (iters, N) the RANSAC draws.
    ``bearings`` (N, 3): the unprojected rays of a non-pinhole model (KB8
    fisheye, where the reference's MLPnP likewise works on bearings) for
    the minimal DLT and the cheirality along the ray; they also select the
    wide-FOV cheirality of the GN polish.  Without them the rays are the
    pinhole normalization by K.  Returns dict(R, t, inliers, n_inliers,
    success), all tensors (nothing leaves the device)."""
    wide_fov = bearings is not None
    if bearings is None:
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
        bearings = torch.cat([xn, torch.ones_like(xn[:, :1])], -1)
    b = bearings / torch.clamp(torch.linalg.norm(bearings, dim=-1, keepdim=True),
                               min=1e-12)
    sets = minimal_sets(torch.as_tensor(uniforms, dtype=X.dtype, device=X.device),
                        mask, 6)

    R_h, t_h = _dlt_pose(X[sets], b[sets])                     # (T,3,3), (T,3)
    p = torch.einsum("tij,nj->tni", R_h, X) + t_h[:, None, :]
    uvp = project_fn(p)
    err = torch.sum((uvp - uv[None]) ** 2, -1)
    sigma2 = torch.pow(torch.tensor(1.2, dtype=X.dtype, device=X.device),
                       2.0 * level.to(X.dtype))
    cheir = torch.einsum("tni,ni->tn", p, b) > 0
    inl = (err < CHI2_2D * sigma2[None]) & cheir & (mask[None] > 0)
    best = torch.argmax(inl.sum(dim=1))                        # first max

    w = inl[best].to(X.dtype) * mask
    R_f, t_f, inliers, n_inl = optimize_pose(
        project_fn, project_jac_fn, R_h[best], t_h[best], X, uv, level, w,
        wide_fov=wide_fov)
    return dict(R=R_f, t=t_f, inliers=inliers, n_inliers=n_inl,
                success=n_inl >= min_inliers)
