"""Fisheye (non-rectified) stereo matching and ray triangulation.

Counterpart of ``orb_slam3_study_kr_tpu/ops/fisheye_stereo.py``
(Frame::ComputeStereoFishEyeMatches, KannalaBrandt8::TriangulateMatches):
a 195-degree lens cannot be rectified, so left and right keypoints are
matched by descriptor over the dense Hamming matrix, pre-gated by the
epipolar plane of the known extrinsic, triangulated from bearing rays and
accepted by the two-sided reprojection chi2 (5.991 sigma^2).  The
reference computes it outside Pallas; this is plain PyTorch on the device
of its inputs.  The output is the left camera's 3-D point per left
keypoint (mvStereo3Dpoints) with a validity mask.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat
from orb_slam3_study_kr_tpu_torch.ops.geometry import triangulate_rays
from orb_slam3_study_kr_tpu_torch.ops.matching import (BIG, TH_LOW, _excl_min,
                                                       hamming_matrix,
                                                       rotation_consistency)

CHI2_MONO = 5.991


def _unit(b):
    return b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)


def match_stereo_fisheye(
    project_l_fn, project_r_fn, focal,
    R_rl, t_rl,
    uv_l, b_l, level_l, desc_l, valid_l, angle_l,
    uv_r, b_r, level_r, desc_r, valid_r, angle_r,
    scale_factor=1.2, epi_chi2=9.0, nn_ratio=0.9,
):
    """Match left keypoints to right keypoints and triangulate.

    project_l_fn / project_r_fn: each camera's KB8 projection; focal: the
    pixel scale of the angular epipolar pre-gate; R_rl, t_rl: the pose of
    the LEFT camera in the RIGHT camera frame (p_r = R_rl p_l + t_rl).
    Per side uv (N, 2), bearings b (N, 3), level, desc (N, 256) uint8 bits,
    valid and angle.

    Returns dict of per-left-keypoint idx_r (N,) int64, ok (N,), X (N, 3)
    left-camera points and depth (N,), the range along the left ray."""
    dt = b_l.dtype
    b_ln, b_rn = _unit(b_l), _unit(b_r)

    # Epipolar-plane pre-gate: b_r^T E b_l = 0 with E = [t_rl]x R_rl.
    E = hat(t_rl) @ R_rl
    l_r = _unit(b_ln @ E.T)                      # plane normal, right frame
    sin_d = l_r @ b_rn.T                         # (Nl, Nr)
    f = torch.as_tensor(focal, dtype=dt, device=b_l.device)
    d2 = (f * f) * sin_d * sin_d
    sf = torch.tensor(scale_factor, dtype=dt, device=b_l.device)
    sigma2_r = torch.pow(sf, 2.0 * level_r.to(dt))
    epi_ok = d2 < epi_chi2 * sigma2_r[None, :]

    mask = epi_ok & valid_l[:, None] & valid_r[None, :]
    d = torch.where(mask, hamming_matrix(desc_l, desc_r),
                    torch.full(mask.shape, BIG, dtype=torch.float32,
                               device=mask.device))
    idx_r = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx_r[:, None])[:, 0]
    second = _excl_min(d, idx_r, -1)
    matched = (best <= TH_LOW) & (best < nn_ratio * second)
    back = torch.argmin(d, dim=0)
    ar = torch.arange(uv_l.shape[0], device=uv_l.device)
    matched = matched & (back[idx_r] == ar)
    matched = rotation_consistency(angle_l, angle_r, idx_r, matched)

    # Triangulate in the LEFT camera frame: camera 1 = left at identity,
    # camera 2 = right at (R_rl, t_rl).
    eye = torch.eye(3, dtype=dt, device=b_l.device)
    zero = torch.zeros(3, dtype=dt, device=b_l.device)
    b_rm = b_rn[idx_r]
    X = triangulate_rays(b_ln, b_rm, eye[None], zero[None], R_rl[None],
                         t_rl[None])

    p_r = X @ R_rl.T + t_rl
    depth_l = torch.sum(X * b_ln, dim=-1)        # range along the left ray
    depth_r = torch.sum(p_r * b_rm, dim=-1)
    z_ok = (depth_l > 0) & (depth_r > 0)

    e_l = torch.sum((project_l_fn(X) - uv_l) ** 2, dim=-1)
    e_r = torch.sum((project_r_fn(p_r) - uv_r[idx_r]) ** 2, dim=-1)
    sigma2_l = torch.pow(sf, 2.0 * level_l.to(dt))
    reproj_ok = (e_l < CHI2_MONO * sigma2_l) & (e_r < CHI2_MONO * sigma2_r[idx_r])

    ok = matched & z_ok & reproj_ok & torch.isfinite(X).all(dim=-1)
    return dict(idx_r=idx_r, ok=ok, X=X, depth=depth_l)
