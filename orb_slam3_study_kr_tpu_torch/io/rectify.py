"""Stereo rectification precompute + image remap.

Counterpart of ``orb_slam3_study_kr_tpu/io/rectify.py`` (the reference
Settings' rectification maps, cv::stereoRectify +
cv::initUndistortRectifyMap): for a calibrated, non-rectified pinhole
stereo rig with rad-tan distortion, the pair of rectifying rotations, a
shared ideal intrinsic matrix, and dense sampling maps that warp the raw
images into the rectified, undistorted pair whose epipolar lines are rows —
the geometry ``ops/stereo.match_stereo`` assumes.

Method: Fusiello-Trucco-Verri — the new x axis is the baseline direction.
The maps are built once per rig on the host (the distortion through
``cameras/pinhole.distort_normalized`` on CPU float32 tensors, as the
reference evaluates it in float32), and the remap is a bilinear gather on
the host, where the reference runs cv::remap.
"""

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.cameras import pinhole


@dataclass
class RectifyMaps:
    """Per-camera sampling grid into the RAW image for each rectified
    pixel."""
    x0: np.ndarray      # (H, W) int32 floor x
    y0: np.ndarray      # (H, W) int32 floor y
    wx: np.ndarray      # (H, W) float32 fraction
    wy: np.ndarray      # (H, W) float32


@dataclass
class RectifiedRig:
    left: RectifyMaps
    right: RectifyMaps
    K_new: np.ndarray       # (3, 3) shared rectified intrinsics
    baseline: float         # metric baseline of the rectified pair
    bf: float               # fx_new * baseline
    R_rect_l: np.ndarray    # (3, 3) left raw cam -> rectified cam
    R_rect_r: np.ndarray

    def remap_left(self, img):
        return _remap(img, self.left)

    def remap_right(self, img):
        return _remap(img, self.right)


def _remap(img, m: RectifyMaps):
    img = np.asarray(img, np.float32)
    H, W = img.shape
    x0 = np.clip(m.x0, 0, W - 2)
    y0 = np.clip(m.y0, 0, H - 2)
    inb = (m.x0 >= 0) & (m.x0 <= W - 2) & (m.y0 >= 0) & (m.y0 <= H - 2)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = ((1 - m.wy) * ((1 - m.wx) * v00 + m.wx * v01)
           + m.wy * ((1 - m.wx) * v10 + m.wx * v11))
    return np.where(inb, out, 0.0).astype(np.float32)


def _maps_for(params_raw, K_new, R_rect, width, height):
    """Sampling grid: rectified pixel -> ideal ray -> rotate back into the
    raw camera -> distort -> raw pixel."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    fx, fy, cx, cy = (K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2])
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    rays = rays @ R_rect            # R_rect^T applied to row vectors
    z = np.where(np.abs(rays[..., 2]) < 1e-9, 1e-9, rays[..., 2])
    xy = rays[..., :2] / z[..., None]
    xy_d = pinhole.distort_normalized(
        torch.as_tensor(params_raw, dtype=torch.float32),
        torch.as_tensor(xy, dtype=torch.float32)).numpy()
    fxr, fyr, cxr, cyr = params_raw[0], params_raw[1], params_raw[2], \
        params_raw[3]
    px = fxr * xy_d[..., 0] + cxr
    py = fyr * xy_d[..., 1] + cyr
    behind = z <= 0
    px = np.where(behind, -1e6, px)
    x0 = np.floor(px).astype(np.int32)
    y0 = np.floor(py).astype(np.int32)
    return RectifyMaps(
        x0=x0, y0=y0,
        wx=(px - x0).astype(np.float32), wy=(py - y0).astype(np.float32))


def stereo_rectify(params_l, params_r, R_rl, t_rl, width, height):
    """Build the rectified rig.

    params_l/params_r: [fx, fy, cx, cy, k1, k2, p1, p2, k3] raw pinhole
    intrinsics+distortion.  R_rl, t_rl: p_right = R_rl p_left + t_rl.
    Returns RectifiedRig."""
    params_l = np.asarray(params_l, np.float64)
    params_r = np.asarray(params_r, np.float64)
    R_rl = np.asarray(R_rl, np.float64)
    t_rl = np.asarray(t_rl, np.float64)

    # Camera centres in the LEFT frame.
    c2 = -R_rl.T @ t_rl
    baseline = float(np.linalg.norm(c2))
    if baseline < 1e-9:
        raise ValueError("degenerate stereo rig: zero baseline")
    # New axes (rows of R_rect_l): x along the baseline, y ~ old left y.
    e1 = c2 / baseline
    if e1[0] < 0:
        e1 = -e1  # keep the left camera on the left
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    R_rect_l = np.stack([e1, e2, e3])        # left raw -> rectified
    R_rect_r = R_rect_l @ R_rl.T             # right raw -> rectified

    # Shared intrinsics: mean focal, centred principal point.
    f = 0.5 * (params_l[0] + params_r[0])
    K_new = np.array([[f, 0, width / 2.0],
                      [0, f, height / 2.0],
                      [0, 0, 1.0]])
    left = _maps_for(params_l, K_new, R_rect_l, width, height)
    right = _maps_for(params_r, K_new, R_rect_r, width, height)
    return RectifiedRig(left=left, right=right, K_new=K_new,
                        baseline=baseline, bf=float(f * baseline),
                        R_rect_l=R_rect_l, R_rect_r=R_rect_r)
