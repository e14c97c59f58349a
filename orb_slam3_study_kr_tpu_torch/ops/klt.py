"""Batched KLT-style patch alignment for match verification/refinement.

Counterpart of ``orb_slam3_study_kr_tpu/ops/klt.py``: each match is
verified and sub-pixel-refined by forward-additive Lucas-Kanade of the
frame's blurred-level window against the landmark's canonical patch
(translation + gain/bias invariance via zero-mean gain-fitted residuals),
fixed GN iterations, then an alias-ambiguity probe.  The reference's
hat-weight contractions become bilinear gathers with the same semantics
(taps outside the 27x27 superpatch weigh 0; central-difference gradients
are samples at +-1 px).
"""

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.ops.orb import (PATCH_R, bilinear_window,
                                                  gather_windows)

_SPAN = 13
_S = 2 * _SPAN + 1


def klt_refine(pyr_stack, level_wh, uv_l0, level, angle, tmpl, mask,
               iters: int = 5, max_shift: float = 3.0):
    """Align each keypoint's oriented window to its template.

    pyr_stack (L, H, W) f32 blurred pyramid; level_wh (L, 2) f32 [w_l, h_l];
    uv_l0 (N, 2) level-0 coords; level (N,) int; angle (N,); tmpl (N, P, P);
    mask (N,) bool.  Returns (uv_ref (N, 2), zncc (N,), shift (N,),
    win (N, P, P), distinct (N,)) with the reference's conventions."""
    L = pyr_stack.shape[0]
    w_l = level_wh[:, 0]
    h_l = level_wh[:, 1]
    lvl = torch.clamp(level.long(), 0, L - 1)
    sx = level_wh[0, 0] / w_l[lvl]
    sy = level_wh[0, 1] / h_l[lvl]
    x_l = (uv_l0[:, 0] + 0.5) / sx - 0.5
    y_l = (uv_l0[:, 1] + 0.5) / sy - 0.5

    xi = torch.round(x_l).to(torch.int64)
    yi = torch.round(y_l).to(torch.int64)
    fx = x_l - xi.to(torch.float32)
    fy = y_l - yi.to(torch.float32)
    sp = gather_windows(pyr_stack, lvl, yi - _SPAN, xi - _SPAN, _S)

    grid = torch.arange(-PATCH_R, PATCH_R + 1, dtype=torch.float32,
                        device=pyr_stack.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    gx = gx.reshape(1, -1)
    gy = gy.reshape(1, -1)

    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    cx = (_SPAN + fx)[:, None]
    cy = (_SPAN + fy)[:, None]

    t = tmpl.to(torch.float32).reshape(tmpl.shape[0], -1)
    t0 = t - t.mean(dim=1, keepdim=True)
    t0_ss = torch.clamp((t0 * t0).sum(dim=1), min=1e-6)

    def coords(dx, dy):
        ux = gx + dx[:, None]
        uy = gy + dy[:, None]
        return cy + ux * sa + uy * ca, cx + ux * ca - uy * sa

    def window_and_grads(dx, dy):
        py, px = coords(dx, dy)
        w = bilinear_window(sp, py, px)
        ix = 0.5 * (bilinear_window(sp, py, px + 1.0)
                    - bilinear_window(sp, py, px - 1.0))
        iy = 0.5 * (bilinear_window(sp, py + 1.0, px)
                    - bilinear_window(sp, py - 1.0, px))
        return w, ix, iy

    n = uv_l0.shape[0]
    dx = torch.zeros(n, dtype=torch.float32, device=uv_l0.device)
    dy = torch.zeros_like(dx)
    for _ in range(iters):
        w, ix, iy = window_and_grads(dx, dy)
        w0 = w - w.mean(dim=1, keepdim=True)
        g = (w0 * t0).sum(dim=1) / t0_ss
        r = w0 - g[:, None] * t0
        jx = ix * ca + iy * sa
        jy = -ix * sa + iy * ca
        h11 = (jx * jx).sum(dim=1) + 1e-3
        h12 = (jx * jy).sum(dim=1)
        h22 = (jy * jy).sum(dim=1) + 1e-3
        b1 = (jx * r).sum(dim=1)
        b2 = (jy * r).sum(dim=1)
        det = torch.clamp(h11 * h22 - h12 * h12, min=1e-6)
        ddx = (h22 * b1 - h12 * b2) / det
        ddy = (h11 * b2 - h12 * b1) / det
        dx = torch.clamp(dx - ddx, -max_shift, max_shift)
        dy = torch.clamp(dy - ddy, -max_shift, max_shift)

    def zncc_at(ddx, ddy):
        w = bilinear_window(sp, *coords(dx + ddx, dy + ddy))
        w0 = w - w.mean(dim=1, keepdim=True)
        w_ss = torch.clamp((w0 * w0).sum(dim=1), min=1e-6)
        return (w0 * t0).sum(dim=1) / torch.sqrt(w_ss * t0_ss), w

    zncc, w = zncc_at(0.0, 0.0)
    P = tmpl.shape[1]
    win = w.reshape(-1, P, P)

    # Alias-ambiguity probe: template score one texture cell away from the
    # optimum; margin zncc - max(probe) measures distinctiveness.
    probe = 2.5
    amb = torch.full_like(zncc, -1.0)
    for pdx, pdy in ((probe, 0.0), (-probe, 0.0), (0.0, probe), (0.0, -probe)):
        z_p, _ = zncc_at(pdx, pdy)
        amb = torch.maximum(amb, z_p)
    distinct = zncc - amb

    rx = x_l + dx * ca[:, 0] - dy * sa[:, 0]
    ry = y_l + dx * sa[:, 0] + dy * ca[:, 0]
    u0 = (rx + 0.5) * sx - 0.5
    v0 = (ry + 0.5) * sy - 0.5
    uv_ref = torch.where(mask[:, None], torch.stack([u0, v0], dim=-1), uv_l0)
    shift = torch.where(mask, torch.sqrt(dx * dx + dy * dy),
                        torch.full_like(dx, max_shift + 1.0))
    zncc = torch.where(mask, zncc, torch.full_like(zncc, -1.0))
    distinct = torch.where(mask, distinct, torch.full_like(distinct, -1.0))
    return uv_ref, zncc, shift, win, distinct


def make_level_wh(cfg) -> np.ndarray:
    """(L, 2) float32 [w_l, h_l] table for an OrbConfig."""
    return np.asarray(
        [[cfg.level_sizes[l][1], cfg.level_sizes[l][0]]
         for l in range(cfg.n_levels)], np.float32)


def stack_pyramid(pyr_levels):
    """Pad a list of per-level images with zeros into one (L, H, W) stack
    at level 0's size."""
    H, W = pyr_levels[0].shape
    return torch.stack([torch.nn.functional.pad(
        img, (0, W - img.shape[1], 0, H - img.shape[0])) for img in pyr_levels])
