"""ORB feature extraction on torch tensors.

Counterpart of ``orb_slam3_study_kr_tpu/ops/orb.py``: dense per-level FAST
score + two-threshold NMS + 7x7 blur (one hand-written CUDA kernel launch
for the whole pyramid on the card, ``ops/cuda_fast.py``), per-cell top-k +
global top-quota selection, parabolic sub-pixel offsets, then ONE batched
per-keypoint stage over all levels: superpatch gather, intensity-centroid
orientation, rotated-BRIEF bits and the oriented 11x11 patch.

Parity notes (the reference package is the contract):
- the pyramid resize uses the reference's antialiased triangle-kernel
  weight matrices (jax.image.resize "linear"), built in numpy;
- top-k is a stable descending sort: among equal scores the lowest index
  wins, as lax.top_k does;
- window gathers clamp their start into bounds, as lax.dynamic_slice does;
- rotated samples are bilinear gathers whose taps outside the superpatch
  weigh 0, the semantics of the reference's hat-weight contractions.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

# FAST-9/16 Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

HALF_PATCH = 15  # orientation disc radius
DESC_BITS = 256
PATTERN_RADIUS = 13  # generated pattern stays inside this disc
EDGE_MARGIN = 19


def _make_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) int32 [point][p/q][y/x] binary-test offsets: BRIEF-style
    isotropic Gaussian sampling (sigma = patch/5) clipped to a disc; the
    same seeded draw as the reference package."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < DESC_BITS * 2:
        p = rng.normal(0.0, 6.2, 2)
        if np.linalg.norm(p) <= PATTERN_RADIUS:
            pts.append(p)
    pat = np.array(pts[: DESC_BITS * 2]).reshape(DESC_BITS, 2, 2)
    return np.round(pat).astype(np.int32)


PATTERN = _make_pattern()

# 7-tap sigma-2 Gaussian (float64 normalised, then float32 — the
# reference's gaussian_blur7 weights).
G7 = np.exp(-0.5 * (np.arange(-3, 4, dtype=np.float64) / 2.0) ** 2)
G7 = (G7 / G7.sum()).astype(np.float32)


def _f32(x) -> float:
    """A Python float holding x rounded to float32 (how the reference
    package's weak-typed scalars enter float32 arithmetic)."""
    return float(np.float32(x))


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20      # iniThFAST
    fast_min_threshold: int = 7   # minThFAST
    cell_size: int = 35
    cell_topk: int = 8            # candidates kept per cell before global top-quota
    height: int = 480
    width: int = 752

    @functools.cached_property
    def level_scales(self):
        return tuple(self.scale_factor ** l for l in range(self.n_levels))

    @functools.cached_property
    def level_sizes(self):
        return tuple(
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.level_scales
        )

    @functools.cached_property
    def level_quotas(self):
        """Per-level keypoint budget, geometric in 1/scale_factor."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        quotas = [int(round(n0 * f ** l)) for l in range(self.n_levels - 1)]
        quotas.append(max(self.n_features - sum(quotas), 0))
        return tuple(quotas)

    @functools.cached_property
    def total_slots(self):
        return sum(self.level_quotas)


# ---------------------------------------------------------------------------
# Dense per-level stage (plain versions; K1 fuses them on the card)


def fast_score_map(img, threshold_min: float):
    """Dense FAST-9/16 score of every pixel of an (H, W) float image: the
    max over the 16 contiguous 9-arcs of the arc-min of ring-centre
    margins, both polarities, 0 where <= threshold_min.  Shifts wrap
    around (torch.roll), as the reference's jnp path does."""
    circ = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dy, dx in FAST_OFFSETS], dim=0)
    bright = circ - img[None]
    dark = -bright

    def arc_score(d):
        dd = torch.cat([d, d[:8]], dim=0)
        m = dd[:16]
        for k in range(1, 9):
            m = torch.minimum(m, dd[k:k + 16])
        return m.max(dim=0).values

    score = torch.maximum(arc_score(bright), arc_score(dark))
    return torch.where(score > threshold_min, score, torch.zeros_like(score))


def nms3x3(score):
    """3x3 non-maximum suppression (wrapping shifts)."""
    neigh = torch.full_like(score, -float("inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(score, (dy, dx), dims=(0, 1)))
    return torch.where((score >= neigh) & (score > 0), score,
                       torch.zeros_like(score))


def gaussian_blur7(img):
    """Separable 7x7 sigma-2 Gaussian with edge clamping, summed tap by tap
    in order (k0*x0 + k1*x1 + ...), as the reference's gaussian_blur7."""
    H, W = img.shape
    pad = torch.nn.functional.pad(img[None, None], (3, 3, 0, 0),
                                  mode="replicate")[0, 0]
    h = float(G7[0]) * pad[:, 0:W]
    for i in range(1, 7):
        h = h + float(G7[i]) * pad[:, i:i + W]
    hp = torch.nn.functional.pad(h[None, None], (0, 0, 3, 3),
                                 mode="replicate")[0, 0]
    v = float(G7[0]) * hp[0:H]
    for i in range(1, 7):
        v = v + float(G7[i]) * hp[i:i + H]
    return v


def border_mask(h, w, margin, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def _top_k(x, k):
    """lax.top_k along the last axis: descending, lowest index first among
    equal values (a stable sort; torch.topk breaks ties arbitrarily)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score20, score7, quota, cell, topk):
    """Two-threshold cell fallback + per-cell top-k + global top-quota.
    A cell uses the low threshold only when the high threshold found
    nothing there."""
    h, w = score20.shape
    ph = -(-h // cell) * cell
    pw = -(-w // cell) * cell
    s20 = torch.nn.functional.pad(score20, (0, pw - w, 0, ph - h))
    s7 = torch.nn.functional.pad(score7, (0, pw - w, 0, ph - h))
    ncy, ncx = ph // cell, pw // cell

    def cells_of(s):
        return s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
            -1, cell * cell)

    c20, c7 = cells_of(s20), cells_of(s7)
    has20 = torch.any(c20 > 0, dim=1, keepdim=True)
    cells = torch.where(has20, c20, c7)

    vals, idx = _top_k(cells, topk)
    ci = torch.arange(ncy * ncx, device=score20.device)
    yy = (ci // ncx)[:, None] * cell + idx // cell
    xx = (ci % ncx)[:, None] * cell + idx % cell

    flat_vals = vals.reshape(-1)
    q = min(quota, flat_vals.shape[0])
    top_vals, top_i = _top_k(flat_vals, q)
    sel_y = yy.reshape(-1)[top_i]
    sel_x = xx.reshape(-1)[top_i]
    valid = top_vals > 0
    if q < quota:
        pad = quota - q
        top_vals = torch.nn.functional.pad(top_vals, (0, pad))
        sel_y = torch.nn.functional.pad(sel_y, (0, pad))
        sel_x = torch.nn.functional.pad(sel_x, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return sel_x, sel_y, top_vals, valid


def subpixel_offset_maps(score_raw):
    """Dense parabolic 3x3 sub-pixel offset maps (dx, dy) of the raw score."""
    c = score_raw
    l = torch.roll(c, 1, dims=1)
    r = torch.roll(c, -1, dims=1)
    u = torch.roll(c, 1, dims=0)
    d = torch.roll(c, -1, dims=0)
    denx = 2.0 * c - l - r
    deny = 2.0 * c - u - d
    zero = torch.zeros_like(c)
    dx = torch.where(denx.abs() > 1e-6, 0.5 * (r - l) / denx, zero)
    dy = torch.where(deny.abs() > 1e-6, 0.5 * (d - u) / deny, zero)
    return dx.clamp(-0.5, 0.5), dy.clamp(-0.5, 0.5)


def subpixel_refine(score_raw, xs, ys):
    """Per-keypoint parabolic refinement: integer (xs, ys) plus the dense
    offsets at (ys, xs)."""
    dx, dy = subpixel_offset_maps(score_raw)
    return (xs.to(torch.float32) + dx[ys, xs],
            ys.to(torch.float32) + dy[ys, xs])


# ---------------------------------------------------------------------------
# Pyramid


@functools.lru_cache(maxsize=None)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of jax.image.resize(..., "linear") along
    one axis: an antialiased triangle kernel (scaled by 1/scale when
    downsampling), column-normalised, zero for samples outside the input."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    # (i + 0.5) * inv_scale - 0.5 rounded once: the reference's compiled
    # program fuses it into one multiply-add.
    sample_f = ((np.arange(out_size) + 0.5) * np.float64(inv_scale)
                - 0.5).astype(np.float32)
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    tot = np.zeros((1, out_size), np.float32)
    for i in range(in_size):
        tot = tot + w[i:i + 1]
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size) - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_linear(img, h, w):
    """(H, W) -> (h, w) with the reference's antialiased linear resize."""
    H, W = img.shape
    wy = torch.as_tensor(_resize_weights_np(H, h), device=img.device)
    wx = torch.as_tensor(_resize_weights_np(W, w), device=img.device)
    return (wy.T @ img) @ wx


def build_pyramid(img, cfg: OrbConfig):
    """List of n_levels float32 images; level l resized from level l-1."""
    levels = [img.to(torch.float32)]
    for l in range(1, cfg.n_levels):
        h, w = cfg.level_sizes[l]
        levels.append(resize_linear(levels[-1], h, w))
    return levels


# ---------------------------------------------------------------------------
# Per-keypoint stage

PATCH_R = 5  # oriented verification patch radius (11x11)
SUPER_R = 16
_SS = 2 * SUPER_R + 1


def gather_windows(stack, lvl, yi, xi, size):
    """(N, size, size) windows of an (L, H, W) stack starting at (yi, xi)
    of level lvl; the start is clamped so the window stays in bounds
    (lax.dynamic_slice semantics)."""
    L, H, W = stack.shape
    y0 = yi.long().clamp(0, H - size)
    x0 = xi.long().clamp(0, W - size)
    ar = torch.arange(size, device=stack.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return stack[lvl.long()[:, None, None], rows, cols]


def bilinear_window(win, py, px):
    """Bilinear samples of (N, S, S) windows at (N, P) coordinates.  Taps
    outside the window weigh 0 (hat weights max(0, 1 - |d|))."""
    N, S, _ = win.shape
    flat = win.reshape(N, S * S)

    def taps(p):
        t0 = torch.floor(p)
        out = []
        for o in (0, 1):
            t = t0 + o
            w = torch.clamp(1.0 - torch.abs(p - t), min=0.0)
            w = torch.where((t >= 0) & (t <= S - 1), w, torch.zeros_like(w))
            out.append((w, t.long().clamp(0, S - 1)))
        return out

    ty, tx = taps(py), taps(px)
    # Rows interpolated in y first, then x (the reference's contraction
    # order).
    out = torch.zeros_like(py)
    for bx, xi in tx:
        c = torch.zeros_like(py)
        for ay, yi in ty:
            c = c + ay * torch.gather(flat, 1, yi * S + xi)
        out = out + c * bx
    return out


def gather_patches(img, xs, ys, radius):
    """(N, 2r+1, 2r+1) patches centred at integer (ys, xs) of the image
    padded with r zeros."""
    padded = torch.nn.functional.pad(img, (radius,) * 4)
    return gather_windows(padded[None], torch.zeros_like(ys), ys, xs,
                          2 * radius + 1)


def compute_orientation(img, xs, ys):
    """Intensity-centroid angle (radians) per integer keypoint over the
    radius-15 disc (IC_Angle, ORBextractor.cc:76)."""
    return _orientation_from_patches(
        gather_patches(img.to(torch.float32), xs, ys, SUPER_R))


def compute_descriptors(img_blur, xs, ys, angles):
    """(N, 256) uint8 rotated-BRIEF bits at integer keypoints: the pattern
    offsets rotated by the keypoint angle and rounded to whole pixels
    (computeOrbDescriptor's scheme, ORBextractor.cc:107).  extract_orb
    samples the same pattern bilinearly at the refined centre instead."""
    radius = PATTERN_RADIUS + 2
    p = 2 * radius + 1
    patches = gather_patches(img_blur, xs, ys, radius).reshape(-1, p * p)
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=img_blur.device)
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    py, px = pat[..., 0][None], pat[..., 1][None]            # (1, 256, 2)
    iy = (torch.round(px * sa + py * ca) + radius).long()
    ix = (torch.round(px * ca - py * sa) + radius).long()
    vals = torch.gather(patches, 1, (iy * p + ix).reshape(len(xs), -1))
    vals = vals.reshape(-1, DESC_BITS, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.uint8)


def gather_oriented_patches(img, xs, ys, angles, radius=PATCH_R):
    """(N, 2r+1, 2r+1) patches rotated to each keypoint's canonical
    orientation, bilinear on the zero-padded level image (the semantics
    that extract_orb's ``_oriented_patches_from_patches`` batches; the
    taps here add in the reference's order, x first)."""
    span = int(np.ceil(radius * 1.5)) + 2
    padded = torch.nn.functional.pad(img.to(torch.float32), (span,) * 4)
    H, W = padded.shape
    grid = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=img.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    px = xs.to(torch.float32)[:, None, None] + gx * ca - gy * sa + span
    py = ys.to(torch.float32)[:, None, None] + gx * sa + gy * ca + span
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()

    def at(y, x):  # out-of-range reads clamp, as a jnp gather does
        return padded[y.clamp(0, H - 1), x.clamp(0, W - 1)]

    return ((1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x0 + 1))
            + wy * ((1 - wx) * at(y0 + 1, x0) + wx * at(y0 + 1, x0 + 1)))


def _orientation_from_patches(raw_sp):
    """Intensity-centroid angle from integer-centred superpatches."""
    coords = torch.arange(-SUPER_R, SUPER_R + 1, dtype=torch.float32,
                          device=raw_sp.device)
    rr = coords[:, None] ** 2 + coords[None, :] ** 2
    disc = (rr <= HALF_PATCH * HALF_PATCH).to(torch.float32)
    m01 = torch.sum(raw_sp * disc[None] * coords[None, :, None], dim=(1, 2))
    m10 = torch.sum(raw_sp * disc[None] * coords[None, None, :], dim=(1, 2))
    return torch.atan2(m01, m10)


def _sample_rotated(blur_sp, offs_y, offs_x, fy, fx, angles):
    """Bilinear samples of each superpatch at its keypoint-rotated offsets
    plus the sub-pixel centre fraction; offs_y/offs_x (P,) -> (N, P)."""
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    px = SUPER_R + fx[:, None] + offs_x[None] * ca - offs_y[None] * sa
    py = SUPER_R + fy[:, None] + offs_x[None] * sa + offs_y[None] * ca
    return bilinear_window(blur_sp, py, px)


def _descriptors_from_patches(blur_sp, fy, fx, angles):
    """(N, 256) uint8 rotated-BRIEF bits from bilinear pattern samples."""
    pts = torch.as_tensor(PATTERN.reshape(2 * DESC_BITS, 2), dtype=torch.float32,
                          device=blur_sp.device)
    vals = _sample_rotated(blur_sp, pts[:, 0], pts[:, 1], fy, fx, angles)
    vals = vals.reshape(-1, DESC_BITS, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.uint8)


def _oriented_patches_from_patches(blur_sp, fy, fx, angles, radius=PATCH_R):
    """(N, 11, 11) canonical-orientation patches at the refined centre."""
    grid = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=blur_sp.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    vals = _sample_rotated(blur_sp, gy.reshape(-1), gx.reshape(-1), fy, fx,
                           angles)
    p = 2 * radius + 1
    return vals.reshape(-1, p, p)


@dataclass(frozen=True)
class OrbFeatures:
    """SoA keypoint table in level-0 pixel coordinates (fixed capacity)."""
    uv: torch.Tensor        # (N, 2) float32, level-0 coords
    response: torch.Tensor  # (N,)
    angle: torch.Tensor     # (N,) radians
    level: torch.Tensor     # (N,) int32
    desc: torch.Tensor      # (N, 256) uint8
    valid: torch.Tensor     # (N,) bool
    patch: torch.Tensor = None  # (N, 11, 11) uint8 oriented intensity patch


def extract_level(img_l, quota, cfg: OrbConfig, maps=None):
    """Dense per-level stage: FAST score, two-threshold NMS, cell select,
    sub-pixel offsets, plus the level's 7x7 blur.  The (4, H, W) stack of
    dense maps (s_raw, s20, s7, blur) is ``maps`` when given (extract_orb
    computes the whole pyramid's in one K1 launch), else one K1 launch
    over this level (ops/cuda_fast.py)."""
    H, W = img_l.shape
    if maps is None:
        from orb_slam3_study_kr_tpu_torch.ops.cuda_fast import fast_nms_blur
        maps = fast_nms_blur(img_l.contiguous(), float(cfg.fast_min_threshold),
                             float(cfg.fast_threshold))
    s_raw, blurred = maps[0], maps[3]
    border = border_mask(H, W, EDGE_MARGIN - 3, img_l.device)
    s20, s7 = torch.where(border, maps[1:3], 0.0).unbind(0)
    xs, ys, resp, valid = select_keypoints(s20, s7, quota, cfg.cell_size,
                                           cfg.cell_topk)
    dxm, dym = subpixel_offset_maps(s_raw)
    # On a featureless level the zero-score ties can pick cells of the
    # padding beyond the level's edge (invalid keypoints); the read clamps
    # to the edge, as the reference's jnp gather does.
    yc, xc = ys.clamp(0, H - 1), xs.clamp(0, W - 1)
    return xs, ys, resp, valid, dxm[yc, xc], dym[yc, xc], blurred


def extract_orb(img, cfg: OrbConfig, with_pyramid: bool = False):
    """Full-pyramid ORB extraction on img's device.

    With with_pyramid=True additionally returns the (L, H, W) blurred
    pyramid stack (levels zero-padded to level-0 size) for KLT alignment."""
    from orb_slam3_study_kr_tpu_torch.ops.cuda_fast import fast_nms_blur_pyramid

    dev = img.device
    pyr = build_pyramid(img, cfg)
    maps = fast_nms_blur_pyramid(pyr, float(cfg.fast_min_threshold),
                                 float(cfg.fast_threshold))
    blur = [m[3] for m in maps]
    H0, W0 = cfg.height, cfg.width
    xs_l, ys_l, fx_l, fy_l, resp_l, valid_l, lvl_l, uv_l = \
        [], [], [], [], [], [], [], []
    for l in range(cfg.n_levels):
        q = cfg.level_quotas[l]
        if q == 0:
            continue
        xs, ys, resp, valid, fx, fy, _ = extract_level(pyr[l], q, cfg, maps[l])
        # Pixel-centre alignment with the actual per-axis resize ratio.
        h_l, w_l = cfg.level_sizes[l]
        sx = _f32(W0 / w_l)
        sy = _f32(H0 / h_l)
        uv_l.append(torch.stack([(xs + fx + 0.5) * sx - 0.5,
                                 (ys + fy + 0.5) * sy - 0.5], dim=-1))
        xs_l.append(xs)
        ys_l.append(ys)
        fx_l.append(fx)
        fy_l.append(fy)
        resp_l.append(resp)
        valid_l.append(valid)
        lvl_l.append(torch.full((q,), l, dtype=torch.int32, device=dev))
    xs = torch.cat(xs_l)
    ys = torch.cat(ys_l)
    fx = torch.cat(fx_l)
    fy = torch.cat(fy_l)
    lvl = torch.cat(lvl_l)

    R = SUPER_R

    def stack_padded(levels):
        out = []
        for l in range(cfg.n_levels):
            h, w = cfg.level_sizes[l]
            out.append(torch.nn.functional.pad(
                levels[l], (R, W0 + R - w, R, H0 + R - h)))
        return torch.stack(out)

    raw_sp = gather_windows(stack_padded(pyr), lvl, ys, xs, _SS)
    blur_sp = gather_windows(stack_padded(blur), lvl, ys, xs, _SS)

    angle = _orientation_from_patches(raw_sp)
    desc = _descriptors_from_patches(blur_sp, fy, fx, angle)
    patch = _oriented_patches_from_patches(blur_sp, fy, fx, angle).to(torch.uint8)

    feats = OrbFeatures(
        uv=torch.cat(uv_l),
        response=torch.cat(resp_l),
        angle=angle,
        level=lvl,
        desc=desc,
        valid=torch.cat(valid_l),
        patch=patch,
    )
    if with_pyramid:
        from orb_slam3_study_kr_tpu_torch.ops.klt import stack_pyramid
        return feats, stack_pyramid(blur)
    return feats
