"""Plain references of the extraction's dense stage: the image pyramid and
K1 (FAST score, two-threshold 3x3 NMS, 7x7 blur).

A frozen copy of the port's plain versions (``ops/orb.py``:
``_resize_weights_np``, ``build_pyramid``, ``fast_score_map``, ``nms3x3``,
``gaussian_blur7``; ``ops/cuda_fast.fast_nms_blur_plain``), which follow
the reference package's jnp path: a pyramid of antialiased linear resizes
(``jax.image.resize`` "linear"), FAST-9/16 with wrapping shifts, an
edge-clamped separable Gaussian.  ``dtype`` is the precision of the
arithmetic: float32 is what the configuration states, bfloat16 the
control's.
"""

import numpy as np
import torch

FAST_OFFSETS = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    np.int32)
G7 = np.exp(-0.5 * (np.arange(-3, 4, dtype=np.float64) / 2.0) ** 2)
G7 = (G7 / G7.sum()).astype(np.float32)
# K1's maps are compared on the interior: the kernel and the plain version
# may differ within this many pixels of a level's edge (wrapping shifts).
INTERIOR = 8


def level_sizes(height, width, n_levels, scale_factor):
    return [(int(round(height / scale_factor ** l)),
             int(round(width / scale_factor ** l))) for l in range(n_levels)]


def resize_weights(in_size, out_size):
    """(in, out) float64 weights of an antialiased linear resize along one
    axis: a triangle kernel widened by the downscale factor,
    column-normalised, zero for samples outside the input."""
    scale = out_size / in_size
    inv = np.float32(1.0 / scale)
    kscale = max(float(inv), 1.0)
    sample = ((np.arange(out_size) + 0.5) * np.float64(inv) - 0.5).astype(
        np.float32).astype(np.float64)
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def pyramid(img, sizes, dtype=torch.float64):
    """Levels of ``img`` (H, W): level l resized from level l - 1."""
    levels = [img.to(dtype)]
    for h, w in sizes[1:]:
        H, W = levels[-1].shape
        wy = torch.as_tensor(resize_weights(H, h), dtype=dtype,
                             device=img.device)
        wx = torch.as_tensor(resize_weights(W, w), dtype=dtype,
                             device=img.device)
        levels.append((wy.T @ levels[-1]) @ wx)
    return levels


def fast_score(img, th_min):
    circ = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dy, dx in FAST_OFFSETS], dim=0)
    bright = circ - img[None]

    def arc(d):
        dd = torch.cat([d, d[:8]], dim=0)
        m = dd[:16]
        for k in range(1, 9):
            m = torch.minimum(m, dd[k:k + 16])
        return m.max(dim=0).values

    s = torch.maximum(arc(bright), arc(-bright))
    return torch.where(s > th_min, s, torch.zeros_like(s))


def nms3x3(s):
    neigh = torch.full_like(s, -float("inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.maximum(neigh, torch.roll(s, (dy, dx),
                                                        dims=(0, 1)))
    return torch.where((s >= neigh) & (s > 0), s, torch.zeros_like(s))


def blur7(img):
    H, W = img.shape
    g = [float(v) for v in G7]
    pad = torch.nn.functional.pad(img[None, None], (3, 3, 0, 0),
                                  mode="replicate")[0, 0]
    h = g[0] * pad[:, 0:W]
    for i in range(1, 7):
        h = h + g[i] * pad[:, i:i + W]
    hp = torch.nn.functional.pad(h[None, None], (0, 0, 3, 3),
                                 mode="replicate")[0, 0]
    v = g[0] * hp[0:H]
    for i in range(1, 7):
        v = v + g[i] * hp[i:i + H]
    return v


def k1(level, th_min, th_ini, dtype=torch.float32):
    """(4, H, W) stack (s_raw, s20, s7, blur) of one level."""
    x = level.to(dtype)
    s_raw = fast_score(x, th_min)
    s20 = torch.where(s_raw > th_ini, s_raw, torch.zeros_like(s_raw))
    return torch.stack([s_raw, nms3x3(s20), nms3x3(s_raw), blur7(x)])


def compare_k1(levels, maps, th_min, th_ini, dtype=torch.float32):
    """(interior map pixels that differ, max |blur - reference blur|) of
    K1's maps over one pyramid."""
    bad, err = 0, 0.0
    i = INTERIOR
    for level, m in zip(levels, maps):
        r = k1(level, th_min, th_ini, dtype).to(torch.float32)
        bad += int((m[:3, i:-i, i:-i] != r[:3, i:-i, i:-i]).sum())
        err = max(err, float((m[3].double() - r[3].double()).abs().max()))
    return bad, err


def compare_pyramid(img, levels, sizes, dtype=torch.float64):
    """max |program level - reference level| over a pyramid."""
    ref = pyramid(img, sizes, dtype)
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(levels, ref))
