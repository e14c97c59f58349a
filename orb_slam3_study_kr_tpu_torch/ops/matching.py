"""Binary-descriptor matching: Hamming distance matrices plus the gate stack
(distance thresholds, Lowe ratio, rotation-consistency histogram, windowed
search masks, mutual-best checks).

Counterpart of ``orb_slam3_study_kr_tpu/ops/matching.py``.  The Hamming
matrix is a float32 matmul of {0,1} descriptors (TF32 off): sums of 0/1
products up to 256 are exact in float32, so distances are exact integers.
"""

import math

import torch

TH_HIGH = 100.0
TH_LOW = 50.0
HISTO_LENGTH = 30
BIG = 1e9


def hamming_matrix(desc1, desc2):
    """(..., N1, 256) x (..., N2, 256) uint8 {0,1} -> (..., N1, N2) f32."""
    a = desc1.to(torch.float32)
    b = desc2.to(torch.float32)
    dot = torch.matmul(a, b.transpose(-1, -2))
    return a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * dot


def _excl_min(d, idx, dim):
    """min of d along dim with the entry at idx (first argmin) set to BIG."""
    n = d.shape[dim]
    ar = torch.arange(n, device=d.device)
    if dim == -1:
        excl = ar == idx[..., None]
    else:
        excl = ar[:, None] == idx[..., None, :]
    return torch.where(excl, torch.full_like(d, BIG), d).min(dim=dim).values


def masked_nn(dist, mask, max_dist=TH_LOW, nn_ratio=None):
    """Row-wise nearest neighbour under a boolean mask.
    Returns (match_idx (N1,), match_dist (N1,), ok (N1,))."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    ok = best <= max_dist
    if nn_ratio is not None:
        second = _excl_min(d, idx, -1)
        ok = ok & (best < nn_ratio * second)
    return idx, best, ok


def mutual_best(idx12, ok12, idx21):
    """Keep matches where row i's best j maps back to i."""
    back = torch.gather(idx21, -1, idx12)
    ar = torch.arange(idx12.shape[-1], device=idx12.device)
    return ok12 & (back == ar)


def rotation_consistency(angle1, angle2, idx, ok):
    """Three-maxima rotation histogram filter (30 bins; a bin must be among
    the 3 most populated and hold > 0.1x the max bin)."""
    rot = angle1 - torch.gather(angle2, -1, idx)
    two_pi = 2 * math.pi
    rot = torch.where(rot < 0, rot + two_pi, rot)
    bin_f = rot * (HISTO_LENGTH / two_pi)
    bins = torch.clamp(torch.round(bin_f).to(torch.int64), 0,
                       HISTO_LENGTH) % HISTO_LENGTH
    counts = torch.zeros((*ok.shape[:-1], HISTO_LENGTH), dtype=torch.float32,
                         device=ok.device)
    counts = counts.scatter_add(-1, bins, ok.to(torch.float32))
    top3 = torch.topk(counts, 3, dim=-1).values
    cb = torch.gather(counts, -1, bins)
    keep_bin = (cb >= top3[..., 2:3]) & (cb > 0.1 * top3[..., 0:1])
    return ok & keep_bin


def window_mask(uv1, uv2, radius):
    """(N1, N2) mask: |uv2 - uv1| within a square radius."""
    d = torch.abs(uv1[..., :, None, :] - uv2[..., None, :, :])
    return (d[..., 0] <= radius) & (d[..., 1] <= radius)


def scale_band_mask(level1, level2, min_delta=-1, max_delta=1):
    """(N1, N2) mask over octave compatibility (SearchByProjection keeps a
    candidate level within [predicted - 1, predicted + 1])."""
    d = level2[None, :] - level1[:, None]
    return (d >= min_delta) & (d <= max_delta)


def search_for_initialization(
    f1_uv, f1_desc, f1_angle, f1_valid,
    f2_uv, f2_desc, f2_angle, f2_valid,
    window_radius=100.0, nn_ratio=0.9, check_rotation=True, mutual=True,
):
    """Windowed descriptor matching between two frames (window search,
    TH_LOW, ratio test, mutual best, rotation histogram).
    Returns (idx2 (N1,), ok (N1,), dist (N1,))."""
    dist = hamming_matrix(f1_desc, f2_desc)
    mask = (f1_valid[:, None] & f2_valid[None, :]
            & window_mask(f1_uv, f2_uv, window_radius))
    idx, best, ok = masked_nn(dist, mask, TH_LOW, nn_ratio)
    if mutual:
        d_t = torch.where(mask, dist, torch.full_like(dist, BIG)).T
        idx21 = torch.argmin(d_t, dim=1)
        ok = mutual_best(idx, ok, idx21)
    if check_rotation:
        ok = rotation_consistency(f1_angle, f2_angle, idx, ok)
    return idx, ok, best
