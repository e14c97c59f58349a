"""Rectified stereo keypoint matching with sub-pixel disparity refinement.

Counterpart of ``orb_slam3_study_kr_tpu/ops/stereo.py``
(Frame::ComputeStereoMatches): for each left keypoint, right candidates in
a +-2 * 1.2^level row band, inside the disparity range and within one
pyramid level are scored by Hamming distance (gate 75), the best match
must be mutual (the right keypoint's own best left keypoint, by column
argmin), and its column is refined by an 11x11 SAD over a +-5 px slide on
the level-0 images with a parabola through the minimum.  Border minima and
SADs above 1.5 * 1.4 * the median of the accepted SADs are rejected.

All of it is tensor work on the images' device: one masked (NL, NR)
distance matrix with its row and column argmins, and one batched gather of
(NL, 11, 21) strips from the zero-padded images for the SAD sweep.  The
function has no hand-written kernel: the JAX reference computes it outside
Pallas as well.

Outputs per left keypoint: u_r (refined right column at level 0) and depth
(z = fx * baseline / disparity), -1 where unmatched (mvuRight / mvDepth).
"""

import torch

from orb_slam3_study_kr_tpu_torch.ops.matching import BIG, hamming_matrix

DESC_GATE = 75.0   # (TH_HIGH + TH_LOW) / 2
SAD_WIN = 5        # 11x11 window
SLIDE = 5          # +-5 px sub-pixel search


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def nanmedian_midpoint(x, ok):
    """Median of x[ok] with an even count averaging the two middle values
    (``jnp.nanmedian``'s midpoint rule; ``torch.nanmedian`` returns the
    lower one); +inf when nothing is accepted.  No host synchronisation."""
    srt = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf")))).values
    n = ok.sum()
    last = srt.shape[0] - 1
    lo = srt[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)]
    hi = srt[torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)]
    med = (lo + hi) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("inf")))


def match_stereo(uvL, levelL, descL, validL, uvR, levelR, descR, validR,
                 imgL, imgR, fx, baseline, min_disp=0.0, max_disp=200.0,
                 scale_factor=1.2):
    """uvL (NL, 2) / uvR (NR, 2) level-0 keypoint coordinates, levels,
    (N, 256) uint8 {0,1} descriptors, validity; imgL / imgR the level-0
    (H, W) float32 images; fx, baseline floats.

    Returns (u_r (NL,), depth (NL,), ok (NL,)) on the inputs' device."""
    dev = uvL.device
    band = 2.0 * torch.pow(_f32(scale_factor, dev), levelL.to(torch.float32))
    dv = torch.abs(uvL[:, 1:2] - uvR[None, :, 1])
    row_ok = dv <= band[:, None]
    disp = uvL[:, 0:1] - uvR[None, :, 0]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    dl = torch.abs(levelL.to(torch.int64)[:, None] - levelR.to(torch.int64)[None, :])
    mask = row_ok & disp_ok & (dl <= 1) & validL[:, None] & validR[None, :]

    d = torch.where(mask, hamming_matrix(descL, descR),
                    torch.full(mask.shape, BIG, dtype=torch.float32, device=dev))
    # argmin returns the first index of a tie on both devices, as
    # jnp.argmin does; the mutual check compares indices.
    idxR = torch.argmin(d, dim=1)
    ok = d.gather(1, idxR[:, None])[:, 0] <= DESC_GATE
    bestL_of_R = torch.argmin(d, dim=0)
    ok = ok & (bestL_of_R[idxR] == torch.arange(d.shape[0], device=dev))

    # --- SAD sub-pixel refinement around the matched right column ---
    H, Wimg = imgL.shape
    P = SAD_WIN + SLIDE
    uL = torch.clamp(torch.round(uvL[:, 0]).to(torch.int64), P, Wimg - P - 1)
    vL = torch.clamp(torch.round(uvL[:, 1]).to(torch.int64), SAD_WIN,
                     H - SAD_WIN - 1)
    uR0 = torch.clamp(torch.round(uvR[idxR, 0]).to(torch.int64), P,
                      Wimg - P - 1)
    padL = torch.nn.functional.pad(imgL, (P, P, P, P))
    padR = torch.nn.functional.pad(imgR, (P, P, P, P))
    win = torch.arange(-SAD_WIN, SAD_WIN + 1, device=dev)
    wide = torch.arange(-P, P + 1, device=dev)
    rows = (vL[:, None] + win + P)[:, :, None]                  # (N, 11, 1)
    tl = padL[rows, (uL[:, None] + win + P)[:, None, :]]        # (N, 11, 11)
    strip = padR[rows, (uR0[:, None] + wide + P)[:, None, :]]   # (N, 11, 21)
    tl = tl - tl[:, SAD_WIN:SAD_WIN + 1, SAD_WIN:SAD_WIN + 1]
    # (N, 11 offsets, 11 rows, 11 cols): window o starts at strip column o.
    wins = strip.unfold(2, 2 * SAD_WIN + 1, 1).permute(0, 2, 1, 3)
    wins = wins - wins[..., SAD_WIN:SAD_WIN + 1, SAD_WIN:SAD_WIN + 1]
    # Fixed summation order: along each row, then over the rows.
    sads = torch.abs(tl[:, None] - wins).sum(dim=-1).sum(dim=-1)   # (N, 11)
    k = torch.argmin(sads, dim=1)
    km = torch.clamp(k, 1, 2 * SLIDE - 1)
    c = sads.gather(1, km[:, None])[:, 0]
    lft = sads.gather(1, (km - 1)[:, None])[:, 0]
    rgt = sads.gather(1, (km + 1)[:, None])[:, 0]
    denom = 2.0 * c - lft - rgt
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (rgt - lft) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    u_r_ref = ((uR0 + SLIDE).to(torch.float32) - SLIDE
               + (km - SLIDE).to(torch.float32) + delta)
    # Border minimum = ambiguous correlation; |delta| at the clip likewise.
    sharp = (k > 0) & (k < 2 * SLIDE) & (torch.abs(delta) < 1.0)
    ok = ok & sharp
    # Tail cull: SAD above 1.5 * 1.4 * the median of the accepted SADs.
    med = nanmedian_midpoint(c, ok)
    ok = ok & (c <= 1.5 * 1.4 * med)
    disparity = uvL[:, 0] - u_r_ref
    ok = ok & (disparity > max(min_disp, 1e-3)) & (disparity < max_disp)
    bf = _f32(fx, dev) * _f32(baseline, dev)
    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-6),
                        torch.full_like(disparity, -1.0))
    u_r_out = torch.where(ok, u_r_ref, torch.full_like(u_r_ref, -1.0))
    return u_r_out, depth, ok


def depth_to_virtual_right(u, depth, fx, baseline):
    """RGB-D: the virtual right coordinate from measured depth
    (Frame::ComputeStereoFromRGBD).  Returns (u_r, ok)."""
    ok = depth > 0
    bf = torch.as_tensor(fx * baseline, dtype=u.dtype, device=u.device)
    u_r = torch.where(ok, u - bf / torch.clamp(depth, min=1e-6),
                      torch.full_like(u, -1.0))
    return u_r, ok
