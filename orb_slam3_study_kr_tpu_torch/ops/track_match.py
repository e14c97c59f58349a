"""Projection-guided matching for tracking (the SearchByProjection family).

Counterpart of ``orb_slam3_study_kr_tpu/ops/track_match.py``.  One path per
op: the gated nearest-neighbour search goes through K2
(``ops/cuda_matching.gated_nn``) and descriptor-only matching through K3
(``ops/cuda_hamming.hamming_nn_match``); each is the CUDA kernel on the card
and the dense masked Hamming matrix on the CPU.  Gate constants: distance band
[0.8 min, 1.2 max], viewing-angle cos > 0.5, radius 2.5 / 4.0 by view angle
(x th), per-level radius scaling, TH_HIGH acceptance.
"""

import torch

from orb_slam3_study_kr_tpu_torch.ops.cuda_hamming import hamming_nn_match
from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import gated_nn
from orb_slam3_study_kr_tpu_torch.ops.matching import (BIG, TH_HIGH, _excl_min,
                                                       hamming_matrix)

VIEW_COS_LIMIT = 0.5


def _f32_tensor(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def project_landmarks(project_fn, R_cw, t_cw, lm_pos, lm_normal, lm_min_dist,
                      lm_max_dist, lm_mask, width, height, scale_factor=1.2,
                      n_levels=8, max_theta_deg=None):
    """Frustum + band + view-angle visibility and predicted level for all
    landmarks; leading batch axes of R_cw/t_cw/lm_mask broadcast.
    ``max_theta_deg`` (a wide-FOV lens: half its FOV) replaces the pinhole
    z > 0.01 gate by theta < max_theta_deg and |p| > 1e-3, so points past
    90 degrees off-axis stay visible.
    Returns (uv (..., L, 2), visible (..., L), pred_level (..., L) int32,
    view_cos (..., L))."""
    p = torch.einsum("...ij,...lj->...li", R_cw, lm_pos) + t_cw[..., None, :]
    if max_theta_deg is None:
        z_ok = p[..., 2] > 0.01
    else:
        theta = torch.atan2(torch.linalg.norm(p[..., :2], dim=-1), p[..., 2])
        z_ok = (theta < torch.deg2rad(_f32_tensor(max_theta_deg, p))) & (
            torch.linalg.norm(p, dim=-1) > 1e-3)
    uv = project_fn(p)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < height))
    center = -torch.einsum("...ji,...j->...i", R_cw, t_cw)
    vec = lm_pos - center[..., None, :]
    dist = torch.linalg.norm(vec, dim=-1)
    band = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    view_cos = torch.sum(vec * lm_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    angle_ok = view_cos > VIEW_COS_LIMIT
    visible = z_ok & in_img & band & angle_ok & (lm_mask > 0)
    ratio = lm_max_dist / torch.clamp(dist, min=1e-9)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                      / torch.log(_f32_tensor(scale_factor, ratio)))
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)
    return uv, visible, pred, view_cos


def _search_radius(view_cos, pred, th, scale_factor):
    """2.5 px if well-aligned view else 4.0, times th, times the predicted
    level's scale (ORBmatcher::RadiusByViewingCos)."""
    base_r = torch.where(view_cos > 0.998, 2.5, 4.0) * th
    return base_r * torch.pow(_f32_tensor(scale_factor, view_cos),
                              pred.to(torch.float32))


def match_local_map(
    project_fn, R_cw, t_cw,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
    f_uv, f_level, f_desc, f_valid,
    width, height, th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    level_slack=1, max_dist=TH_HIGH, max_theta_deg=None,
):
    """SearchByProjection(Frame, vector<MapPoint*>, th): track-local-map.

    Optional leading batch axis on R_cw, t_cw, lm_mask and f_* (the
    landmark block is shared).  lm_desc and f_desc are (..., 256) uint8
    bits or (..., 8) int32 words (``cuda_matching.pack_desc``); a caller
    that matches the same descriptors again passes words packed once.
    ``max_theta_deg`` as in project_landmarks.
    Returns per-keypoint (lm_slot (..., N) int64, ok (..., N), visible
    (..., L))."""
    uv_proj, visible, pred, view_cos = project_landmarks(
        project_fn, R_cw, t_cw, lm_pos, lm_normal, lm_min_dist, lm_max_dist,
        lm_mask, width, height, scale_factor, n_levels, max_theta_deg)
    radius = _search_radius(view_cos, pred, th, scale_factor)
    best, second, lm_slot = gated_nn(
        f_desc, f_uv, f_level, f_valid,
        lm_desc, uv_proj, radius, pred, visible, level_slack=level_slack)
    lm_slot = lm_slot.long()
    ok = (best <= max_dist) & (best < nn_ratio * second) & f_valid
    # One keypoint per landmark: among keypoints that picked the same
    # landmark keep the lowest-distance one, index as tie-break.
    n = f_uv.shape[-2]
    L = lm_pos.shape[0]
    key = torch.where(
        ok, best * (n + 1) + torch.arange(n, dtype=best.dtype, device=best.device),
        torch.full_like(best, BIG))
    min_key = torch.full((*key.shape[:-1], L), BIG, dtype=key.dtype,
                         device=key.device).scatter_reduce(
        -1, lm_slot, key, reduce="amin", include_self=True)
    ok = ok & (key <= torch.gather(min_key, -1, lm_slot))
    return lm_slot, ok, visible


def match_local_map_batch(
    project_fn, R_cws, t_cws,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_masks,
    f_uvs, f_levels, f_descs, f_valids,
    width, height, th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    level_slack=1, max_dist=100.0, max_theta_deg=None,
):
    """Fuse-style projection matching of ONE shared landmark block into MANY
    target keyframes: the leading (neighbour) axis of R_cws/t_cws/lm_masks/
    f_* is a batch axis of one K2 launch.  Pad unused neighbour slots with
    lm_mask=0 / f_valid=False rows."""
    return match_local_map(
        project_fn, R_cws, t_cws, lm_pos, lm_normal, lm_min_dist,
        lm_max_dist, lm_desc, lm_masks, f_uvs, f_levels, f_descs, f_valids,
        width, height, th=th, nn_ratio=nn_ratio, scale_factor=scale_factor,
        n_levels=n_levels, level_slack=level_slack, max_dist=max_dist,
        max_theta_deg=max_theta_deg)


def match_by_descriptor(q_desc, q_valid, t_desc, t_valid, max_dist=50.0,
                        nn_ratio=0.75):
    """Unconstrained descriptor matching with ratio + mutual check (the
    dense stand-in for SearchByBoW), as one K3 launch: its rows give
    (idx, best, second) for the ratio test, its columns each target's best
    query for the mutual check, both from the same masked matrix, so idx
    is 0 on invalid rows.

    q_desc (Q, 256) uint8 bits (or (Q, 8) int32 words) / q_valid (Q,),
    t_desc (T, 256) or (T, 8) / t_valid (T,); either side may carry a
    leading batch axis (the loop window: one query set against (W, T)
    targets in the same launch).  Returns (idx (..., Q) int64, ok (..., Q)
    bool, best (..., Q) f32)."""
    best, second, idx, back = hamming_nn_match(
        q_desc.contiguous(), q_valid.contiguous(), t_desc.contiguous(),
        t_valid.contiguous())
    idx = idx.long()
    ok = (best <= max_dist) & (best < nn_ratio * second)
    ar = torch.arange(idx.shape[-1], device=idx.device)
    ok = ok & (torch.gather(back.long(), -1, idx) == ar)
    return idx, ok, best


def match_by_descriptor_plain(q_desc, q_valid, t_desc, t_valid, max_dist=50.0,
                              nn_ratio=0.75):
    """The dense masked-matrix form of match_by_descriptor (the reference's
    jnp expression, leading axes broadcast); tests hold the K3 route to
    it."""
    dist = hamming_matrix(q_desc, t_desc)
    mask = q_valid[..., :, None] & t_valid[..., None, :]
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    second = _excl_min(d, idx, -1)
    ok = (best <= max_dist) & (best < nn_ratio * second)
    back = torch.argmin(d, dim=-2)
    ar = torch.arange(idx.shape[-1], device=d.device)
    ok = ok & (torch.gather(back, -1, idx) == ar)
    return idx, ok, best
