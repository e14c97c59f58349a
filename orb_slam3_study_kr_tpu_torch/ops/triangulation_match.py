"""Epipolar-constrained matching + triangulation between keyframes.

Counterpart of ``orb_slam3_study_kr_tpu/ops/triangulation_match.py``
(SearchForTriangulation + the gating core of CreateNewMapPoints): one
masked Hamming problem per keyframe pair with an epipolar gate, one batched
ray triangulation, and the acceptance gates (parallax, cheirality,
reprojection chi2 5.991 x sigma2, scale consistency) as masks.  The
neighbour axis of the reference's vmap is a leading batch axis here.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import hat
from orb_slam3_study_kr_tpu_torch.ops.geometry import triangulate_rays
from orb_slam3_study_kr_tpu_torch.ops.matching import (
    BIG, TH_LOW, hamming_matrix, rotation_consistency)

CHI2_MONO = 5.991
EPI_CHI2 = 3.84
MIN_PARALLAX_COS = 0.9998


def _unit(b):
    return b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)


def match_and_triangulate(
    R1, t1, R2, t2, project_fn, focal,
    uv1, b1, level1, desc1, free1,
    uv2, b2, level2, desc2, free2,
    angle1=None, angle2=None,
    scale_factor=1.2, epi_chi2=EPI_CHI2, nn_ratio=0.9,
):
    """One keyframe pair: match the free keypoints of KF1 against KF2 along
    epipolar planes and triangulate the accepted pairs; without angles no
    rotation check.  Returns dict idx2, matched, X, good, cos_par per kp1."""
    out = _match_pairs(R1, t1, R2[None], t2[None], project_fn, focal,
                       uv1, b1, level1, desc1, free1, uv2[None], b2[None],
                       level2[None], desc2[None], free2[None], angle1,
                       None if angle2 is None else angle2[None],
                       scale_factor, epi_chi2, nn_ratio)
    return {k: v[0] for k, v in out.items()}


def match_and_triangulate_batch(
    R1, t1, R2s, t2s, project_fn, focal,
    uv1, b1, level1, desc1, free1,
    uv2s, b2s, level2s, desc2s, free2s,
    angle1, angle2s,
    scale_factor=1.2, epi_chi2=EPI_CHI2, nn_ratio=0.9,
):
    """Match free keypoints of KF1 against NB neighbour keyframes along
    epipolar planes and triangulate the accepted pairs.

    KF1 arrays (N1, ...); neighbour arrays (NB, N2, ...), poses R2s (NB,3,3),
    t2s (NB, 3).  Returns dict idx2 (NB, N1), X (NB, N1, 3), good (NB, N1)."""
    out = _match_pairs(R1, t1, R2s, t2s, project_fn, focal,
                       uv1, b1, level1, desc1, free1,
                       uv2s, b2s, level2s, desc2s, free2s, angle1, angle2s,
                       scale_factor, epi_chi2, nn_ratio)
    return {k: out[k] for k in ("idx2", "X", "good")}


def _match_pairs(R1, t1, R2s, t2s, project_fn, focal,
                 uv1, b1, level1, desc1, free1,
                 uv2s, b2s, level2s, desc2s, free2s, angle1, angle2s,
                 scale_factor, epi_chi2, nn_ratio):
    NB = R2s.shape[0]
    n1 = uv1.shape[0]
    dev = uv1.device
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    b1n = _unit(b1)
    b2n = _unit(b2s)

    R12 = R1 @ R2s.transpose(-1, -2)                       # (NB, 3, 3)
    t12 = t1 - torch.einsum("bij,bj->bi", R12, t2s)
    E = hat(t12) @ R12
    l2 = _unit(torch.einsum("nc,bcd->bnd", b1n, E))      # (NB, N1, 3)
    sin_d = torch.einsum("bac,bnc->ban", l2, b2n)          # (NB, N1, N2)
    d2 = (focal * focal) * sin_d * sin_d
    sigma2_2 = torch.pow(sf, 2.0 * level2s.to(torch.float32))   # (NB, N2)
    epi_ok = d2 < epi_chi2 * sigma2_2[:, None, :]

    mask = epi_ok & free1[None, :, None] & free2s[:, None, :]
    dist = hamming_matrix(desc1[None], desc2s)
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx2 = torch.argmin(d, dim=2)                          # (NB, N1)
    best = d.min(dim=2).values
    n2 = d.shape[2]
    excl = torch.arange(n2, device=dev) == idx2[..., None]
    second = torch.where(excl, torch.full_like(d, BIG), d).min(dim=2).values
    matched = (best <= TH_LOW) & (best < nn_ratio * second)
    back = torch.argmin(d, dim=1)                          # (NB, N2)
    matched = matched & (torch.gather(back, 1, idx2)
                         == torch.arange(n1, device=dev))
    if angle1 is not None:
        matched = rotation_consistency(angle1.expand(NB, n1), angle2s, idx2,
                                       matched)

    gidx = idx2[..., None].expand(NB, n1, 3)
    b2m = torch.gather(b2n, 1, gidx)
    X = triangulate_rays(b1n[None], b2m, R1, t1, R2s[:, None], t2s[:, None])

    c1 = -R1.T @ t1
    c2 = -torch.einsum("bji,bj->bi", R2s, t2s)
    r1v = X - c1
    r2v = X - c2[:, None]
    nr1 = torch.linalg.norm(r1v, dim=-1)
    nr2 = torch.linalg.norm(r2v, dim=-1)
    cos_par = torch.sum(r1v * r2v, dim=-1) / torch.clamp(nr1 * nr2, min=1e-12)
    p1 = torch.einsum("ij,bnj->bni", R1, X) + t1
    p2 = torch.einsum("bij,bnj->bni", R2s, X) + t2s[:, None]
    z_ok = (torch.sum(p1 * b1n, dim=-1) > 0) & (torch.sum(p2 * b2m, dim=-1) > 0)

    uv2m = torch.gather(uv2s, 1, idx2[..., None].expand(NB, n1, 2))
    e1 = torch.sum((project_fn(p1) - uv1) ** 2, dim=-1)
    e2 = torch.sum((project_fn(p2) - uv2m) ** 2, dim=-1)
    lvl1 = level1.to(torch.float32)
    lvl2m = torch.gather(level2s, 1, idx2).to(torch.float32)
    sigma2_1 = torch.pow(sf, 2.0 * lvl1)
    reproj_ok = ((e1 < CHI2_MONO * sigma2_1)
                 & (e2 < CHI2_MONO * torch.gather(sigma2_2, 1, idx2)))
    ratio_dist = nr2 / torch.clamp(nr1, min=1e-9)
    ratio_oct = torch.pow(sf, lvl1 - lvl2m)
    sc_ok = (ratio_dist < ratio_oct * 1.5) & (ratio_dist * 1.5 > ratio_oct)
    good = (matched & z_ok & (cos_par < MIN_PARALLAX_COS) & (cos_par > 0)
            & reproj_ok & sc_ok & torch.isfinite(X).all(dim=-1))
    return dict(idx2=idx2, matched=matched, X=X, good=good, cos_par=cos_par)
