"""Monocular two-view initialization: batched RANSAC over homography and
fundamental hypotheses, model selection, and motion recovery.

Counterpart of ``orb_slam3_study_kr_tpu/cameras/twoview.py``: all 200
hypotheses of each model are built with one batched SVD and scored against
all N matches at once; the 4 essential and 8 Faugeras homography motion
candidates are verified by one batched triangulation.  Thresholds: chi2
5.991 / 3.841 at sigma = 1, model select SH/(SH+SF) > 0.5, cheirality +
parallax gating.  A singular system gives NaN, as in the reference
(``solvers/linalg_nan``: every solve, inverse and SVD here).  The minimal
sets are drawn with a torch.Generator, or passed in (tests inject the
reference's jax.random draws).
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3, hat
from orb_slam3_study_kr_tpu_torch.ops.geometry import triangulate_dlt
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, solve_nan, svd_nan

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991
RANSAC_ITERS = 200
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0
COS_PARALLAX_INF = 0.99998


def _normalize_points(kp, mask):
    """Zero-mean / unit mean-abs-dev normalization (DLT conditioning)."""
    n = torch.clamp(mask.sum(), min=1.0)
    mean = torch.sum(kp * mask[:, None], dim=0) / n
    mean_dev = torch.sum(torch.abs(kp - mean) * mask[:, None], dim=0) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-8)
    kp_n = (kp - mean) * s
    z = torch.zeros((), dtype=kp.dtype, device=kp.device)
    o = torch.ones((), dtype=kp.dtype, device=kp.device)
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return kp_n, T


def sample_minimal_sets(generator, mask, iters, k=8):
    """(iters, k) indices of valid matches, sampled without replacement:
    the k smallest of uniform draws with invalid matches pushed past 1.
    The draws come from `generator` on its own device (the host's, so that
    a seed gives the same sets on every device) and move to mask's."""
    n = mask.shape[0]
    u = torch.rand((iters, n), generator=generator,
                   device=generator.device).to(mask.device)
    u = torch.where(mask[None, :] > 0, u, torch.full_like(u, 2.0))
    return torch.argsort(u, dim=1)[:, :k]


def _null_vector(A):
    return svd_nan(A)[2][..., -1, :]


def _homography_dlt(p1, p2):
    """H21 from k point pairs (x2 ~ H x1): p1, p2 (..., k, 2) normalized."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    h = _null_vector(torch.cat([rows_a, rows_b], dim=-2))
    return h.reshape(*h.shape[:-1], 3, 3)


def _rank2(F):
    U, S, Vh = svd_nan(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vh)


def _fundamental_8pt(p1, p2):
    """F21 (x2^T F x1 = 0) from 8 pairs, rank-2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    return _rank2(F)


def _smallest_eigvec(A):
    M = A.T @ A
    return torch.linalg.eigh(M).eigenvectors[:, 0]


def _refit_homography(kp1n, kp2n, w):
    """Least-squares H21 over all weighted correspondences (smallest
    eigenvector of the 9x9 normal matrix)."""
    x1, y1 = kp1n[:, 0], kp1n[:, 1]
    x2, y2 = kp2n[:, 0], kp2n[:, 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    ra = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rb = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([ra * w[:, None], rb * w[:, None]], dim=0)
    return _smallest_eigvec(A).reshape(3, 3)


def _refit_fundamental(kp1n, kp2n, w):
    x1, y1 = kp1n[:, 0], kp1n[:, 1]
    x2, y2 = kp2n[:, 0], kp2n[:, 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    dim=-1) * w[:, None]
    return _rank2(_smallest_eigvec(A).reshape(3, 3))


def _apply_h(H, src):
    x, y = src[..., 0], src[..., 1]
    w = H[..., 2, 0:1] * x + H[..., 2, 1:2] * y + H[..., 2, 2:3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    u = (H[..., 0, 0:1] * x + H[..., 0, 1:2] * y + H[..., 0, 2:3]) / w
    v = (H[..., 1, 0:1] * x + H[..., 1, 1:2] * y + H[..., 1, 2:3]) / w
    return u, v


def _score_homography(H21, kp1, kp2, mask, sigma2):
    """Symmetric transfer error score (T,) and inliers (T, N)."""
    H12 = inv_nan(H21)
    u, v = _apply_h(H21, kp1[None])
    chi2_12 = ((kp2[None, :, 0] - u) ** 2 + (kp2[None, :, 1] - v) ** 2) / sigma2
    u, v = _apply_h(H12, kp2[None])
    chi2_21 = ((kp1[None, :, 0] - u) ** 2 + (kp1[None, :, 1] - v) ** 2) / sigma2
    in1 = chi2_12 < CHI2_H
    in2 = chi2_21 < CHI2_H
    zero = torch.zeros_like(chi2_12)
    score = (torch.where(in1, SCORE_TH - chi2_12, zero)
             + torch.where(in2, SCORE_TH - chi2_21, zero))
    score = torch.sum(score * mask[None], dim=-1)
    return score, in1 & in2 & (mask[None] > 0)


def _epi_dist2(F, src, dst):
    x, y = src[..., 0], src[..., 1]
    a = F[..., 0, 0:1] * x + F[..., 0, 1:2] * y + F[..., 0, 2:3]
    b = F[..., 1, 0:1] * x + F[..., 1, 1:2] * y + F[..., 1, 2:3]
    c = F[..., 2, 0:1] * x + F[..., 2, 1:2] * y + F[..., 2, 2:3]
    num = a * dst[..., 0] + b * dst[..., 1] + c
    return num * num / torch.clamp(a * a + b * b, min=1e-12)


def _score_fundamental(F21, kp1, kp2, mask, sigma2):
    """Epipolar-distance score (T,) and inliers (T, N)."""
    chi2_2 = _epi_dist2(F21, kp1[None], kp2[None]) / sigma2
    chi2_1 = _epi_dist2(F21.transpose(-1, -2), kp2[None], kp1[None]) / sigma2
    in2 = chi2_2 < CHI2_F
    in1 = chi2_1 < CHI2_F
    zero = torch.zeros_like(chi2_2)
    score = (torch.where(in2, SCORE_TH - chi2_2, zero)
             + torch.where(in1, SCORE_TH - chi2_1, zero))
    score = torch.sum(score * mask[None], dim=-1)
    return score, in1 & in2 & (mask[None] > 0)


def _check_rt(R21, t21, xn1, xn2, kp1, kp2, K, inliers, sigma2):
    """CheckRT for a batch of C candidate motions R21 (C, 3, 3), t21 (C, 3).
    Returns (n_good (C,), parallax_deg (C,), pts (C, N, 3), good (C, N))."""
    eye = torch.eye(3, dtype=R21.dtype, device=R21.device)
    zero = torch.zeros(3, dtype=R21.dtype, device=R21.device)
    pw = triangulate_dlt(xn1[None], xn2[None], eye, zero,
                         R21[:, None], t21[:, None])              # (C, N, 3)
    finite = torch.isfinite(pw).all(dim=-1)
    pw = torch.where(finite[..., None], pw, torch.zeros_like(pw))
    c2 = -torch.einsum("cji,cj->ci", R21, t21)
    r2 = pw - c2[:, None]
    n1 = torch.linalg.norm(pw, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = torch.sum(pw * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    z1 = pw[..., 2]
    p2 = torch.einsum("cij,cnj->cni", R21, pw) + t21[:, None]
    z2 = p2[..., 2]
    depth_ok = ((z1 > 0) & (z2 > 0)) | (cos_par >= COS_PARALLAX_INF)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def safe(z):
        return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)

    z1s, z2s = safe(z1), safe(z2)
    u1 = fx * pw[..., 0] / z1s + cx
    v1 = fy * pw[..., 1] / z1s + cy
    u2 = fx * p2[..., 0] / z2s + cx
    v2 = fy * p2[..., 1] / z2s + cy
    err1 = (u1 - kp1[None, :, 0]) ** 2 + (v1 - kp1[None, :, 1]) ** 2
    err2 = (u2 - kp2[None, :, 0]) ** 2 + (v2 - kp2[None, :, 1]) ** 2
    reproj_ok = (err1 < 4.0 * sigma2) & (err2 < 4.0 * sigma2)
    good = inliers[None] & finite & depth_ok & reproj_ok
    n_good = good.sum(dim=-1)
    # Parallax statistic: the 50th-smallest cos among good points.
    cos_masked = torch.where(good & (cos_par < COS_PARALLAX_INF), cos_par,
                             torch.ones_like(cos_par))
    cos_sorted = torch.sort(cos_masked, dim=-1).values
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=50)
    cos_at = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_at, -1.0, 1.0)))
    return n_good, parallax_deg, pw, good


def _w_matrix(like):
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _proper_svd(E):
    U, _, Vh = svd_nan(E)
    return U * torch.sign(torch.linalg.det(U)), Vh * torch.sign(torch.linalg.det(Vh))


def _refine_essential(E0, xn1, xn2, w, iters=8, damping=1e-4):
    """Gauss-Newton polish of the essential matrix over all inliers,
    minimizing Sampson error, parameterized through (R, t) of E0's own
    decomposition."""
    U, Vh = _proper_svd(E0)
    R0 = U @ _w_matrix(E0) @ Vh
    t0 = U[:, 2]
    x1h = torch.cat([xn1, torch.ones_like(xn1[:, :1])], dim=-1)
    x2h = torch.cat([xn2, torch.ones_like(xn2[:, :1])], dim=-1)

    def sampson(params):
        # (1, 3) rotation vector: a 0-d angle under jacfwd would promote
        # the small-angle series to float64.
        R = R0 @ exp_so3(params[None, :3])[0]
        t = t0 + params[3:]
        E = hat(t) @ R
        Ex1 = x1h @ E.T
        Etx2 = x2h @ E
        num = torch.sum(x2h * Ex1, dim=-1)
        denom = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / torch.sqrt(torch.clamp(denom, min=1e-12))

    eye6 = torch.eye(6, dtype=E0.dtype, device=E0.device)
    params = torch.zeros(6, dtype=E0.dtype, device=E0.device)
    for _ in range(iters):
        r = sampson(params)
        J = torch.func.jacfwd(sampson)(params)
        Jw = J * w[:, None]
        H = Jw.T @ J + damping * eye6
        params = params - solve_nan(H, Jw.T @ r)
    R = R0 @ exp_so3(params[:3])
    t = t0 + params[3:]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return hat(t) @ R


def _decompose_essential(E):
    """E -> (R1, R2, t): candidates (R1,t), (R1,-t), (R2,t), (R2,-t)."""
    U, Vh = _proper_svd(E)
    W = _w_matrix(E)
    t = U[:, 2]
    return U @ W @ Vh, U @ W.T @ Vh, t / torch.clamp(torch.linalg.norm(t), min=1e-12)


def _decompose_homography_faugeras(Hn):
    """8 candidate (R, t) motions from a calibrated homography (Faugeras &
    Lustman).  Returns R (8, 3, 3), t (8, 3) unit norm."""
    U, d, Vh = svd_nan(Hn)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=Hn.dtype, device=Hn.device)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=Hn.dtype, device=Hn.device)
    x1 = e1 * aux1
    x3 = e3 * aux3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    z = torch.zeros_like(d1)
    o = torch.ones_like(d1)
    Rs, ts = [], []
    for i in range(4):
        Rp = torch.stack([torch.stack([ct, z, -st[i]]), torch.stack([z, o, z]),
                          torch.stack([st[i], z, ct])])
        tp = (d1 - d3) * torch.stack([x1[i], z, -x3[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(U @ tp)
    for i in range(4):
        Rp = torch.stack([torch.stack([cp, z, sp[i]]), torch.stack([z, -o, z]),
                          torch.stack([sp[i], z, -cp])])
        tp = (d1 + d3) * torch.stack([x1[i], z, x3[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(U @ tp)
    t = torch.stack(ts)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack(Rs), t


def reconstruct_two_views(kp1, kp2, mask, K, sigma=1.0, iters=RANSAC_ITERS,
                          generator=None, sets=None):
    """Full monocular bootstrap.

    kp1, kp2 (N, 2) matched undistorted pixels; mask (N,) 1.0 for valid
    matches; K (3, 3).  The RANSAC minimal sets are ``sets = (idx_h, idx_f)``
    ((iters, 8) each) when given, else drawn from ``generator``.
    Returns a dict (success, R21, t21, pts3d, good, n_good,
    used_homography, parallax_deg, score_h, score_f) of tensors."""
    sigma2 = sigma * sigma
    kp1n, T1 = _normalize_points(kp1, mask)
    kp2n, T2 = _normalize_points(kp2, mask)
    T2inv = inv_nan(T2)
    if sets is None:
        idx_h = sample_minimal_sets(generator, mask, iters)
        idx_f = sample_minimal_sets(generator, mask, iters)
    else:
        idx_h, idx_f = (torch.tensor(s, device=kp1.device).long()
                        for s in sets)

    # --- Homography hypotheses ---
    H21_hyp = T2inv[None] @ _homography_dlt(kp1n[idx_h], kp2n[idx_h]) @ T1[None]
    h_scores, h_inliers = _score_homography(H21_hyp, kp1, kp2, mask, sigma2)
    h_best = torch.argmax(h_scores)
    h_inl0 = h_inliers[h_best]
    H21_refit = T2inv @ _refit_homography(kp1n, kp2n, h_inl0.to(kp1.dtype)) @ T1
    h_score_r, h_inl_r = _score_homography(H21_refit[None], kp1, kp2, mask, sigma2)
    better_h = h_score_r[0] > h_scores[h_best]
    SH = torch.where(better_h, h_score_r[0], h_scores[h_best])
    H21 = torch.where(better_h, H21_refit, H21_hyp[h_best])
    h_inl = torch.where(better_h, h_inl_r[0], h_inl0)

    # --- Fundamental hypotheses ---
    F21_hyp = T2.T[None] @ _fundamental_8pt(kp1n[idx_f], kp2n[idx_f]) @ T1[None]
    f_scores, f_inliers = _score_fundamental(F21_hyp, kp1, kp2, mask, sigma2)
    f_best = torch.argmax(f_scores)
    f_inl0 = f_inliers[f_best]
    F21_refit = T2.T @ _refit_fundamental(kp1n, kp2n, f_inl0.to(kp1.dtype)) @ T1
    f_score_r, f_inl_r = _score_fundamental(F21_refit[None], kp1, kp2, mask, sigma2)
    better_f = f_score_r[0] > f_scores[f_best]
    SF = torch.where(better_f, f_score_r[0], f_scores[f_best])
    F21 = torch.where(better_f, F21_refit, F21_hyp[f_best])
    f_inl = torch.where(better_f, f_inl_r[0], f_inl0)

    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.50

    Kinv = inv_nan(K)
    c = torch.stack([K[0, 2], K[1, 2]])
    f = torch.stack([K[0, 0], K[1, 1]])
    xn1 = (kp1 - c) / f
    xn2 = (kp2 - c) / f

    E21 = _refine_essential(K.T @ F21 @ K, xn1, xn2, f_inl.to(kp1.dtype))
    R1e, R2e, te = _decompose_essential(E21)
    R_ess = torch.stack([R1e, R1e, R2e, R2e])
    t_ess = torch.stack([te, -te, te, -te])
    R_hom, t_hom = _decompose_homography_faugeras(Kinv @ H21 @ K)
    R_all = torch.cat([R_ess, R_hom], dim=0)
    t_all = torch.cat([t_ess, t_hom], dim=0)
    fam_inl = torch.where(use_h, h_inl, f_inl)

    n_good, par_deg, pts, goods = _check_rt(R_all, t_all, xn1, xn2, kp1, kp2,
                                            K, fam_inl, sigma2)
    is_h = torch.arange(12, device=kp1.device) >= 4
    fam_mask = torch.where(use_h, is_h, ~is_h)
    n_good_m = torch.where(fam_mask, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good_m)
    best_good = n_good_m[best]
    second = torch.sort(n_good_m).values[-2]
    n_inl = fam_inl.sum()
    min_good = torch.clamp((0.9 * n_inl.to(torch.float32)).to(torch.int64),
                           min=MIN_TRIANGULATED)
    ok = ((best_good >= min_good)
          & (second.to(torch.float32) < 0.75 * best_good.to(torch.float32))
          & (par_deg[best] > MIN_PARALLAX_DEG))
    return dict(success=ok, R21=R_all[best], t21=t_all[best], pts3d=pts[best],
                good=goods[best], n_good=best_good, used_homography=use_h,
                parallax_deg=par_deg[best], score_h=SH, score_f=SF)

