"""Absolute trajectory error, method-compatible with the reference's
evaluation/evaluate_ate_scale.py (Horn 1987 closed-form alignment via SVD of
the correlation matrix, optional similarity scale for monocular, RMSE over
aligned positions) and associate.py (nearest-timestamp matching).

Written from the published method, not ported: same inputs, same metric.
"""

import numpy as np


def associate(ts_a, ts_b, max_dt=0.02):
    """Greedy nearest-timestamp matching.  Returns index pairs (ia, ib)."""
    ia = []
    ib = []
    j = 0
    order = np.argsort(ts_b)
    tsb = np.asarray(ts_b)[order]
    for i, t in enumerate(ts_a):
        j = np.searchsorted(tsb, t)
        best = None
        for cand in (j - 1, j):
            if 0 <= cand < tsb.shape[0]:
                dt = abs(tsb[cand] - t)
                if dt <= max_dt and (best is None or dt < best[1]):
                    best = (cand, dt)
        if best is not None:
            ia.append(i)
            ib.append(order[best[0]])
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def align_horn(model, data, with_scale=False):
    """Align `model` (3, N) onto `data` (3, N).

    Returns (R (3,3), t (3,1), s float) minimizing || s R model + t - data ||.
    """
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d
    W = dc @ mc.T
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc * mc).sum()
        s = float(np.trace(np.diag(S) @ D) / max(var_m, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return R, t, s


def ate_rmse(est_ts, est_xyz, gt_ts, gt_xyz, with_scale=True, max_dt=0.02):
    """RMS ATE between estimated and ground-truth trajectories.

    est_xyz / gt_xyz: (N, 3).  Returns (rmse, n_matched, scale)."""
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if ia.size < 3:
        return np.inf, int(ia.size), 1.0
    model = np.asarray(est_xyz)[ia].T
    data = np.asarray(gt_xyz)[ib].T
    R, t, s = align_horn(model, data, with_scale)
    aligned = s * R @ model + t
    err = aligned - data
    rmse = float(np.sqrt((err * err).sum(axis=0).mean()))
    return rmse, int(ia.size), s
