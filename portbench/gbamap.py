"""The map of a long stereo session, built on the card from the seed, for
the global-BA cell.

A structured version of the port's BA bench problem
(``parallel/bench_scaling.build_problem``), which draws uniform random
pose-landmark pairs: here the keyframes lie on a continuous path and each
landmark is seen by a run of ``track_len`` neighbouring keyframes, the
banded structure a tracked session leaves.  The path is a closed ring: the
last keyframes see the first keyframes' landmarks, as the map holds them
after a loop correction has fused the revisit, which is when the loop
closer runs the global BA.

Cameras look outward from the ring and move sideways along it.  Each
landmark is placed in the view of the middle keyframe of its run, at a
depth drawn from ``depth_m``; its observations are its true projections
with pixel noise that grows with the pyramid level, a share of gross
outliers, and a right-image coordinate where it lies within
``stereo_max_depth_m``.  The map the solve starts from carries a smooth
drift of the poses (their two oldest keyframes, the gauge, excepted) and
the points' share of it, plus noise.
"""

import math

import numpy as np
import torch


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w):
    """Rodrigues over a batch (..., 3) float64 -> (..., 3, 3)."""
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    W = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    small = th < 1e-9
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / torch.where(
        small, torch.ones_like(th), th))
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(th)) / torch.where(small,
                                                      torch.ones_like(th),
                                                      th * th))
    return eye + a * W + b * (W @ W)


def ring_poses(K, spacing, device):
    """True world->camera poses (R_cw (K, 3, 3), t_cw (K, 3)) float64 of K
    keyframes on a ring, looking outward."""
    radius = K * spacing / (2 * math.pi)
    phi = torch.arange(K, dtype=torch.float64, device=device) * (
        2 * math.pi / K)
    c = torch.stack([radius * torch.cos(phi), torch.zeros_like(phi),
                     radius * torch.sin(phi)], -1)
    z = torch.stack([torch.cos(phi), torch.zeros_like(phi),
                     torch.sin(phi)], -1)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64,
                     device=device).expand_as(z)
    x = torch.linalg.cross(y, z)
    R_wc = torch.stack([x, y, z], -1)
    R_cw = R_wc.transpose(-1, -2)
    return R_cw, -torch.einsum("kij,kj->ki", R_cw, c)


def build(traffic, intr, bf, max_kp, seed, device):
    """The seed's map as numpy arrays, ready for a MapState.

    ``intr`` = (fx, fy, cx, cy, width, height).  Returns dict with the
    keyframe tables (kf_R, kf_t, kf_kp_uv, kf_kp_level, kf_kp_ur,
    kf_kp_lm, kf_kp_valid, kf_timestamp), the landmarks (lm_pos), the true
    poses and points, and the sizes K, M, O."""
    g = traffic["map"]
    K, per_kf, run = g["keyframes"], g["obs_per_kf"], g["track_len"]
    if per_kf % run:
        raise ValueError("obs_per_kf must be a multiple of track_len")
    if per_kf > max_kp:
        raise ValueError(f"obs_per_kf {per_kf} exceeds the keyframe's "
                         f"{max_kp} slots")
    fx, fy, cx, cy, W, H = intr
    dev = device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=dev)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f64)

    R_cw, t_cw = ring_poses(K, g["kf_spacing_m"], dev)
    # Landmarks: `new` per keyframe, the run of keyframe k being k .. k+run-1
    # (mod K); each placed in the view of the run's middle keyframe.
    new = per_kf // run
    M = K * new
    first = torch.arange(K, device=dev).repeat_interleave(new)
    mid_phi = (first.to(torch.float64) + (run - 1) / 2.0) * (2 * math.pi / K)
    # The middle pose, interpolated on the ring: keyframe 0's camera turned
    # about the world's y axis.
    rot = so3_exp(torch.stack([torch.zeros_like(mid_phi), -mid_phi,
                               torch.zeros_like(mid_phi)], -1))
    R_mid_wc = rot @ R_cw[0].T
    radius = K * g["kf_spacing_m"] / (2 * math.pi)
    c_mid = torch.stack([radius * torch.cos(mid_phi),
                         torch.zeros_like(mid_phi),
                         radius * torch.sin(mid_phi)], -1)
    mx, my = g["margin_px"]
    u = uni(M, mx, W - mx)
    v = uni(M, my, H - my)
    z = uni(M, *g["depth_m"])
    pc = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    X = c_mid + torch.einsum("mij,mj->mi", R_mid_wc, pc)

    # Observations: landmark m by keyframes first[m] + 0 .. run - 1.
    lm = torch.arange(M, device=dev).repeat_interleave(run)
    kf = (first.repeat_interleave(run)
          + torch.arange(run, device=dev).repeat(M)) % K
    O = lm.numel()
    p = torch.einsum("oij,oj->oi", R_cw[kf], X[lm]) + t_cw[kf]
    uv_true = torch.stack([fx * p[:, 0] / p[:, 2] + cx,
                           fy * p[:, 1] / p[:, 2] + cy], -1)
    quota = torch.tensor(g["level_weights"], **f64)
    level = torch.multinomial(quota.to(torch.float32), O, replacement=True,
                              generator=gen)
    sigma = g["pixel_sigma"] * torch.pow(torch.tensor(1.2, **f64),
                                         level.to(torch.float64))
    noise = torch.randn((O, 3), generator=gen, **f64) * sigma[:, None]
    uv = uv_true + noise[:, :2]
    ur = uv_true[:, 0] - bf / p[:, 2] + noise[:, 2]
    ur = torch.where(p[:, 2] <= g["stereo_max_depth_m"], ur,
                     torch.full_like(ur, -1.0))
    bad = torch.rand(O, generator=gen, **f64) < g["outlier_share"]
    ang = uni(O, 0.0, 2 * math.pi)
    mag = uni(O, *g["outlier_px"])
    uv = uv + bad[:, None] * mag[:, None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], -1)
    ur = torch.where(bad & (ur >= 0), ur + mag * torch.cos(ang), ur)

    # Drift: smooth along the ring, none at the two gauge keyframes.
    s = torch.arange(K, **f64) / K
    d = g["drift"]
    ph = uni((2, 3), 0.0, 2 * math.pi)
    wave = torch.sin(2 * math.pi * d["cycles"] * s[:, None, None] + ph[None])
    drot = (math.radians(d["rot_deg"]) * wave[:, 0]
            + math.radians(d["rot_jitter_deg"])
            * torch.randn((K, 3), generator=gen, **f64))
    dpos = (d["pos_m"] * wave[:, 1]
            + d["pos_jitter_m"] * torch.randn((K, 3), generator=gen, **f64))
    drot[:2] = 0.0
    dpos[:2] = 0.0
    c_true = -torch.einsum("kji,kj->ki", R_cw, t_cw)
    R_wc_est = so3_exp(drot) @ R_cw.transpose(-1, -2)
    R_est = R_wc_est.transpose(-1, -2)
    c_est = c_true + dpos
    t_est = -torch.einsum("kij,kj->ki", R_est, c_est)
    mid_kf = (first + run // 2) % K
    X_est = (X + dpos[mid_kf]
             + d["point_noise_m"] * torch.randn((M, 3), generator=gen, **f64))

    # Keypoint slots: each keyframe's observations in landmark order.
    order = torch.argsort(kf * M + lm)
    kf_s, lm_s = kf[order], lm[order]
    start = torch.searchsorted(kf_s, torch.arange(K, device=dev))
    slot = torch.arange(O, device=dev) - start[kf_s]

    def host(x, dt):
        return x.cpu().numpy().astype(dt)

    kf_kp_uv = np.zeros((K, max_kp, 2), np.float32)
    kf_kp_level = np.zeros((K, max_kp), np.int32)
    kf_kp_ur = np.full((K, max_kp), -1.0, np.float32)
    kf_kp_lm = np.full((K, max_kp), -1, np.int32)
    kf_kp_valid = np.zeros((K, max_kp), bool)
    k_np, s_np = host(kf_s, np.int64), host(slot, np.int64)
    kf_kp_uv[k_np, s_np] = host(uv[order], np.float32)
    kf_kp_level[k_np, s_np] = host(level[order], np.int32)
    kf_kp_ur[k_np, s_np] = host(ur[order], np.float32)
    kf_kp_lm[k_np, s_np] = host(lm_s, np.int32)
    kf_kp_valid[k_np, s_np] = True
    return dict(
        K=K, M=M, O=O,
        kf_R=host(R_est, np.float32), kf_t=host(t_est, np.float32),
        kf_timestamp=np.arange(K, dtype=np.float64) * g["kf_dt_s"],
        kf_kp_uv=kf_kp_uv, kf_kp_level=kf_kp_level, kf_kp_ur=kf_kp_ur,
        kf_kp_lm=kf_kp_lm, kf_kp_valid=kf_kp_valid,
        lm_pos=host(X_est, np.float32),
        true_R=host(R_cw, np.float64), true_t=host(t_cw, np.float64),
        true_X=host(X, np.float64))


def to_map_state(MapState, data, max_kp):
    """A MapState holding ``data`` (``build``'s output)."""
    K, M = data["K"], data["M"]
    m = MapState(max_kf=K, max_kp=max_kp, max_lm=M)
    m.kf_R[:] = data["kf_R"]
    m.kf_t[:] = data["kf_t"]
    m.kf_valid[:] = True
    m.kf_frame_id[:] = np.arange(K)
    m.kf_timestamp[:] = data["kf_timestamp"]
    for name in ("kf_kp_uv", "kf_kp_level", "kf_kp_ur", "kf_kp_lm",
                 "kf_kp_valid"):
        getattr(m, name)[:] = data[name]
    m.lm_pos[:] = data["lm_pos"]
    m.lm_valid[:] = True
    m.n_kf = m.next_kf = K
    m.n_lm = m.next_lm = M
    return m


SNAPSHOT = ("kf_R", "kf_t", "kf_valid", "kf_kp_lm", "lm_pos", "lm_valid")


def snapshot(m):
    return {k: getattr(m, k).copy() for k in SNAPSHOT} | dict(
        n_lm=m.n_lm, change_idx=m.change_idx)


def restore(m, snap):
    for k in SNAPSHOT:
        np.copyto(getattr(m, k), snap[k])
    m.n_lm = snap["n_lm"]
    m.change_idx = snap["change_idx"]
