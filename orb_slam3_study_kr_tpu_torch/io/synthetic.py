"""Synthetic SLAM sequences with exact ground truth.

The build machine has no EuRoC/TUM datasets (zero egress), so the test and
benchmark oracle is a rendered world: a field of visually distinctive
landmark blobs projected through the real camera models, observed from a
smooth trajectory.  This plays the role the reference assigns to dataset
end-to-end runs (SURVEY.md section 4): the pipeline runs on these frames and
its trajectory is scored with the same ATE evaluator.

Rendering is host-side numpy (it stands in for a dataset reader, not a hot
path).  Each landmark is an anisotropic Gaussian blob plus a satellite blob,
giving FAST a corner-like response at the center and BRIEF a distinctive,
mostly view-stable local pattern.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticScene:
    points: np.ndarray        # (M, 3) world landmarks
    intensity: np.ndarray     # (M,)
    axis: np.ndarray          # (M, 2) blob principal axis (unit)
    ecc: np.ndarray           # (M,) eccentricity in [1, 3]
    sat_offset: np.ndarray    # (M, 2) satellite blob offset (px)
    sat_intensity: np.ndarray # (M,)
    K: np.ndarray             # (3, 3)
    width: int
    height: int


def make_scene(
    rng, n_points=600, extent=(8.0, 5.0, 4.0), center=(0.0, 0.0, 8.0),
    K=None, width=752, height=480,
):
    if K is None:
        K = np.array([[458.0, 0, width / 2], [0, 457.0, height / 2], [0, 0, 1.0]])
    pts = rng.uniform(-1, 1, (n_points, 3)) * np.asarray(extent) + np.asarray(center)
    ax = rng.normal(size=(n_points, 2))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    return SyntheticScene(
        points=pts.astype(np.float32),
        intensity=rng.uniform(80, 200, n_points).astype(np.float32),
        axis=ax.astype(np.float32),
        ecc=rng.uniform(1.2, 2.5, n_points).astype(np.float32),
        sat_offset=rng.uniform(-6, 6, (n_points, 2)).astype(np.float32),
        sat_intensity=rng.uniform(40, 140, n_points).astype(np.float32),
        K=K.astype(np.float32),
        width=width,
        height=height,
    )


def circular_trajectory(n_frames, radius=1.5, z_amp=0.3, look_at=(0, 0, 8.0),
                        span=1.0):
    """World->camera poses along an arc, camera looking at the landmark
    cloud.  Returns (R_cw (T,3,3), t_cw (T,3)); world = first-camera-ish."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = span * 2 * np.pi * i / max(n_frames - 1, 1)
        c = np.array([radius * np.sin(a), z_amp * np.sin(2 * a), -radius * (1 - np.cos(a)) * 0.3])
        fwd = np.asarray(look_at) - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R_wc = np.stack([right, up, fwd], axis=1)  # cam axes in world
        R_cw = R_wc.T
        t_cw = -R_cw @ c
        Rs.append(R_cw)
        ts.append(t_cw)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def lateral_trajectory(n_frames, x_span=3.0, z_span=1.0, y_amp=0.2):
    """EuRoC-machine-hall-like motion: mostly lateral + slight forward
    translation with a fixed viewing direction (viewpoint-stable, the
    regime ORB descriptors are designed for).  Returns (R_cw, t_cw)."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        c = np.array([
            x_span * (a - 0.5),
            y_amp * np.sin(4 * np.pi * a),
            z_span * np.sin(np.pi * a) * 0.5,
        ])
        R_cw = np.eye(3)
        t_cw = -c
        Rs.append(R_cw)
        ts.append(t_cw)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def render(scene: SyntheticScene, R_cw, t_cw, sigma=1.4, noise_std=2.0,
           rng=None, window=9):
    """Render one frame (H, W) float32 in [0, 255]."""
    H, W = scene.height, scene.width
    img = np.full((H, W), 30.0, np.float32)
    # Smooth background gradient for realism (doesn't add corners).
    yy = np.linspace(0, 20, H, dtype=np.float32)[:, None]
    xx = np.linspace(0, 15, W, dtype=np.float32)[None, :]
    img += yy + xx

    pc = scene.points @ R_cw.T + t_cw
    vis = pc[:, 2] > 0.3
    uv = (pc[:, :2] / pc[:, 2:3]) @ scene.K[:2, :2].T + scene.K[:2, 2]
    in_img = (
        vis & (uv[:, 0] > window) & (uv[:, 0] < W - window)
        & (uv[:, 1] > window) & (uv[:, 1] < H - window)
    )
    idxs = np.nonzero(in_img)[0]
    r = window
    for i in idxs:
        u, v = uv[i]
        cu, cv = int(round(u)), int(round(v))
        if not (r <= cu < W - r and r <= cv < H - r):
            continue
        ys = np.arange(cv - r, cv + r + 1)
        xs = np.arange(cu - r, cu + r + 1)
        dy = (ys - v)[:, None].astype(np.float32)
        dx = (xs - u)[None, :].astype(np.float32)
        ax = scene.axis[i]
        # Anisotropic quadratic form with eccentricity along `ax`.
        a_par = (dx * ax[0] + dy * ax[1])
        a_perp = (-dx * ax[1] + dy * ax[0])
        e = scene.ecc[i]
        q = (a_par / (sigma * e)) ** 2 + (a_perp / sigma) ** 2
        blob = scene.intensity[i] * np.exp(-0.5 * q)
        # Satellite blob for descriptor distinctiveness.
        so = scene.sat_offset[i]
        q2 = ((dx - so[0]) / sigma) ** 2 + ((dy - so[1]) / sigma) ** 2
        blob += scene.sat_intensity[i] * np.exp(-0.5 * q2)
        img[cv - r : cv + r + 1, cu - r : cu + r + 1] += blob
    if rng is not None and noise_std > 0:
        img += rng.normal(0, noise_std, img.shape).astype(np.float32)
    return np.clip(img, 0, 255), uv, in_img


def render_sequence(scene, R_cw, t_cw, rng=None, **kw):
    frames = []
    for i in range(R_cw.shape[0]):
        img, uv, vis = render(scene, R_cw[i], t_cw[i], rng=rng, **kw)
        frames.append((img, uv, vis))
    return frames


# ---------------------------------------------------------------------------
# Textured world: planes with multi-octave texture, rendered by exact
# ray-plane intersection.  Statistically much closer to real imagery than the
# blob field (dense corners, distinctive local patterns), with exact pose
# ground truth.  The blob scene stays for kernel tests needing known points.
# ---------------------------------------------------------------------------


def _multi_octave_texture(rng, size=2048, octaves=6, persistence=0.55):
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = max(4, size >> (octaves - 1 - o))
        layer = rng.normal(0, 1, (n, n)).astype(np.float32)
        # Upsample by bilinear interpolation to full size.
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, n - 1)
        x1 = np.minimum(x0 + 1, n - 1)
        wy = (yi - y0)[:, None]
        wx = (xi - x0)[None, :]
        up = (
            layer[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + layer[np.ix_(y1, x0)] * wy * (1 - wx)
            + layer[np.ix_(y0, x1)] * (1 - wy) * wx
            + layer[np.ix_(y1, x1)] * wy * wx
        )
        tex += amp * up
        amp *= persistence
    tex -= tex.min()
    tex *= 235.0 / max(tex.max(), 1e-9)
    return tex + 10.0


@dataclass
class TexturedWorld:
    """Planes z = d0 + nx*x + ny*y (in world coords) carrying textures."""
    planes: list          # list of dicts: point p0, normal n, basis (e1, e2), tex, scale
    K: np.ndarray
    width: int
    height: int
    kb8_params: tuple = None  # (fx, fy, cx, cy, k1..k4): render as fisheye


def _kb8_rays(params, xs, ys):
    """Kannala-Brandt unprojection of a pixel grid (numpy; render-side twin
    of cameras/kb8.py unproject)."""
    fx, fy, cx, cy, k1, k2, k3, k4 = params[:8]
    mx = (xs - cx) / fx
    my = (ys - cy) / fy
    td = np.clip(np.sqrt(mx * mx + my * my), 1e-9, np.pi)
    theta = td.copy()
    for _ in range(10):
        th2 = theta * theta
        poly = 1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = 1 + th2 * (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3 + th2 * 9 * k4)))
        theta = theta - (theta * poly - td) / np.maximum(dpoly, 1e-9)
    scale = np.tan(theta) / td
    return np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1)


def make_textured_world(rng, K=None, width=752, height=480, depth=6.0,
                        kb8_params=None):
    if K is None:
        K = np.array([[458.0, 0, width / 2], [0, 457.0, height / 2], [0, 0, 1.0]])
    planes = []
    # Two walls forming a shallow V (avoids pure-plane degeneracy), plus a
    # floor — a corridor-corner-like world.
    specs = [
        (np.array([-2.5, 0.0, depth + 1.5]), np.array([0.6, 0.0, -1.0])),
        (np.array([2.5, 0.0, depth + 1.5]), np.array([-0.6, 0.0, -1.0])),
        (np.array([0.0, 2.2, depth]), np.array([0.0, -1.0, -0.25])),
    ]
    for p0, n in specs:
        n = n / np.linalg.norm(n)
        e1 = np.cross(n, [0.0, 1.0, 0.0])
        if np.linalg.norm(e1) < 0.1:
            e1 = np.cross(n, [1.0, 0.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        planes.append(dict(
            p0=p0.astype(np.float64), n=n.astype(np.float64),
            e1=e1.astype(np.float64), e2=e2.astype(np.float64),
            tex=_multi_octave_texture(rng), scale=120.0,
        ))
    return TexturedWorld(planes=planes, K=K.astype(np.float32),
                         width=width, height=height, kb8_params=kb8_params)


def inertial_trajectory(n_frames, fps=10.0, imu_freq=200.0,
                        gravity_w=(0.0, 9.4, -2.8),
                        amp=(0.5, 0.25, 0.35), omega=(0.9, 1.7, 1.3),
                        rot_amp=(0.06, 0.10, 0.04), rot_omega=(1.1, 0.7, 1.9),
                        look_depth=6.0,
                        noise_gyro=1.7e-4, noise_acc=2e-3,
                        bias_gyro=(0.004, -0.002, 0.003),
                        bias_acc=(0.03, -0.05, 0.02),
                        rng=None):
    """Analytic C-infinity body trajectory with exact IMU measurements.

    Body == camera frame (identity Tbc); the body starts at the origin
    looking +z at the textured world.  Gravity has magnitude 9.81 along
    `gravity_w` (not axis-aligned, so that the gravity direction has to be
    estimated).  IMU samples carry constant biases and white noise at the
    given densities (continuous sigma * sqrt(freq)).  The body rotation and
    its right Jacobian are evaluated in float32 (``lie.so3`` on the CPU), so
    the same rng gives the reference package's streams.

    Returns dict with R_cw, t_cw (T, 3, 3), (T, 3) world->camera poses at
    the frame times; imu, a list of T arrays (M_i, 7) [dt, ax ay az, gx gy
    gz] covering (t_{i-1}, t_i] (imu[0] empty); vel_w (T, 3); gravity_w
    (3,); bias (6,) [gyro, acc]; timestamps (T,).
    """
    import torch
    from orb_slam3_study_kr_tpu_torch.lie import so3 as so3lib

    g_dir = np.asarray(gravity_w, np.float64)
    g_w = 9.81 * g_dir / np.linalg.norm(g_dir)
    A = np.asarray(amp)
    W = np.asarray(omega)
    RA = np.asarray(rot_amp)
    RW = np.asarray(rot_omega)
    bg = np.asarray(bias_gyro, np.float64)
    ba = np.asarray(bias_acc, np.float64)

    def pos(t):
        return A * np.sin(W * t)

    def vel(t):
        return A * W * np.cos(W * t)

    def acc(t):
        return -A * W * W * np.sin(W * t)

    def theta(t):
        return RA * np.sin(RW * t)

    def dtheta(t):
        return RA * RW * np.cos(RW * t)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    def R_wb(t):
        return so3lib.exp_so3(f32(theta(t))).numpy().astype(np.float64)

    def omega_body(t):
        Jr = so3lib.right_jacobian_so3(f32(theta(t))).numpy().astype(np.float64)
        return Jr @ dtheta(t)

    T = n_frames
    ts = np.arange(T) / fps
    dt_imu = 1.0 / imu_freq
    sg = noise_gyro * np.sqrt(imu_freq)
    sa = noise_acc * np.sqrt(imu_freq)

    R_cw_list, t_cw_list, v_list, imu_list = [], [], [], []
    for i in range(T):
        Rb = R_wb(ts[i])
        p = pos(ts[i])
        R_cw_list.append(Rb.T)
        t_cw_list.append(-Rb.T @ p)
        v_list.append(vel(ts[i]))
        if i == 0:
            imu_list.append(np.zeros((0, 7), np.float64))
            continue
        # Samples strictly inside (t_{i-1}, t_i], midpoint-stamped.
        tks = np.arange(ts[i - 1] + dt_imu, ts[i] + 1e-9, dt_imu)
        rows = []
        for tk in tks:
            tm = tk - 0.5 * dt_imu  # the measurement models the midpoint
            Rb_k = R_wb(tm)
            w_meas = omega_body(tm) + bg
            a_meas = Rb_k.T @ (acc(tm) - g_w) + ba
            if rng is not None:
                w_meas = w_meas + rng.normal(0, sg, 3)
                a_meas = a_meas + rng.normal(0, sa, 3)
            rows.append(np.concatenate([[dt_imu], a_meas, w_meas]))
        imu_list.append(np.asarray(rows, np.float64).reshape(-1, 7))
    return dict(
        R_cw=np.stack(R_cw_list).astype(np.float32),
        t_cw=np.stack(t_cw_list).astype(np.float32),
        imu=imu_list,
        vel_w=np.stack(v_list).astype(np.float32),
        gravity_w=g_w.astype(np.float32),
        bias=np.concatenate([bg, ba]).astype(np.float32),
        timestamps=ts,
    )


def stereo_right_pose(R_cw, t_cw, baseline):
    """Pose of the right camera of a rectified rig: translated `baseline`
    along the left camera's +x axis, so pc_right = pc_left - [b, 0, 0]."""
    off = np.array([baseline, 0.0, 0.0], t_cw.dtype)
    return R_cw, t_cw - off


def render_textured(world: TexturedWorld, R_cw, t_cw, noise_std=1.5, rng=None,
                    return_depth=False):
    """Render one frame by ray casting to the nearest plane (bilinear texture
    lookup).  Returns (H, W) float32; with return_depth also the per-pixel
    z-depth map (inf where no plane is hit) for the RGB-D path."""
    H, W = world.height, world.width
    K = world.K
    ys, xs = np.mgrid[0:H, 0:W]
    if world.kb8_params is not None:
        rays_c = _kb8_rays(np.asarray(world.kb8_params, np.float64),
                           xs.astype(np.float64), ys.astype(np.float64))
    else:
        rays_c = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs, np.float64)],
            axis=-1,
        )
    R_wc = R_cw.T
    c = -R_wc @ t_cw  # camera center in world
    rays_w = rays_c @ R_wc.T  # (H, W, 3)

    best_t = np.full((H, W), np.inf)
    img = np.full((H, W), 25.0, np.float32)
    for pl in world.planes:
        denom = rays_w @ pl["n"]
        tt = ((pl["p0"] - c) @ pl["n"]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        hit = (tt > 0.1) & (tt < best_t)
        if not hit.any():
            continue
        pts = c + rays_w * tt[..., None]
        d = pts - pl["p0"]
        u = (d @ pl["e1"]) * pl["scale"] + pl["tex"].shape[1] / 2
        v = (d @ pl["e2"]) * pl["scale"] + pl["tex"].shape[0] / 2
        tex = pl["tex"]
        th, tw = tex.shape
        u = np.clip(u, 0, tw - 1.001)
        v = np.clip(v, 0, th - 1.001)
        u0 = u.astype(int)
        v0 = v.astype(int)
        fu = (u - u0).astype(np.float32)
        fv = (v - v0).astype(np.float32)
        val = (
            tex[v0, u0] * (1 - fv) * (1 - fu)
            + tex[v0 + 1, u0] * fv * (1 - fu)
            + tex[v0, u0 + 1] * (1 - fv) * fu
            + tex[v0 + 1, u0 + 1] * fv * fu
        )
        img = np.where(hit, val.astype(np.float32), img)
        best_t = np.where(hit, tt, best_t)
    if rng is not None and noise_std > 0:
        img = img + rng.normal(0, noise_std, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255)
    if return_depth:
        # rays_c has z == 1, so the ray parameter t IS camera z-depth.
        return img, best_t.astype(np.float32)
    return img
