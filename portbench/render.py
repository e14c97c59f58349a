"""A textured corridor and a camera path through it, rendered on the card.

A PyTorch rewrite of the port's host renderer (``io/synthetic.py``:
``_multi_octave_texture`` and ``render_textured``, exact ray-plane
intersection with a bilinear texture lookup), frozen here so that the
yardstick does not move with the program.  The world is a row of segments
along x; each segment holds a wall quad (the wall zig-zags in depth, so no
view is a single plane), a floor quad and a ceiling quad, each with its
own multi-octave texture drawn from the seed.  The path moves along +x at
a fixed speed with small translational and rotational oscillations; it is
the same for every seed, and only the textures and the pixel noise change.

Frames are uint8, as a camera delivers them.
"""

import math

import numpy as np
import torch


def _so3_exp(w):
    """Rodrigues, float64 numpy (3,) -> (3, 3)."""
    th = float(np.linalg.norm(w))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return (np.eye(3) + math.sin(th) / th * W
            + (1 - math.cos(th)) / th ** 2 * W @ W)


def camera_path(path, fps, n_frames):
    """World->camera poses (R_cw (T, 3, 3), t_cw (T, 3)) float64 of the
    path at the camera's frame times, and the timestamps."""
    ts = np.arange(n_frames) / float(fps)
    R_cw = np.empty((n_frames, 3, 3))
    t_cw = np.empty((n_frames, 3))
    amp = np.radians(np.asarray(path["rot_amp_deg"], np.float64))
    hz = np.asarray(path["rot_hz"], np.float64)
    for i, t in enumerate(ts):
        c = np.array([
            path["speed_mps"] * t,
            path["y_amp_m"] * math.sin(2 * math.pi * path["y_hz"] * t),
            path["z_amp_m"] * math.sin(2 * math.pi * path["z_hz"] * t)])
        R_wc = _so3_exp(amp * np.sin(2 * math.pi * hz * t))
        R_cw[i] = R_wc.T
        t_cw[i] = -R_wc.T @ c
    return R_cw, t_cw, ts


def _quads(world, x_lo, x_hi):
    """(origin, e1, e2) float64 of every quad from x_lo to x_hi: per
    segment a wall, a floor and a ceiling."""
    s = world["segment_m"]
    d = world["wall_depth_m"]
    zig = world["zigzag_m"]
    y_top, y_floor = world["ceiling_y_m"], world["floor_y_m"]
    z_near = world["near_z_m"]
    quads = []
    i0 = int(math.floor(x_lo / s))
    i1 = int(math.ceil(x_hi / s))
    for i in range(i0, i1):
        xa, xb = i * s, (i + 1) * s
        za = d + zig * (i % 2)
        zb = d + zig * ((i + 1) % 2)
        # Wall: from (xa, y_top, za) along the segment and down to the floor.
        quads.append((np.array([xa, y_top, za]), np.array([s, 0.0, zb - za]),
                      np.array([0.0, y_floor - y_top, 0.0])))
        far = max(za, zb)
        for y in (y_floor, y_top):
            quads.append((np.array([xa, y, z_near]), np.array([s, 0.0, 0.0]),
                          np.array([0.0, 0.0, far - z_near])))
    return quads


def _texture(gen, h, w, octaves, persistence, device):
    """Multi-octave value noise (h, w) float32 in [10, 245]: octave o is a
    grid of normal draws every 2^(octaves-1-o) texels, bilinearly
    upsampled, weighted by persistence^o."""
    tex = torch.zeros((h, w), dtype=torch.float32, device=device)
    amp = 1.0
    for o in range(octaves):
        step = 2 ** (octaves - 1 - o)
        gh, gw = h // step + 2, w // step + 2
        layer = torch.randn((1, 1, gh, gw), generator=gen, device=device)
        up = torch.nn.functional.interpolate(
            layer, size=((gh - 1) * step + 1, (gw - 1) * step + 1),
            mode="bilinear", align_corners=True)[0, 0, :h, :w]
        tex += amp * up
        amp *= persistence
    tex -= tex.min()
    tex *= 235.0 / torch.clamp(tex.max(), min=1e-9)
    return tex + 10.0


class Corridor:
    """The world of one seed on ``device``: quads and their textures."""

    def __init__(self, world, x_lo, x_hi, gen, device):
        self.world = world
        self.device = device
        tpm = world["texels_per_m"]
        self.quads = []
        for p0, e1, e2 in _quads(world, x_lo, x_hi):
            lu, lv = float(np.linalg.norm(e1)), float(np.linalg.norm(e2))
            n = np.cross(e1, e2)
            n /= np.linalg.norm(n)
            tex = _texture(gen, int(math.ceil(lv * tpm)) + 2,
                           int(math.ceil(lu * tpm)) + 2, world["octaves"],
                           world["persistence"], device)
            self.quads.append(dict(
                p0=p0, n=n, u=e1 / lu, v=e2 / lv, lu=lu, lv=lv, tex=tex,
                x_mid=float(p0[0] + 0.5 * e1[0])))

    def render(self, K, width, height, R_cw, t_cw, gen, noise_std):
        """(B, H, W) uint8 frames of the poses (R_cw (B, 3, 3), t_cw (B, 3))
        float64 numpy, with Gaussian pixel noise drawn from ``gen``."""
        dev = self.device
        B = R_cw.shape[0]
        ys, xs = torch.meshgrid(
            torch.arange(height, dtype=torch.float64, device=dev),
            torch.arange(width, dtype=torch.float64, device=dev),
            indexing="ij")
        rays_c = torch.stack([(xs - K[0][2]) / K[0][0],
                              (ys - K[1][2]) / K[1][1],
                              torch.ones_like(xs)], dim=-1)
        R_wc = torch.as_tensor(np.transpose(R_cw, (0, 2, 1)), device=dev)
        c = -torch.einsum("bij,bj->bi", R_wc,
                          torch.as_tensor(t_cw, device=dev))
        rays = torch.einsum("hwj,bij->bhwi", rays_c, R_wc).to(torch.float32)
        c32 = c.to(torch.float32)
        best = torch.full((B, height, width), float("inf"), device=dev)
        img = torch.full((B, height, width), 25.0, device=dev)
        tpm = self.world["texels_per_m"]
        reach = self.world["view_reach_m"]
        cx_lo = float(c[:, 0].min()) - reach
        cx_hi = float(c[:, 0].max()) + reach
        for q in self.quads:
            if not cx_lo <= q["x_mid"] <= cx_hi:
                continue
            n = torch.as_tensor(q["n"], dtype=torch.float32, device=dev)
            p0 = torch.as_tensor(q["p0"], dtype=torch.float32, device=dev)
            denom = rays @ n
            denom = torch.where(denom.abs() < 1e-9,
                                torch.full_like(denom, 1e-9), denom)
            tt = ((p0[None] - c32) @ n)[:, None, None] / denom
            pts = c32[:, None, None, :] + rays * tt[..., None] - p0
            a = pts @ torch.as_tensor(q["u"], dtype=torch.float32, device=dev)
            b = pts @ torch.as_tensor(q["v"], dtype=torch.float32, device=dev)
            hit = ((tt > 0.1) & (tt < best) & (a >= 0) & (a <= q["lu"])
                   & (b >= 0) & (b <= q["lv"]))
            tex = q["tex"]
            th, tw = tex.shape
            u = torch.clamp(a * tpm, 0, tw - 1.001)
            v = torch.clamp(b * tpm, 0, th - 1.001)
            u0 = u.long()
            v0 = v.long()
            fu = u - u0
            fv = v - v0
            flat = tex.reshape(-1)
            i00 = v0 * tw + u0
            val = (flat[i00] * (1 - fv) * (1 - fu)
                   + flat[i00 + tw] * fv * (1 - fu)
                   + flat[i00 + 1] * (1 - fv) * fu
                   + flat[i00 + tw + 1] * fv * fu)
            img = torch.where(hit, val, img)
            best = torch.where(hit, tt, best)
        if noise_std > 0:
            img = img + noise_std * torch.randn(img.shape, generator=gen,
                                                device=dev)
        return torch.round(torch.clamp(img, 0, 255)).to(torch.uint8)


def render_session(traffic, K, width, height, n_frames, seed, device,
                   baseline=None, batch=32):
    """The frames and ground truth of one seed.  Returns dict(left (T, H, W)
    uint8 on ``device``, right (same, or None without ``baseline``), R_cw,
    t_cw (float64 numpy), timestamps).  The right camera of a rectified rig
    sits ``baseline`` metres along the left camera's +x axis."""
    fps = traffic["fps"]
    R_cw, t_cw, ts = camera_path(traffic["path"], fps, n_frames)
    centres = -np.einsum("nji,nj->ni", R_cw, t_cw)
    reach = traffic["world"]["view_reach_m"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    world = Corridor(traffic["world"], float(centres[:, 0].min()) - reach,
                     float(centres[:, 0].max()) + reach, gen, device)
    noise = traffic["world"]["noise_std"]
    left = torch.empty((n_frames, height, width), dtype=torch.uint8,
                       device=device)
    right = None if baseline is None else torch.empty_like(left)
    for s in range(0, n_frames, batch):
        e = min(s + batch, n_frames)
        left[s:e] = world.render(K, width, height, R_cw[s:e], t_cw[s:e], gen,
                                 noise)
        if right is not None:
            t_r = t_cw[s:e] - np.array([baseline, 0.0, 0.0])
            right[s:e] = world.render(K, width, height, R_cw[s:e], t_r, gen,
                                      noise)
    return dict(left=left, right=right, R_cw=R_cw, t_cw=t_cw, timestamps=ts)
