"""The map of a long stereo-inertial session, built on the card from the
seed, for the full-inertial-BA cell.

The visual map is ``gbamap.build``'s at the same seed (the ring of
keyframes, its landmarks, observations and drift), turned rigidly so that
the ring's axis lies along the port's gravity (-z): the cameras' image-down
axis points down.  The rig moves along the ring at a constant speed and
yaw rate, the IMU (body) frame tied to the left camera by the
configuration's ``IMU.T_b_c1``.  Its samples are the analytic motion's
angular rate and specific force at each 200 Hz sample's midpoint, plus
biases that walk at the configuration's random-walk densities and white
noise at its noise densities: ``rows_per_interval`` rows between two
keyframes, stamped at the later one, as the tracker's IMU log keeps them.

The snapshot's velocities carry the poses' drift (the drift's rotation of
the true velocity, plus the rate of change of the camera centres' drift);
its biases are the true biases at each keyframe plus one offset a session.
"""

import math

import numpy as np
import torch

from portbench import gbamap

# The rigid turn onto gravity: world y (the ring's axis, the cameras'
# image-down axis) to -z; x stays.
Q = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
GRAVITY = np.array([0.0, 0.0, -9.81])
SNAPSHOT = gbamap.SNAPSHOT + ("kf_v", "kf_bias")


def _seed2(seed):
    """A second stream's seed, apart from ``gbamap.build``'s."""
    return (int(seed) * 2654435761 + 97531) % (1 << 63)


def build(traffic, intr, bf, max_kp, seed, device, imu):
    """``gbamap.build``'s map turned onto gravity, with the IMU log and the
    snapshot's velocities and biases.  ``imu`` is the configuration's IMU
    block (``io.settings.Settings.imu_params``: densities, rate, R_bc,
    t_bc).  Adds to gbamap's dict: kf_v (K, 3), kf_bias (K, 6) [bg, ba]
    float32; imu_stamps (K - 1,) float64 and imu_rows (K - 1, n, 7)
    float32 [dt, ax ay az, gx gy gz], interval i from keyframe i to i + 1;
    true_v, true_bias (K, ...) float64; R_bc, t_bc, the densities and the
    rate."""
    data = gbamap.build(traffic, intr, bf, max_kp, seed, device)
    g, im = traffic["map"], traffic["imu"]
    K, dt_kf = data["K"], g["kf_dt_s"]
    freq = float(imu["freq"])
    n_rows = int(round(dt_kf * freq))
    if abs(n_rows / freq - dt_kf) > 1e-9:
        raise ValueError("kf_dt_s must hold a whole number of IMU samples")
    Qf = Q.astype(np.float32)
    true_R = data["true_R"]                       # gbamap's world, for motion
    for k in ("kf_R", "true_R"):
        data[k] = data[k] @ (Qf if data[k].dtype == np.float32 else Q).T
    data["lm_pos"] = data["lm_pos"] @ Qf.T
    data["true_X"] = data["true_X"] @ Q.T

    dev = device
    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(_seed2(seed))
    R_bc = torch.as_tensor(np.asarray(imu["R_bc"], np.float64), **f64)
    t_bc = torch.as_tensor(np.asarray(imu["t_bc"], np.float64), **f64)
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    Qt = torch.as_tensor(Q, **f64)
    grav = torch.as_tensor(GRAVITY, **f64)

    # The analytic motion in gbamap's world: the camera centre on the ring
    # at angle phi = Omega t, the camera turned about the world's y by
    # -phi from keyframe 0's (gbamap.ring_poses).
    radius = K * g["kf_spacing_m"] / (2 * math.pi)
    Om = 2 * math.pi / (K * dt_kf)
    om_w = torch.tensor([0.0, -Om, 0.0], **f64)
    R_wc0 = torch.as_tensor(true_R[0].T, **f64)

    def motion(t):
        """(R_wb, p_wb, v_wb, a_wb) of the body at times t, in the turned
        world."""
        phi = Om * t
        c, s = torch.cos(phi), torch.sin(phi)
        z = torch.zeros_like(phi)
        centre = radius * torch.stack([c, z, s], -1)
        d_centre = radius * Om * torch.stack([-s, z, c], -1)
        dd_centre = -radius * Om * Om * torch.stack([c, z, s], -1)
        R_wc = gbamap.so3_exp(torch.stack([z, -phi, z], -1)) @ R_wc0
        lever = R_wc @ t_cb
        om = om_w.expand_as(lever)
        w_l = torch.linalg.cross(om, lever)
        p = centre + lever
        v = d_centre + w_l
        a = dd_centre + torch.linalg.cross(om, w_l)
        R_wb = R_wc @ R_cb
        return (Qt @ R_wb, p @ Qt.T, v @ Qt.T, a @ Qt.T)

    # Samples: n_rows per interval, sample j of interval i covering
    # (t_i + j / freq, t_i + (j + 1) / freq], measured at its midpoint.
    S = (K - 1) * n_rows
    tm = (torch.arange(S, **f64) + 0.5) / freq
    R_wb, _, _, a_w = motion(tm)
    w_b = torch.einsum("nji,j->ni", R_wb, Qt @ om_w)
    f_b = torch.einsum("nji,nj->ni", R_wb, a_w - grav)
    sg, sa = imu["noise_gyro"] * math.sqrt(freq), imu["noise_acc"] * math.sqrt(
        freq)
    wg, wa = imu["walk_gyro"] / math.sqrt(freq), imu["walk_acc"] / math.sqrt(
        freq)
    b0 = torch.cat([im["bias_gyro_sigma"] * torch.randn(3, generator=gen,
                                                        **f64),
                    im["bias_acc_sigma"] * torch.randn(3, generator=gen,
                                                       **f64)])
    steps = torch.randn((S + 1, 6), generator=gen, **f64) * torch.tensor(
        [wg] * 3 + [wa] * 3, **f64)
    steps[0] = 0.0
    bias = b0 + torch.cumsum(steps, 0)            # bias during sample n
    noise = torch.randn((S, 6), generator=gen, **f64) * torch.tensor(
        [sg] * 3 + [sa] * 3, **f64)
    gyro = w_b + bias[:S, :3] + noise[:, :3]
    acc = f_b + bias[:S, 3:] + noise[:, 3:]
    rows = torch.cat([torch.full((S, 1), 1.0 / freq, **f64), acc, gyro], 1)

    # True and snapshot velocities and biases at the keyframes.
    t_kf = torch.arange(K, **f64) * dt_kf
    _, _, v_true, _ = motion(t_kf)
    bias_kf = bias[torch.arange(K, device=dev) * n_rows]
    R_est = torch.as_tensor(data["kf_R"], **f64)
    t_est = torch.as_tensor(data["kf_t"], **f64)
    R_tru = torch.as_tensor(data["true_R"], **f64)
    t_tru = torch.as_tensor(data["true_t"], **f64)
    c_est = -torch.einsum("kji,kj->ki", R_est, t_est)
    c_tru = -torch.einsum("kji,kj->ki", R_tru, t_tru)
    R_drift = R_est.transpose(1, 2) @ R_tru       # R_wc_est R_wc_true^T
    d_rate = torch.gradient(c_est - c_tru, spacing=dt_kf, dim=0)[0]
    v_est = torch.einsum("kij,kj->ki", R_drift, v_true) + d_rate
    err = torch.cat([im["bias_err_gyro"] * torch.randn(3, generator=gen,
                                                       **f64),
                     im["bias_err_acc"] * torch.randn(3, generator=gen,
                                                      **f64)])

    def host(x, dt):
        return x.cpu().numpy().astype(dt)

    data.update(
        kf_v=host(v_est, np.float32),
        kf_bias=host(bias_kf + err, np.float32),
        imu_stamps=data["kf_timestamp"][1:].copy(),
        imu_rows=host(rows, np.float32).reshape(K - 1, n_rows, 7),
        true_v=host(v_true, np.float64), true_bias=host(bias_kf, np.float64),
        R_bc=host(R_bc, np.float64), t_bc=host(t_bc, np.float64),
        noise_gyro=imu["noise_gyro"], noise_acc=imu["noise_acc"],
        walk_gyro=imu["walk_gyro"], walk_acc=imu["walk_acc"], freq=freq)
    return data


def to_map_state(MapState, data, max_kp):
    """gbamap's MapState with the velocities and biases, IMU-initialised."""
    m = gbamap.to_map_state(MapState, data, max_kp)
    m.kf_v[:] = data["kf_v"]
    m.kf_bias[:] = data["kf_bias"]
    m.imu_initialized = True
    return m


class ImuLog:
    """The rig's IMU log as the tracker keeps it: each interval's rows
    stamped at its later keyframe.  ``rows_between(t0, t1)`` gives every
    row stamped in (t0, t1] (the tracker's ``_rows_between``)."""

    def __init__(self, stamps, rows):
        self.stamps = np.asarray(stamps, np.float64)
        self.rows = np.asarray(rows, np.float32)

    def rows_between(self, t0, t1):
        a = np.searchsorted(self.stamps, t0, side="right")
        b = np.searchsorted(self.stamps, t1, side="right")
        return self.rows[a:b].reshape(-1, 7)


def snapshot(m):
    return {k: getattr(m, k).copy() for k in SNAPSHOT} | dict(
        n_lm=m.n_lm, change_idx=m.change_idx)


def restore(m, snap):
    for k in SNAPSHOT:
        np.copyto(getattr(m, k), snap[k])
    m.n_lm = snap["n_lm"]
    m.change_idx = snap["change_idx"]
