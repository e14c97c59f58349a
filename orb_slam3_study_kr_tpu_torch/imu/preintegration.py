"""IMU preintegration on the manifold.

Counterpart of ``orb_slam3_study_kr_tpu/imu/preintegration.py``, the
measurement model of ImuTypes.cc IntegrateNewMeasurement: samples integrate
into bias-referenced deltas (dR, dV, dP) with a 15x15 covariance propagated
through the A/B linearization and the first-order bias Jacobians (JRg, JVg,
JVa, JPg, JPa), so that the deltas can be corrected for a new bias without
re-integration (GetDeltaRotation/Velocity/Position).

The reference scans a padded window whose masked slots are identity steps;
here ``preintegrate`` loops over the real rows only, which gives the same
result.  ``preintegrate_batch`` integrates B intervals along a leading axis
at once, stepping to the longest and holding each interval past its end.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.lie.so3 import (exp_so3, hat, log_so3,
                                                  normalize_rotation,
                                                  right_jacobian_inv_so3,
                                                  right_jacobian_so3)
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

GRAVITY_VALUE = 9.81


def gravity(device, dtype=torch.float32):
    """The world gravity vector [0, 0, -9.81] on `device`."""
    return torch.tensor([0.0, 0.0, -GRAVITY_VALUE], dtype=dtype, device=device)


@dataclass(frozen=True)
class ImuCalib:
    """Noise densities (discrete, per sample), the bias random walk and the
    body <- camera extrinsic (IMU::Calib).  The scalars are float32 0-d
    tensors on `device`, as the reference's float32 leaves."""
    noise_gyro: torch.Tensor   # sigma_g * sqrt(freq)
    noise_acc: torch.Tensor
    walk_gyro: torch.Tensor
    walk_acc: torch.Tensor
    R_bc: torch.Tensor         # (3, 3) body <- camera rotation
    t_bc: torch.Tensor         # (3,)
    device: torch.device

    @staticmethod
    def make(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5,
             walk_acc=3e-3, freq=200.0, R_bc=None, t_bc=None, device="cuda"):
        dev = resolve_device(device, "ImuCalib.device")
        sf = float(freq) ** 0.5

        def scalar(x):
            return torch.tensor(np.float32(x), device=dev)

        R = np.eye(3, dtype=np.float32) if R_bc is None else np.asarray(
            R_bc, np.float32)
        t = np.zeros(3, np.float32) if t_bc is None else np.asarray(
            t_bc, np.float32)
        return ImuCalib(noise_gyro=scalar(noise_gyro * sf),
                        noise_acc=scalar(noise_acc * sf),
                        walk_gyro=scalar(walk_gyro / sf),
                        walk_acc=scalar(walk_acc / sf),
                        R_bc=torch.as_tensor(R, device=dev),
                        t_bc=torch.as_tensor(t, device=dev), device=dev)


@dataclass(frozen=True)
class Preintegrated:
    """Bias-referenced deltas between two stamps; every field may carry a
    leading batch axis (one row per interval)."""
    dT: torch.Tensor     # total time
    dR: torch.Tensor     # (3, 3)
    dV: torch.Tensor     # (3,)
    dP: torch.Tensor     # (3,)
    cov: torch.Tensor    # (15, 15): [phi, v, p, bg, ba]
    JRg: torch.Tensor    # (3, 3) d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias: torch.Tensor   # (6,) [bg, ba] linearization point

    def map(self, fn):
        return Preintegrated(**{f.name: fn(getattr(self, f.name))
                                for f in fields(self)})

    def __getitem__(self, i):
        return self.map(lambda a: a[i])


def _step(state, a, w, dt, bias, nga, walk):
    """One ImuTypes.cc update of the batched state by samples a, w (B, 3)
    over dt (B,); dP and dV use the old dR."""
    dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, dT = state
    bg, ba = bias[:, :3], bias[:, 3:]
    acc_c = a - ba
    w_c = w - bg
    dt2 = dt * dt
    d1 = dt[:, None]
    d2 = dt2[:, None]
    d3 = dt[:, None, None]
    d33 = dt2[:, None, None]
    dRa = (dR @ acc_c[..., None])[..., 0]
    dP_n = dP + dV * d1 + (0.5 * dRa) * d2
    dV_n = dV + dRa * d1
    acc_hat = hat(acc_c)
    dR_ah = dR @ acc_hat

    eye = torch.eye(3, dtype=dR.dtype, device=dR.device).expand_as(dR)
    zero = torch.zeros_like(dR)
    JPa_n = JPa + JVa * d3 - (0.5 * dR) * d33
    JPg_n = JPg + JVg * d3 - ((0.5 * dR) @ acc_hat @ JRg) * d33
    JVa_n = JVa - dR * d3
    JVg_n = JVg - (dR_ah @ JRg) * d3

    phi = w_c * d1
    dRi = exp_so3(phi)
    Jr = right_jacobian_so3(phi)
    A = torch.cat([
        torch.cat([dRi.transpose(-1, -2), zero, zero], -1),
        torch.cat([(-dR_ah) * d3, eye, zero], -1),
        torch.cat([((-0.5 * dR) @ acc_hat) * d33, eye * d3, eye], -1)], -2)
    B = torch.cat([
        torch.cat([Jr * d3, zero], -1),
        torch.cat([zero, dR * d3], -1),
        torch.cat([zero, (0.5 * dR) * d33], -1)], -2)
    C9 = (A @ C[:, :9, :9] @ A.transpose(-1, -2)
          + B @ nga @ B.transpose(-1, -2))
    C_n = torch.cat([
        torch.cat([C9, C[:, :9, 9:]], -1),
        torch.cat([C[:, 9:, :9], C[:, 9:, 9:] + walk], -1)], -2)
    JRg_n = dRi.transpose(-1, -2) @ JRg - Jr * d3
    dR_n = dR @ dRi
    return (dR_n, dV_n, dP_n, C_n, JRg_n, JVg_n, JVa_n, JPg_n, JPa_n,
            dT + dt)


def _noise(calib, dtype):
    sg2 = calib.noise_gyro ** 2
    sa2 = calib.noise_acc ** 2
    wg2 = calib.walk_gyro ** 2
    wa2 = calib.walk_acc ** 2
    nga = torch.diag(torch.cat([sg2.expand(3), sa2.expand(3)])).to(dtype)
    walk = torch.diag(torch.cat([wg2.expand(3), wa2.expand(3)])).to(dtype)
    return nga, walk


def preintegrate_batch(acc, gyro, dts, mask, bias, calib: ImuCalib):
    """Integrate B intervals at once.

    acc, gyro: (B, M, 3); dts, mask: (B, M) with each interval's live rows
    first (mask 1.0) and its padding after (0.0); bias: (B, 6) reference
    biases.  Steps to the longest interval; a row past an interval's end
    leaves that interval's state unchanged.  Returns a batched
    Preintegrated."""
    Bn, M = dts.shape
    dtype, dev = acc.dtype, acc.device
    nga, walk = _noise(calib, dtype)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(Bn, 3, 3)
    z3 = torch.zeros((Bn, 3), dtype=dtype, device=dev)
    z33 = torch.zeros((Bn, 3, 3), dtype=dtype, device=dev)
    state = (eye, z3, z3, torch.zeros((Bn, 15, 15), dtype=dtype, device=dev),
             z33, z33, z33, z33, z33, torch.zeros(Bn, dtype=dtype, device=dev))
    lens = (mask > 0).sum(1)
    n_steps = int(lens.max()) if Bn else 0
    partial = bool((lens < n_steps).any()) if Bn else False
    for k in range(n_steps):
        m = mask[:, k]
        new = _step(state, acc[:, k], gyro[:, k], dts[:, k] * m, bias,
                    nga, walk * m[:, None, None])
        if partial:
            keep = m > 0
            state = tuple(torch.where(keep.view(-1, *([1] * (n.dim() - 1))),
                                      n, o) for n, o in zip(new, state))
        else:
            state = new
    dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, dT = state
    return Preintegrated(dT=dT, dR=normalize_rotation(dR), dV=dV, dP=dP,
                         cov=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         bias=bias)


def preintegrate_batch_scan(acc, gyro, dts, mask, bias, calib: ImuCalib):
    """``preintegrate_batch``'s result with about a tenth of its operations,
    for many long intervals at once (the loop closer's full inertial BA):
    every per-sample quantity is computed for all samples in one batched
    call, the deltas and the bias Jacobians as prefix sums, and only the
    rotation and the covariance are chained sample by sample.  A row past
    an interval's end (mask 0) is an exact identity step there, as its dt
    is 0.  Equal to ``preintegrate_batch`` up to rounding: the same
    recurrences, summed in another order (JRg through
    JRg_k = -R_k^T sum_{j<=k} R_j Jr_j dt_j, R_k the rotation after sample
    k)."""
    Bn, M = dts.shape
    dtype, dev = acc.dtype, acc.device
    nga, walk = _noise(calib, dtype)
    dt = (dts * mask)[..., None]                     # (B, M, 1)
    d3 = dt[..., None]
    a = acc - bias[:, None, 3:]
    phi = (gyro - bias[:, None, :3]) * dt
    dRi = exp_so3(phi)
    Jr = right_jacobian_so3(phi)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(Bn, 3, 3)
    Rs = [eye]
    for k in range(M):
        Rs.append(Rs[-1] @ dRi[:, k])
    R = torch.stack(Rs, 1)                           # (B, M + 1, 3, 3)
    Rp, Rk = R[:, :-1], R[:, 1:]                     # before, after sample k

    def excl(x):                                     # sums before sample k
        return torch.cumsum(x, 1) - x

    dRa = (Rp @ a[..., None])[..., 0]
    dV_p = excl(dRa * dt)
    dP = torch.sum(dV_p * dt + 0.5 * dRa * dt * dt, 1)
    dV = torch.sum(dRa * dt, 1)
    JVa_p = -excl(Rp * d3)
    JPa = torch.sum(JVa_p * d3 - 0.5 * Rp * d3 * d3, 1)
    JVa = -torch.sum(Rp * d3, 1)
    S = -torch.cumsum(Rk @ Jr * d3, 1)
    JRg_p = Rp.transpose(-1, -2) @ (S + Rk @ Jr * d3)
    RaJ = Rp @ hat(a) @ JRg_p
    JVg_p = -excl(RaJ * d3)
    JPg = torch.sum(JVg_p * d3 - 0.5 * RaJ * d3 * d3, 1)
    JVg = -torch.sum(RaJ * d3, 1)
    JRg = Rk[:, -1].transpose(-1, -2) @ S[:, -1]
    # The covariance over [phi, v, p]: C <- A C A^T + B nga B^T.
    z = torch.zeros_like(Rp)
    Ia = torch.eye(3, dtype=dtype, device=dev).expand_as(Rp)
    RWa = Rp @ hat(a)
    A = torch.cat([
        torch.cat([dRi.transpose(-1, -2), z, z], -1),
        torch.cat([-RWa * d3, Ia, z], -1),
        torch.cat([-0.5 * RWa * d3 * d3, Ia * d3, Ia], -1)], -2)
    Bm = torch.cat([
        torch.cat([Jr * d3, z], -1),
        torch.cat([z, Rp * d3], -1),
        torch.cat([z, 0.5 * Rp * d3 * d3], -1)], -2)
    Q = Bm @ nga @ Bm.transpose(-1, -2)
    C9 = torch.zeros((Bn, 9, 9), dtype=dtype, device=dev)
    for k in range(M):
        C9 = A[:, k] @ C9 @ A[:, k].transpose(-1, -2) + Q[:, k]
    n = mask.sum(1)[:, None, None]
    C = torch.cat([torch.cat([C9, torch.zeros((Bn, 9, 6), dtype=dtype,
                                                device=dev)], -1),
                   torch.cat([torch.zeros((Bn, 6, 9), dtype=dtype,
                                          device=dev), walk * n], -1)], -2)
    return Preintegrated(dT=dt[..., 0].sum(1), dR=normalize_rotation(Rk[:, -1]),
                         dV=dV, dP=dP, cov=C, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, bias=bias)


def preintegrate(acc, gyro, dts, bias, calib: ImuCalib):
    """Integrate one window of samples: acc, gyro (N, 3) raw measurements,
    dts (N,) per-sample intervals, bias (6,) [bg, ba] reference bias."""
    pre = preintegrate_batch(acc[None], gyro[None], dts[None],
                             torch.ones_like(dts)[None], bias[None], calib)
    return pre[0]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def bias_corrected_deltas(pre: Preintegrated, new_bias):
    """First-order bias correction (GetDeltaRotation/Velocity/Position);
    broadcasts over a leading batch axis."""
    db = new_bias - pre.bias
    dbg, dba = db[..., :3], db[..., 3:]
    dR = pre.dR @ exp_so3(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP


def predict_state(R_wb, p_wb, v_w, pre: Preintegrated, bias, g=None):
    """Propagate a body state through a preintegrated window
    (Tracking::PredictStateIMU)."""
    g = gravity(R_wb.device, R_wb.dtype) if g is None else g
    dR, dV, dP = bias_corrected_deltas(pre, bias)
    t = pre.dT[..., None]
    R_new = normalize_rotation(R_wb @ dR)
    v_new = v_w + g * t + _mv(R_wb, dV)
    p_new = p_wb + v_w * t + 0.5 * g * t * t + _mv(R_wb, dP)
    return R_new, p_new, v_new


def inertial_residual(R1, p1, v1, R2, p2, v2, bias, pre: Preintegrated,
                      g=None):
    """9-D preintegration residual [e_R, e_v, e_p] between two body states
    (EdgeInertial); broadcasts over a leading batch axis."""
    g = gravity(R1.device, R1.dtype) if g is None else g
    dR, dV, dP = bias_corrected_deltas(pre, bias)
    t = pre.dT[..., None]
    R1t = R1.transpose(-1, -2)
    e_R = log_so3(dR.transpose(-1, -2) @ R1t @ R2)
    e_v = _mv(R1t, v2 - v1 - g * t) - dV
    e_p = _mv(R1t, p2 - p1 - v1 * t - 0.5 * g * t * t) - dP
    return torch.cat([e_R, e_v, e_p], -1)


def inertial_jacobian(R1, p1, v1, R2, p2, v2, bias, pre: Preintegrated,
                      g=None):
    """(E, 9, 24) Jacobian of ``inertial_residual`` over [phi_1, p_1, v_1,
    bg, ba, phi_2, p_2, v_2]: right-multiplied rotation increments,
    world-frame position, velocity and bias increments (the increments
    ``solvers/inertial_ba`` applies), in closed form as EdgeInertial's
    linearizeOplus writes it (G2oTypes.cc) with the position columns in the
    world frame."""
    g = gravity(R1.device, R1.dtype) if g is None else g
    dR = bias_corrected_deltas(pre, bias)[0]
    jg = _mv(pre.JRg, bias[..., :3] - pre.bias[..., :3])
    t = pre.dT[..., None]
    R1t = R1.transpose(-1, -2)
    E_R = dR.transpose(-1, -2) @ R1t @ R2
    Ji = right_jacobian_inv_so3(log_so3(E_R))
    z = torch.zeros_like(R1)
    d3 = t[..., None]
    rows_R = [-Ji @ R2.transpose(-1, -2) @ R1, z, z,
              -Ji @ E_R.transpose(-1, -2) @ right_jacobian_so3(jg) @ pre.JRg,
              z, Ji, z, z]
    rows_v = [hat(_mv(R1t, v2 - v1 - g * t)), z, -R1t, -pre.JVg, -pre.JVa,
              z, z, R1t]
    rows_p = [hat(_mv(R1t, p2 - p1 - v1 * t - 0.5 * g * t * t)), -R1t,
              -R1t * d3, -pre.JPg, -pre.JPa, z, R1t, z]
    return torch.cat([torch.cat(rows_R, -1), torch.cat(rows_v, -1),
                      torch.cat(rows_p, -1)], -2)
