"""The port's IMU preintegration, its helpers, the right Jacobians of SO(3)
and the synthetic IMU streams against the JAX reference.

The reference integrates a window padded to a bucket under a mask; the port
loops over the real rows only.  Tolerances, relative to each array's
largest entry: the deltas and the bias Jacobians within 1e-5, the 15x15
covariance within 1e-4 (float32 sums over up to 1024 steps in another
order of operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.imu import preintegration as jpre
from orb_slam3_study_kr_tpu.io import synthetic as jsynthetic
from orb_slam3_study_kr_tpu.lie import so3 as jso3
from orb_slam3_study_kr_tpu.pipeline import inertial_tracking as jit_mod
from orb_slam3_study_kr_tpu_torch.imu import (ImuCalib, Preintegrated,
                                              bias_corrected_deltas,
                                              inertial_residual, predict_state,
                                              preintegrate)
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.lie import so3
from orb_slam3_study_kr_tpu_torch.pipeline import inertial_tracking as it_mod

torch.set_num_threads(2)

J_CALIB = jpre.ImuCalib.make()
CALIB = ImuCalib.make(device="cpu")
BIAS = np.array([0.003, -0.001, 0.002, 0.02, -0.03, 0.01], np.float32)
DELTAS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")


def _rows(n, seed=0):
    """n IMU rows [dt, acc, gyro] of a moving, rotating body at 200 Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.005
    acc = np.stack([0.5 * np.sin(3 * t), 9.6 + 0.4 * np.cos(2 * t),
                    -1.9 + 0.3 * np.sin(2 * t)], -1)
    gyro = np.stack([0.3 * np.sin(2 * t), 0.2 * np.cos(3 * t),
                     0.1 * np.sin(t)], -1)
    rows = np.concatenate([np.full((n, 1), 0.005), acc, gyro], 1)
    rows[:, 1:] += rng.normal(0, 0.01, (n, 6))
    return rows.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check(pre, jp, tol=1e-5, cov_tol=1e-4, jac_tol=1e-5):
    for k in DELTAS:
        t = jac_tol if k.startswith("J") else tol
        assert _rel(getattr(pre, k).numpy(), getattr(jp, k)) < t, k
    assert _rel(pre.cov.numpy(), jp.cov) < cov_tol


def _port(rows, bias=BIAS):
    r = torch.as_tensor(rows)
    return preintegrate(r[:, 1:4], r[:, 4:7], r[:, 0], torch.as_tensor(bias),
                        CALIB)


@pytest.mark.parametrize("n", [1, 20, 200, 1024])
def test_preintegrate_matches_padded_reference(n):
    """The port unpadded against the reference padded to its bucket."""
    rows = _rows(n)
    jp = jit_mod._preintegrate_rows(rows, BIAS, J_CALIB, jit_mod.KF_BUCKETS)
    _check(_port(rows), jp)


def test_preintegrate_empty_window_is_identity():
    jp = jit_mod._preintegrate_rows(np.zeros((0, 7), np.float32), BIAS,
                                    J_CALIB, jit_mod.FRAME_BUCKETS)
    pre = _port(np.zeros((0, 7), np.float32))
    for k in DELTAS + ("cov",):
        np.testing.assert_array_equal(getattr(pre, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def test_batched_preintegration_equals_per_interval_calls():
    """Intervals of 3, 17, 40 and 1 rows with their own biases in one
    batched integration: every field equal to the per-interval calls."""
    lens = (3, 17, 40, 1)
    rows = [_rows(n, seed=i) for i, n in enumerate(lens)]
    biases = np.stack([BIAS * (i + 1) for i in range(len(lens))])
    batch = it_mod._preintegrate_intervals(rows, biases, CALIB)
    for i, r in enumerate(rows):
        one = _port(r, biases[i])
        for k in DELTAS + ("cov", "bias"):
            np.testing.assert_allclose(getattr(batch, k)[i].numpy(),
                                       getattr(one, k).numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("n,port_max,ref_buckets", [
    (1500, it_mod.FRAME_MAX_ROWS, jit_mod.FRAME_BUCKETS),
    (4200, it_mod.KF_MAX_ROWS, jit_mod.KF_BUCKETS),
], ids=["frame_1024", "keyframe_4096"])
def test_preintegrate_rows_truncates_as_the_reference(n, port_max, ref_buckets):
    """Windows longer than the largest bucket keep their last rows: 1024
    for a frame window, 4096 for a keyframe interval.  The deltas within
    1e-5 and the covariance within 1e-4 as above; the bias Jacobians, which
    grow with the window, within 5e-5 over 4096 steps (measured on the
    CPU: 1.15e-5)."""
    rows = _rows(n)
    jp = jit_mod._preintegrate_rows(rows, BIAS, J_CALIB, ref_buckets)
    pre = it_mod._preintegrate_rows(rows, BIAS, CALIB, port_max)
    assert abs(float(pre.dT) - port_max * 0.005) < 1e-3
    _check(pre, jp, jac_tol=1e-5 if port_max <= 1024 else 5e-5)


def _pair(seed):
    rows = _rows(40, seed)
    jp = jit_mod._preintegrate_rows(rows, BIAS, J_CALIB, jit_mod.KF_BUCKETS)
    pre = Preintegrated(**{k: torch.as_tensor(np.asarray(getattr(jp, k)))
                           for k in Preintegrated.__dataclass_fields__})
    return jp, pre


def test_bias_corrected_deltas_predict_state_and_residual():
    """The first-order bias correction, the state prediction and the 9-D
    residual on the reference's own Preintegrated: within 1e-6 relative."""
    jp, pre = _pair(3)
    rng = np.random.default_rng(4)
    nb = (BIAS + rng.normal(0, 0.01, 6)).astype(np.float32)
    for a, b in zip(bias_corrected_deltas(pre, torch.as_tensor(nb)),
                    jpre.bias_corrected_deltas(jp, jnp.asarray(nb))):
        assert _rel(a.numpy(), b) < 1e-6
    R = np.asarray(jso3.exp_so3(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    p = np.array([1.0, -2.0, 0.5], np.float32)
    v = np.array([0.3, 0.1, -0.2], np.float32)
    T = torch.as_tensor
    for a, b in zip(predict_state(T(R), T(p), T(v), pre, T(nb)),
                    jpre.predict_state(jnp.asarray(R), jnp.asarray(p),
                                       jnp.asarray(v), jp, jnp.asarray(nb))):
        assert _rel(a.numpy(), b) < 1e-6
    R2 = np.asarray(jso3.exp_so3(jnp.asarray([0.12, -0.18, 0.33], jnp.float32)))
    p2 = np.array([1.1, -1.9, 0.4], np.float32)
    v2 = np.array([0.35, 0.0, -0.1], np.float32)
    a = inertial_residual(T(R), T(p), T(v), T(R2), T(p2), T(v2), T(nb), pre)
    b = jpre.inertial_residual(*map(jnp.asarray, (R, p, v, R2, p2, v2, nb)), jp)
    assert _rel(a.numpy(), b) < 1e-5
    # Batched over a leading axis: rows equal to the single calls.
    stack = pre.map(lambda x: torch.stack([x, x]))
    ab = inertial_residual(T(np.stack([R, R2])), T(np.stack([p, p2])),
                           T(np.stack([v, v2])), T(np.stack([R2, R])),
                           T(np.stack([p2, p])), T(np.stack([v2, v])),
                           T(nb), stack)
    np.testing.assert_allclose(ab[0].numpy(), a.numpy(), atol=1e-6)


def test_right_jacobians_match_reference():
    """J_r and J_r^-1 over small (series branch) and large angles, and
    their product the identity: within 1e-6."""
    rng = np.random.default_rng(5)
    w = np.concatenate([rng.normal(0, 1e-5, (4, 3)), rng.normal(0, 1.0, (16, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    Jr = so3.right_jacobian_so3(torch.as_tensor(w)).numpy()
    Ji = so3.right_jacobian_inv_so3(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(Jr, np.asarray(jso3.right_jacobian_so3(
        jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(Ji, np.asarray(jso3.right_jacobian_inv_so3(
        jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(Jr @ Ji, np.broadcast_to(np.eye(3), Jr.shape),
                               atol=1e-5)


def test_inertial_trajectory_matches_reference():
    """The port's generator (numpy and the port's so3) against the
    reference's (jnp) on the same rng: poses, velocities and IMU rows
    within 1e-6."""
    kw = dict(fps=10.0, imu_freq=200.0, amp=(0.45, 0.18, 0.0),
              omega=(1.5, 0.9, 0.0), rot_amp=(0.02, 0.05, 0.03))
    a = synthetic.inertial_trajectory(8, rng=np.random.default_rng(11), **kw)
    b = jsynthetic.inertial_trajectory(8, rng=np.random.default_rng(11), **kw)
    for k in ("R_cw", "t_cw", "vel_w", "gravity_w", "bias", "timestamps"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    assert len(a["imu"]) == len(b["imu"]) == 8
    for x, y in zip(a["imu"], b["imu"]):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=1e-6)
