"""Parity of the torch port's Lie groups and pinhole camera with the JAX
reference package on the same numpy inputs.

Tolerance: 1e-5 relative (plus 1e-6 absolute for values near 0).  Both
packages evaluate the same float32 formulas; transcendental functions and
3x3 products may round differently by a few ulps.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.cameras import pinhole as jpinhole
from orb_slam3_study_kr_tpu.lie import se3 as jse3
from orb_slam3_study_kr_tpu.lie import so3 as jso3
from orb_slam3_study_kr_tpu_torch.cameras import pinhole as tpinhole
from orb_slam3_study_kr_tpu_torch.lie import se3 as tse3
from orb_slam3_study_kr_tpu_torch.lie import so3 as tso3

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _tangents(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:8] *= 1e-5          # small-angle series branch
    w[8:16] *= 3.0 / np.linalg.norm(w[8:16], axis=1, keepdims=True)  # near pi
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_exp_log(seed):
    w = _tangents(seed)
    Rj = np.asarray(jso3.exp_so3(jnp.asarray(w)))
    Rt = tso3.exp_so3(torch.as_tensor(w)).numpy()
    _close(Rt, Rj)
    _close(tso3.log_so3(torch.as_tensor(np.array(Rj))).numpy(),
           np.asarray(jso3.log_so3(jnp.asarray(Rj))))
    _close(tso3.left_jacobian_so3(torch.as_tensor(w)).numpy(),
           np.asarray(jso3.left_jacobian_so3(jnp.asarray(w))))
    _close(tso3.matrix_to_quat(torch.as_tensor(np.array(Rj))).numpy(),
           np.asarray(jso3.matrix_to_quat(jnp.asarray(Rj))), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_log_compose(seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(32, 6)).astype(np.float32)
    Rj, tj = jse3.exp_se3(jnp.asarray(xi))
    Rt, tt = tse3.exp_se3(torch.as_tensor(xi))
    _close(Rt.numpy(), np.asarray(Rj))
    _close(tt.numpy(), np.asarray(tj))
    _close(tse3.log_se3(torch.as_tensor(np.asarray(Rj)),
                        torch.as_tensor(np.asarray(tj))).numpy(),
           np.asarray(jse3.log_se3(Rj, tj)))
    Rb, tb = np.asarray(Rj)[::-1].copy(), np.asarray(tj)[::-1].copy()
    cj = jse3.se3_compose(Rj, tj, jnp.asarray(Rb), jnp.asarray(tb))
    ct = tse3.se3_compose(Rt, tt, torch.as_tensor(Rb), torch.as_tensor(tb))
    for a, b in zip(ct, cj):
        _close(a.numpy(), np.asarray(b))
    ij = jse3.se3_inverse(Rj, tj)
    it = tse3.se3_inverse(Rt, tt)
    for a, b in zip(it, ij):
        _close(a.numpy(), np.asarray(b))


PARAMS = {
    "ideal": [458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0],
    "radtan": [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907,
               0.00019359, 1.76187114e-05, 0.0],
}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_pinhole_project_unproject(name):
    params = np.asarray(PARAMS[name], np.float32)
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                    rng.uniform(1, 10, 200)], -1).astype(np.float32)
    jp, tp = jnp.asarray(params), torch.as_tensor(params)
    uv_j = np.asarray(jpinhole.project(jp, jnp.asarray(pts)))
    _close(tpinhole.project(tp, torch.as_tensor(pts)).numpy(), uv_j)
    _close(tpinhole.project_jac(tp, torch.as_tensor(pts)).numpy(),
           np.asarray(jpinhole.project_jac(jp, jnp.asarray(pts))))
    # 8-iteration fixed-point undistortion (fori_loop in the reference).
    _close(tpinhole.unproject(tp, torch.as_tensor(uv_j)).numpy(),
           np.asarray(jpinhole.unproject(jp, jnp.asarray(uv_j))))
    # Round trip through the ported undistort_px map used by tracking.
    und_t = tpinhole.project(torch.as_tensor(np.asarray(PARAMS["ideal"], np.float32)),
                             tpinhole.unproject(tp, torch.as_tensor(uv_j)))
    und_j = jpinhole.project(jnp.asarray(PARAMS["ideal"], jnp.float32),
                             jpinhole.unproject(jp, jnp.asarray(uv_j)))
    _close(und_t.numpy(), np.asarray(und_j), rtol=1e-5, atol=1e-4)


def test_pinhole_partial_matches_tracker_convention():
    """project_fn = partial(project, ideal_params), as both trackers build it."""
    params = torch.as_tensor(np.asarray(PARAMS["ideal"], np.float32))
    f = functools.partial(tpinhole.project, params)
    pts = torch.tensor([[0.1, -0.2, 2.0], [0.0, 0.0, 1e-9]])
    uv = f(pts)
    assert torch.isfinite(uv).all()
    np.testing.assert_allclose(uv[0].numpy(), [376.0 + 458.0 * 0.05,
                                               240.0 - 457.0 * 0.1], rtol=1e-6)
