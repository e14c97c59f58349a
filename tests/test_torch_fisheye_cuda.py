"""The port's fisheye (KB8) path on the card against the CPU, on the same
inputs: the KB8 projection, unprojection and Jacobian, the non-rectified
stereo matcher ``match_stereo_fisheye``, and one carried fisheye fused
frame.  This file imports no JAX, so it runs on a card machine without it;
it also holds the fisheye scenarios that ``test_torch_kb8.py`` and
``test_torch_fisheye_pipeline.py`` run through both packages on the CPU.
The card tests skip where no card is present.  On a GPU machine run

    python -m pytest -q -m "gpu and not slow" tests/test_torch_fisheye_cuda.py
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.cameras import kb8
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_inertial_cuda import FEATURES, capture_state

torch.set_num_threads(2)

# TUM-VI's 512x512 fisheye calibration (Examples/Monocular/TUM_512.yaml
# scale), as tests/test_fisheye_pipeline.py holds it.
KB8 = (190.978, 190.973, 254.932, 256.897,
       0.00348238, 0.000715035, -0.00205323, 0.000202936)
KB8_PARAMS = np.asarray(KB8 + (0.0,), np.float32)
T_RL = np.array([-0.10, 0.0, 0.0], np.float32)
DEVICES = ("cpu", "cuda")


def kb8_kw(**kw):
    """TrackerConfig fields of the TUM-VI lens (either package)."""
    return dict(width=512, height=512, fx=KB8[0], fy=KB8[1], cx=KB8[2],
                cy=KB8[3], dist=KB8[4:], camera_model="kb8", **kw)


def kb8_world(seed=8):
    return synthetic.make_textured_world(
        np.random.default_rng(seed), width=512, height=512, depth=6.0,
        kb8_params=KB8)


def mono_fisheye_frames(n, n_traj=30):
    """test_mono_fisheye_slam's images (world seed 8, noise seed 5), the
    first n of its n_traj-frame path, with the path's ground truth."""
    rng = np.random.default_rng(5)
    world = kb8_world()
    R, t = synthetic.lateral_trajectory(n_traj, x_span=1.0, z_span=0.0,
                                        y_amp=0.05)
    imgs = [synthetic.render_textured(world, R[i], t[i], rng=rng)
            for i in range(n)]
    return imgs, R[:n], t[:n]


def stereo_fisheye_pairs(n, n_traj=25):
    """test_stereo_fisheye_slam's pairs (world seed 8, noise seed 9, the
    right camera at t + t_rl), the first n of its n_traj-frame path."""
    rng = np.random.default_rng(9)
    world = kb8_world()
    R, t = synthetic.lateral_trajectory(n_traj, x_span=0.9, z_span=0.0,
                                        y_amp=0.05)
    pairs = []
    for i in range(n):
        left = synthetic.render_textured(world, R[i], t[i], rng=rng)
        right = synthetic.render_textured(world, R[i], t[i] + T_RL, rng=rng)
        pairs.append((left, right))
    return pairs, R[:n], t[:n]


def fisheye_inertial_scenario(seed, n):
    """The reference inertial tests' excited path (amp (0.45, 0.18, 0),
    omega (1.5, 0.9, 0), no rotation, 200 Hz IMU) over a KB8 world, seen by
    the TUM-VI rig (t_rl = (-0.10, 0, 0)); world, path, IMU rows and images
    from one rng stream.  Returns (frames as (left, right) pairs, traj)."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_textured_world(rng, width=512, height=512,
                                          depth=6.0, kb8_params=KB8)
    traj = synthetic.inertial_trajectory(
        n, fps=10.0, imu_freq=200.0, rng=rng, amp=(0.45, 0.18, 0.0),
        omega=(1.5, 0.9, 0.0), rot_amp=(0.0, 0.0, 0.0))
    frames = []
    for i in range(n):
        R, t = traj["R_cw"][i], traj["t_cw"][i]
        frames.append((synthetic.render_textured(world, R, t, rng=rng),
                       synthetic.render_textured(world, R, t + T_RL, rng=rng)))
    return frames, traj


def wide_angle_points(seed, n, max_deg=100.0):
    """Camera-frame points from 0 to max_deg off-axis at 0.5-10 m, with
    the optical axis and a point at the 1e-16 floor of x^2 + y^2."""
    rng = np.random.default_rng(seed)
    th = np.radians(rng.uniform(0.0, max_deg, n))
    ph = rng.uniform(0.0, 2 * np.pi, n)
    d = rng.uniform(0.5, 10.0, n)
    X = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1) * d[:, None]
    X[0] = (0.0, 0.0, 3.0)
    X[1] = (1e-9, 0.0, 2.0)
    return X.astype(np.float32)


def stereo_rig_problem(seed=3, n=128):
    """test_fisheye_stereo_matching's rig: n points across the FOV (past
    90 degrees included), projected into both KB8 cameras, identical
    descriptors on both sides.  Returns (X, inputs) with inputs the numpy
    arguments of match_stereo_fisheye after the two projection callables,
    and before the bearings, which the caller unprojects."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, np.radians(95.0), n)
    phi = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(1.0, 6.0, n)
    X = (np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   np.cos(theta)], -1) * r[:, None]).astype(np.float32)
    R_rl = np.eye(3, dtype=np.float32)
    p = torch.as_tensor(KB8_PARAMS)
    uv_l = kb8.project(p, torch.as_tensor(X)).numpy()
    uv_r = kb8.project(p, torch.as_tensor(X @ R_rl.T + T_RL)).numpy()
    valid = (((uv_l > 2) & (uv_l < 510)).all(-1)
             & ((uv_r > 2) & (uv_r < 510)).all(-1))
    desc = (rng.random((n, 256)) < 0.5).astype(np.uint8)
    return X, theta, dict(R_rl=R_rl, t_rl=T_RL, uv_l=uv_l, uv_r=uv_r,
                          level=np.zeros(n, np.int32), desc=desc, valid=valid,
                          angle=np.zeros(n, np.float32))


def run_fisheye_matcher(d, prob, uv_l=None, uv_r=None, **kw):
    """match_stereo_fisheye on device d over a stereo_rig_problem (or the
    given keypoints with the problem's other fields)."""
    from orb_slam3_study_kr_tpu_torch.ops.fisheye_stereo import (
        match_stereo_fisheye)
    p = torch.as_tensor(KB8_PARAMS, device=d)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=d)

    uv_l = t(prob["uv_l"] if uv_l is None else uv_l)
    uv_r = t(prob["uv_r"] if uv_r is None else uv_r)

    def proj(x):
        return kb8.project(p, x)

    side = (t(prob["level"]), t(prob["desc"]), t(prob["valid"]),
            t(prob["angle"]))
    out = match_stereo_fisheye(
        proj, proj, KB8[0], t(prob["R_rl"]), t(prob["t_rl"]),
        uv_l, kb8.unproject(p, uv_l), *side,
        uv_r, kb8.unproject(p, uv_r), *side, **kw)
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's entry points run there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kb8_on_the_card_matches_the_cpu(dev):
    """project within 1e-3 px, unproject within 1e-5 and project_jac within
    1e-4 relative of the CPU's, on points from 0 to 100 degrees off-axis
    (float32 with another fused-multiply-add contraction and atan2 / sin /
    cos of the device's math library)."""
    X = wide_angle_points(0, 512)
    out = []
    for d in DEVICES:
        p = torch.as_tensor(KB8_PARAMS, device=d)
        x = torch.as_tensor(X, device=d)
        uv = kb8.project(p, x)
        out.append([a.cpu().numpy() for a in
                    (uv, kb8.unproject(p, uv), kb8.project_jac(p, x))])
    (uc, bc, jc), (ug, bg, jg) = out
    assert np.abs(ug - uc).max() < 1e-3
    assert np.abs(bg - bc).max() < 1e-5
    scale = np.abs(jc).max(axis=(-1, -2), keepdims=True)
    assert (np.abs(jg - jc) / scale).max() < 1e-4


@pytest.mark.gpu
def test_fisheye_stereo_matcher_on_the_card_matches_the_cpu(dev):
    """match_stereo_fisheye on test_fisheye_stereo_matching's rig: idx_r
    and ok identical, X within 1e-3 m where accepted (a ray DLT through
    cuSOLVER's SVD against LAPACK's)."""
    _, _, prob = stereo_rig_problem()
    c, g = (run_fisheye_matcher(d, prob) for d in DEVICES)
    assert c["ok"].sum() >= 0.8 * prob["valid"].sum()
    np.testing.assert_array_equal(g["idx_r"], c["idx_r"])
    np.testing.assert_array_equal(g["ok"], c["ok"])
    ok = c["ok"]
    assert np.abs(g["X"][ok] - c["X"][ok]).max() < 1e-3


def _mono_system(d):
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    return SlamSystem(SystemConfig(
        tracker=TrackerConfig(**kb8_kw(fps=10), device=d),
        enable_loop_closing=False, device=d))


K_FUSED = 9       # a fused frame of the mono fisheye session


@pytest.mark.gpu
def test_carried_fisheye_fused_frame_on_the_card_matches_the_cpu(dev):
    """Frame 9 of the mono fisheye session, from the state the port's CPU
    session carries into it and the same features (extracted once on the
    CPU): on the card and on the CPU the tracker takes the fused frame
    (theta-gated matches, |p| > 1e-3 cheirality) with identical bindings
    and the pose within 1e-4; K2 launches at least 4 times on the card and
    never on the CPU."""
    from orb_slam3_study_kr_tpu_torch import convert
    from orb_slam3_study_kr_tpu_torch.ops import cuda_matching
    from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
    imgs, _, _ = mono_fisheye_frames(K_FUSED + 1)
    slam = _mono_system("cpu")
    for i in range(K_FUSED):
        slam.track_monocular(imgs[i], i * 0.1)
    assert slam.state.name == "OK"
    state = capture_state(slam)
    feats = _mono_system("cpu").tracker._extract_frame(imgs[K_FUSED], 0.0)
    host = {k: np.array(getattr(feats, k)) for k in FEATURES}
    out = []
    for d in DEVICES:
        tr = _mono_system(d).tracker
        convert.tracker_state_from_numpy(tr, **state)
        frame = Frame(frame_id=K_FUSED, timestamp=K_FUSED * 0.1, device=d,
                      pyr=feats.pyr.to(d),
                      **{k: v.copy() for k, v in host.items()})
        tr._update_last_frame()
        cuda_matching.gated_nn.launches = 0
        n = tr._track_fused_frame(frame)
        if d == "cuda":
            torch.cuda.synchronize()
        out.append(dict(n=n, R=frame.R_cw, t=frame.t_cw, kp_lm=frame.kp_lm,
                        k2=cuda_matching.gated_nn.launches))
    c, g = out
    assert c["n"] is not None and c["n"] > 25 and g["n"] == c["n"]
    assert c["k2"] == 0 and g["k2"] >= 4
    np.testing.assert_array_equal(g["kp_lm"], c["kp_lm"])
    np.testing.assert_allclose(g["R"], c["R"], atol=1e-4)
    np.testing.assert_allclose(g["t"], c["t"], atol=1e-4)
