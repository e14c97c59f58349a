"""The port's inertial modules on the card against the CPU, on the same
inputs: the batched preintegration, the four solvers of
``solvers/inertial.py``, ``inertial_bundle_adjust`` in its three modes and
one carried post-init frame that takes the split rounds with the
pose-inertial solve.  The problems are the ones ``test_torch_inertial.py``
holds against JAX, rebuilt from the port alone (this file imports no JAX,
so it runs on a card machine without it).  Each test states its tolerance:
the same float32 solves with other reduction orders (cuBLAS, cuSOLVER and
the inertial BA's scatter-adds, in the card's fixed order of
``ops/segment.py`` against the CPU's input order) agree to float32 rounding amplified by each problem's conditioning, with
the same bounds as against the reference.  These tests skip where no card
is present.  On a GPU machine run

    python -m pytest -q -m "gpu and not slow" tests/test_torch_inertial_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.cameras import pinhole
from orb_slam3_study_kr_tpu_torch.imu import ImuCalib, Preintegrated
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.lie.so3 import exp_so3
from orb_slam3_study_kr_tpu_torch.pipeline.inertial_tracking import (
    _preintegrate_intervals)
from orb_slam3_study_kr_tpu_torch.solvers import inertial
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
    inertial_bundle_adjust)

pytestmark = pytest.mark.gpu

CAM = [458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0]
DEVICES = ("cpu", "cuda")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's entry points run there")
    return torch.device("cuda", 0)


def on(d, x):
    """x (numpy, tensor, Preintegrated or a tuple of them) on device d;
    numpy integers as int64, floats as float32."""
    if isinstance(x, Preintegrated):
        return x.map(lambda a: a.to(d))
    if isinstance(x, (tuple, list)):
        return type(x)(on(d, a) for a in x)
    if isinstance(x, torch.Tensor):
        return x.to(d)
    a = np.asarray(x)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind == "i"
                           else torch.float32, device=d)


def host(x):
    return x.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rot(v):
    return host(exp_so3(torch.as_tensor(np.asarray(v, np.float32))))


def _chain(seed, n_frames=31, kf_every=3, bias=None,
           gravity_w=(0.0, 9.4, -2.8)):
    """Keyframe body states every kf_every frames of the analytic
    trajectory (body == camera) and their windows preintegrated on the CPU
    at the bias estimate `bias` (zero by default)."""
    rng = np.random.default_rng(seed)
    traj = synthetic.inertial_trajectory(n_frames, fps=10.0, imu_freq=200.0,
                                         gravity_w=gravity_w, rng=rng)
    kf = np.arange(0, n_frames, kf_every)
    R_wb = np.stack([traj["R_cw"][i].T for i in kf]).astype(np.float32)
    p_wb = np.stack([-traj["R_cw"][i].T @ traj["t_cw"][i]
                     for i in kf]).astype(np.float32)
    rows = [np.concatenate([traj["imu"][j] for j in range(a + 1, b + 1)])
            for a, b in zip(kf[:-1], kf[1:])]
    b = np.zeros(6, np.float32) if bias is None else bias
    pre = _preintegrate_intervals(rows, np.tile(b, (len(rows), 1)),
                                  ImuCalib.make(freq=200.0, device="cpu"))
    return dict(rng=rng, traj=traj, kf=kf, R=R_wb, p=p_wb,
                v=traj["vel_w"][kf].astype(np.float32), pre=pre, rows=rows)


def _each_device(fn):
    """fn(device) on the CPU and on the card."""
    cpu, card = (fn(torch.device(d)) for d in DEVICES)
    torch.cuda.synchronize()
    return card, cpu


def test_preintegration_on_the_card_matches_the_cpu(dev):
    """The batched preintegration of ten keyframe windows: deltas and the
    accelerometer Jacobians within 1e-5, the 15x15 covariance within 1e-4,
    relative.  The gyro Jacobians (JRg, JVg, JPg) within 1e-4: they sum
    the per-sample (1 - cos th) / th^2 terms, which cancel in float32 at
    th ~ 5e-3 rad, so that float32 itself is 4.7e-5 from float64 on the
    CPU and the card's cosf rounds otherwise than the host's (measured
    1.4e-5 apart)."""
    c = _chain(0)
    bias = np.tile(np.asarray([0.004, -0.002, 0.003, 0.03, -0.05, 0.02],
                              np.float32), (len(c["rows"]), 1))
    g, r = _each_device(lambda d: _preintegrate_intervals(
        c["rows"], bias, ImuCalib.make(freq=200.0, device=d)))
    err = {k: _rel(host(getattr(g, k)), host(getattr(r, k)))
           for k in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg",
                     "JPa", "cov")}
    tol = dict(JRg=1e-4, JVg=1e-4, JPg=1e-4, cov=1e-4)
    assert all(e < tol.get(k, 1e-5) for k, e in err.items()), err


@pytest.mark.parametrize("fix_scale", [False, True], ids=["mono", "fixed"])
def test_inertial_only_optimization_on_the_card_matches_the_cpu(dev,
                                                                fix_scale):
    """IMU init on an 11-keyframe chain (true scale 2.7, or fixed scale on
    metric positions), the linear seed included: scale within 1e-4
    relative, gravity rotation and bias within 1e-4, velocities within
    1e-3 m/s, edge norms within 1e-3 relative."""
    bias = np.asarray([0.004, -0.006, 0.003, 0.06, -0.04, 0.05], np.float32)
    c = _chain(1, bias=bias)
    p_vis = c["p"] if fix_scale else c["p"] / 2.7
    g, r = _each_device(lambda d: inertial.inertial_only_optimization(
        on(d, c["R"]), on(d, p_vis), on(d, c["pre"]), prior_gyro=1e2,
        prior_acc=1e5, fix_scale=fix_scale))
    assert _rel(host(g["scale"]), host(r["scale"])) < 1e-4
    for k, tol in (("R_wg", 1e-4), ("bias", 1e-4), ("v", 1e-3)):
        np.testing.assert_allclose(host(g[k]), host(r[k]), atol=tol,
                                   err_msg=k)
    assert _rel(host(g["edge_norms"]), host(r["edge_norms"])) < 1e-3
    if not fix_scale:
        assert abs(float(host(r["scale"])) / 2.7 - 1.0) < 0.05


def test_estimate_gyro_bias_on_the_card_matches_the_cpu(dev):
    """The robust gyro-bias solve with a 2-degree glitched keyframe: bias
    within 1e-6, edge weights within 1e-4, the glitch down-weighted on
    both."""
    c = _chain(2, n_frames=34,
               bias=np.zeros(6, np.float32))
    R = c["R"].copy()
    R[5] = R[5] @ _rot([0.0, np.radians(2.0), 0.0])
    g, r = _each_device(lambda d: inertial.estimate_gyro_bias(
        on(d, R[:-1]), on(d, R[1:]), on(d, c["pre"])))
    np.testing.assert_allclose(host(g[0]), host(r[0]), atol=1e-6)
    np.testing.assert_allclose(host(g[1]), host(r[1]), atol=1e-4)
    assert host(r[1])[4] < 0.5 and host(r[1])[5] < 0.5


def _pose_problem(seed):
    """One window between two states, 200 landmarks seen from the second
    (10 gross outliers, mixed levels) and a perturbed initial guess."""
    c = _chain(seed, n_frames=4, kf_every=3, gravity_w=(0.0, 0.0, -9.81))
    rng = c["rng"]
    N = 200
    R1, p1, v1 = c["R"][1], c["p"][1], c["v"][1]
    pc = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                   rng.uniform(4, 10, N)], -1).astype(np.float32)
    X = (pc @ R1.T + p1).astype(np.float32)
    uv = host(pinhole.project(torch.tensor(CAM), torch.as_tensor(pc)))
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    uv[:10] += 25.0
    init = ((R1 @ _rot([0.01, -0.02, 0.01])).astype(np.float32),
            (p1 + np.asarray([0.05, -0.04, 0.06])).astype(np.float32),
            (v1 + np.asarray([0.2, -0.1, 0.1])).astype(np.float32))
    anchor = (c["R"][0], c["p"][0], c["v"][0], np.zeros(6, np.float32))
    level = rng.integers(0, 3, N).astype(np.int32)
    common = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X, uv,
              level, np.ones(N, np.float32))
    return c["pre"][0], anchor, init, common


def _pose_solve(d, prob, last_frame):
    pre, anchor, init, common = prob
    project = functools.partial(pinhole.project, torch.tensor(CAM, device=d))
    args = (*on(d, init), *on(d, common[:4]),
            on(d, common[4]).to(torch.int32), on(d, common[5]))
    if not last_frame:
        return inertial.pose_inertial_optimization(
            project, *on(d, anchor), on(d, pre), *args, n_iters=10)
    prior = inertial.pose_inertial_optimization(
        project, *on(d, anchor), on(d, pre), *args)[5]
    return inertial.pose_inertial_optimization_last_frame(
        project, *on(d, anchor), prior, on(d, pre), *args, n_iters=10)


@pytest.mark.parametrize("last_frame", [False, True],
                         ids=["fixed_anchor", "last_frame"])
def test_pose_inertial_on_the_card_matches_the_cpu(dev, last_frame):
    """The frame solve against a fixed anchor, and the joint 30-dof solve
    under the 15-D prior that the first gives (each device carries its
    own): rotation and position within 1e-5, velocity within 1e-4, bias
    within 1e-5, identical inliers, info within 1e-3 relative."""
    prob = _pose_problem(3 if last_frame else 2)
    g, r = _each_device(lambda d: _pose_solve(d, prob, last_frame))
    g, r = [host(a) for a in g], [host(a) for a in r]
    for i, tol in ((0, 1e-5), (1, 1e-5), (2, 1e-4), (3, 1e-5)):
        np.testing.assert_allclose(g[i], r[i], atol=tol, err_msg=str(i))
    np.testing.assert_array_equal(g[4], r[4])
    assert np.isfinite(r[5]).all() and _rel(g[5], r[5]) < 1e-3
    assert r[4].sum() >= 180


def _ba_problem(seed, bias_est=None, n_frames=41, kf_every=4, n_lm=64):
    """test_inertial_ba's problem: keyframes every 4th frame of the
    gravity-aligned trajectory, 64 landmarks seen from every keyframe."""
    c = _chain(seed, n_frames=n_frames, kf_every=kf_every, bias=bias_est,
               gravity_w=(0.0, 0.0, -9.81))
    rng, traj = c["rng"], c["traj"]
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 8, n_lm)], 1).astype(np.float32)
    uv = []
    for i in c["kf"]:
        pc = X @ traj["R_cw"][i].T + traj["t_cw"][i]
        u = host(pinhole.project(torch.tensor(CAM), torch.as_tensor(
            pc.astype(np.float32))))
        uv.append((u + rng.normal(0, 0.3, u.shape)).astype(np.float32))
    K = c["kf"].size
    c.update(K=K, X=X, obs_uv=np.concatenate(uv),
             obs_pose=np.repeat(np.arange(K, dtype=np.int32), n_lm),
             obs_lm=np.tile(np.arange(n_lm, dtype=np.int32), K))
    return c


def _perturb(c, keep_first=1, rot=0.01, pos=0.03, vel=0.08, lm=0.03):
    rng = c["rng"]
    R, p, v, X = (c[k].copy() for k in ("R", "p", "v", "X"))
    for k in range(keep_first, c["K"]):
        R[k] = R[k] @ _rot(rng.normal(0, rot, 3))
        p[k] += rng.normal(0, pos, 3).astype(np.float32)
        v[k] += rng.normal(0, vel, 3).astype(np.float32)
    X += rng.normal(0, lm, X.shape).astype(np.float32)
    return R, p, v, X


def _ba(d, c, start, bias0, fixed, **kw):
    R0, p0, v0, X0 = start
    K, O = c["K"], c["obs_pose"].shape[0]
    cam = torch.tensor(CAM, device=d)
    args = [R0, p0, v0, bias0, fixed, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), X0, np.ones(X0.shape[0], np.float32),
            c["obs_pose"], c["obs_lm"], c["obs_uv"], np.zeros(O, np.int32),
            np.ones(O, np.float32), np.arange(K - 1, dtype=np.int32),
            np.arange(1, K, dtype=np.int32)]
    t = on(d, args)
    pre = on(d, c["pre"])
    kw = {k: (on(d, v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return inertial_bundle_adjust(
        functools.partial(pinhole.project, cam),
        functools.partial(pinhole.project_jac, cam), *t[:16], pre,
        torch.ones(K - 1, device=d), **kw)


BA_TOL = dict(R=1e-4, p=1e-4, v=1e-3, bias=1e-4, X=1e-3, chi2=1e-2, cost=1e-3)
B_TRUE = np.array([0.004, -0.002, 0.003, 0.03, -0.05, 0.02], np.float32)


@pytest.mark.parametrize("mode", ["shared_bias", "per_kf_bias",
                                  "fixed_anchor_window"])
def test_inertial_ba_on_the_card_matches_the_cpu(dev, mode):
    """FullInertialBA's init mode (shared bias, priors 1e2/1e10), per-
    keyframe biases with random-walk edges, and LocalInertialBA's window
    (the last 5 states free, a free anchor velocity and bias, the stereo
    row on half of the observations), from the same perturbed start: every
    output within BA_TOL, the normal equations' scatter-adds in another
    order than the CPU's included; fixed states bit-identical."""
    if mode == "shared_bias":
        c = _ba_problem(3)
        K = c["K"]
        fixed = np.zeros(K, np.float32)
        fixed[0] = 1.0
        start = _perturb(c)
        bias0 = np.zeros((K, 6), np.float32)
        kw = dict(n_iters=15, shared_bias=True, bias_src=K - 1,
                  prior_gyro=1e2, prior_acc=1e10)
    elif mode == "per_kf_bias":
        c = _ba_problem(4, bias_est=B_TRUE)
        K = c["K"]
        fixed = np.zeros(K, np.float32)
        fixed[0] = 1.0
        start = _perturb(c)
        bias0 = (np.tile(B_TRUE, (K, 1))
                 + c["rng"].normal(0, 2e-4, (K, 6))).astype(np.float32)
        bias0[0] = B_TRUE
        kw = dict(n_iters=12, shared_bias=False)
    else:
        c = _ba_problem(5, bias_est=B_TRUE)
        K, W = c["K"], 5
        fixed = np.ones(K, np.float32)
        fixed[-W:] = 0.0
        fixed_vb = fixed.copy()
        fixed_vb[K - W - 1] = 0.0
        start = _perturb(c, keep_first=K - W, lm=0.01)
        bias0 = np.tile(B_TRUE, (K, 1))
        ur = (c["obs_uv"][:, 0] - 458.0 * 0.11 / 6.0).astype(np.float32)
        ur[::2] = -1.0
        kw = dict(n_iters=10, shared_bias=False, fixed_vb=fixed_vb,
                  obs_ur=ur, bf=458.0 * 0.11)
    g, r = _each_device(lambda d: _ba(d, c, start, bias0, fixed, **kw))
    for name, a, b in zip(("R", "p", "v", "bias", "X", "chi2", "cost"), g, r):
        a, b = host(a), host(b)
        if name == "chi2":
            np.testing.assert_allclose(a, b, rtol=BA_TOL[name],
                                       atol=BA_TOL[name])
        elif name == "cost":
            assert _rel(a, b) < BA_TOL[name], (a, b)
        else:
            np.testing.assert_allclose(a, b, atol=BA_TOL[name], err_msg=name)
    if mode == "fixed_anchor_window":
        np.testing.assert_array_equal(host(g[1])[: K - W], start[1][: K - W])


def inertial_scenario(seed, n, sensor):
    """World, trajectory and per-frame image arguments of the reference's
    inertial pipeline tests (amp (0.45, 0.18, 0), omega (1.5, 0.9, 0), no
    rotation), cut to n frames: the same rng stream, so the same images
    and IMU rows as the reference's own generator gives."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_textured_world(rng, depth=6.0)
    traj = synthetic.inertial_trajectory(
        n, fps=10.0, imu_freq=200.0, rng=rng, amp=(0.45, 0.18, 0.0),
        omega=(1.5, 0.9, 0.0), rot_amp=(0.0, 0.0, 0.0))
    frames = []
    for i in range(n):
        R, t = traj["R_cw"][i], traj["t_cw"][i]
        if sensor == "mono-inertial":
            frames.append((synthetic.render_textured(world, R, t, rng=rng),))
        elif sensor == "rgbd-inertial":
            img, depth = synthetic.render_textured(world, R, t, rng=rng,
                                                   return_depth=True)
            frames.append((img, np.where(np.isfinite(depth), depth, 0.0)))
        else:
            _, t_r = synthetic.stereo_right_pose(R, t, 0.11)
            frames.append((synthetic.render_textured(world, R, t, rng=rng),
                           synthetic.render_textured(world, R, t_r, rng=rng)))
    return frames, traj


# The carried split frame: test_torch_inertial_pipeline's session (seed 11,
# 12 frames at fps=3, IMU init at frame 9), here run by the port on the CPU.
N, K_SPLIT, TIMES, SPACING, FPS = 12, 11, (0.9, 1.5, 2.1), 0.3, 3
FEATURES = ("uv", "uv_raw", "level", "angle", "response", "desc", "valid",
            "patch")


def capture_state(slam):
    """Numpy snapshot of a tracker's visual state, as
    convert.tracker_state_from_numpy takes it."""
    tr, m = slam.tracker, slam.tracker.map
    tables = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in vars(m).items()
              if isinstance(v, (np.ndarray, int, float, bool))}
    lf = tr.last_frame
    last = {k: np.array(getattr(lf, k)) for k in FEATURES}
    last.update(kp_lm=lf.kp_lm.copy(), R_cw=np.array(lf.R_cw),
                t_cw=np.array(lf.t_cw), frame_id=lf.frame_id,
                timestamp=lf.timestamp, ref_kf=lf.ref_kf, pose_ok=lf.pose_ok,
                rel_ref=lf.rel_ref, rel_R=np.array(lf.rel_R),
                rel_t=np.array(lf.rel_t))
    return dict(map_tables=tables, last_frame=last,
                velocity=(None if tr.velocity is None
                          else tuple(np.array(a) for a in tr.velocity)),
                ref_kf=tr.ref_kf, speed_hist=list(tr._speed_hist),
                state=tr.state.name, frame_count=tr.frame_count,
                last_kf_frame_id=tr.last_kf_frame_id,
                last_change_idx=getattr(tr, "_last_change_idx", -1))


def capture_imu(slam):
    """Numpy snapshot of an inertial tracker's IMU state, as
    convert.imu_state_from_numpy takes it."""
    tr = slam.tracker
    return dict(
        bias=tr.bias.copy(), imu_stage=tr.imu_stage,
        kf_imu={k: (p, np.array(r)) for k, (p, r) in tr.kf_imu.items()},
        imu_log=[(t, np.array(r)) for t, r in tr._imu_log],
        prior_info=(None if tr._prior_info is None
                    else np.array(tr._prior_info)),
        prior_change_idx=tr._prior_change_idx, prev_kf_id=tr._prev_kf_id,
        first_kf_ts=tr._first_kf_ts, last_glitch_ts=tr._last_glitch_ts,
        stats={k: v for k, v in tr.stats.items()
               if k in ("imu_init_scale", "imu_refine_scale")},
        last_v_w=tr.last_frame.v_w, last_ok_ts=tr.last_ok_ts)


def _inertial_system(d):
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    return SlamSystem(SystemConfig(
        sensor="mono-inertial", imu_init_times=TIMES,
        enable_loop_closing=False, tracker=TrackerConfig(fps=FPS, device=d),
        device=d))


def test_carried_inertial_split_frame_on_the_card_matches_the_cpu(dev):
    """Frame 11 of the short mono-inertial session, from the state that
    the port's CPU session carries into it (map, last frame, velocity and
    IMU state, installed with convert.tracker_state_from_numpy and
    imu_state_from_numpy) and the same features and blurred pyramid
    (extracted once on the CPU): on the card and on the CPU the tracker
    takes the split rounds (KLT flow anchor, motion-model match, two
    local-map match <-> pose-inertial solve rounds) and ends them with
    identical bindings and the pose within 1e-4; K2 is launched on every
    match on the card and never on the CPU."""
    from orb_slam3_study_kr_tpu_torch import convert
    from orb_slam3_study_kr_tpu_torch.ops import cuda_matching
    from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
    frames, traj = inertial_scenario(11, N, "mono-inertial")
    imgs = [f[0] for f in frames]
    ts, imu = traj["timestamps"], traj["imu"]
    slam = _inertial_system("cpu")
    slam.tracker.imu_init_spacing = SPACING
    for i in range(K_SPLIT):
        slam.track_monocular(imgs[i], ts[i], imu=imu[i])
    assert slam.tracker.imu_stage >= 1
    state, imu_state = capture_state(slam), capture_imu(slam)
    feats = _inertial_system("cpu").tracker._extract_frame(imgs[K_SPLIT], 0.0)
    host = {k: np.array(getattr(feats, k)) for k in FEATURES}
    out = []
    for d in DEVICES:
        tr = _inertial_system(d).tracker
        convert.tracker_state_from_numpy(tr, **state)
        convert.imu_state_from_numpy(tr, **imu_state)

        def extract(img, timestamp, tr=tr, d=d):
            f = Frame(frame_id=tr.frame_count, timestamp=timestamp, device=d,
                      pyr=feats.pyr.to(d),
                      **{k: v.copy() for k, v in host.items()})
            tr.frame_count += 1
            tr.stats["n_frames"] += 1
            return f

        tr._extract_frame = extract
        rec = {}
        orig = tr._track_local_map

        def recording(frame, orig=orig, rec=rec, tr=tr):
            n = orig(frame)
            if "n" not in rec:
                rec.update(n=n, R=np.array(frame.R_cw),
                           t=np.array(frame.t_cw), kp_lm=frame.kp_lm.copy(),
                           split=not tr._use_fused_rounds())
            return n

        tr._track_local_map = recording
        cuda_matching.gated_nn.launches = 0
        tr.process_inertial(imgs[K_SPLIT], ts[K_SPLIT], imu[K_SPLIT])
        if d == "cuda":
            torch.cuda.synchronize()
        rec.update(k2=cuda_matching.gated_nn.launches,
                   solves=tr.stats.get("inertial_solves", 0))
        out.append(rec)
    r, g = out
    assert r["split"] and g["split"] and r["solves"] >= 2
    assert g["solves"] == r["solves"]
    assert r["k2"] == 0 and g["k2"] >= 2
    assert r["n"] > 25 and g["n"] == r["n"]
    np.testing.assert_array_equal(g["kp_lm"], r["kp_lm"])
    np.testing.assert_allclose(g["R"], r["R"], atol=1e-4)
    np.testing.assert_allclose(g["t"], r["t"], atol=1e-4)


# chip_smoke.py phase 14's session (test_mono_inertial_pipeline: seed 11,
# 60 frames, the IMU init at 2.5 / 4.0 / 5.0 s), recorded on the card.
N_PHASE14, TIMES_PHASE14, SHADOW_FRAMES = 60, (2.5, 4.0, 5.0), 8


def _phase14_session(frames, traj, deterministic, shadow, monkeypatch):
    """One phase-14 session on the card.  Per frame: the camera centre and
    the bound keypoints; every IMU-init attempt (frame, accepted, scale,
    median whitened edge norm).  With `shadow`, every inertial-only solve
    runs again on the CPU on the same inputs (and its linear seed on the
    card, the CPU and in float64), and over the first frames
    every triangulation runs again on the CPU in float32 and in float64
    (points nearer than 40 map units in float64)."""
    import os
    from orb_slam3_study_kr_tpu_torch.ops import triangulation_match
    from orb_slam3_study_kr_tpu_torch.pipeline import inertial_tracking
    rec = dict(centres=[], bound=[], attempts=[], init_shadow=[],
               tri_shadow=[])
    frame_no = [0]
    if shadow:
        solve = inertial_tracking.inertial_only_optimization
        tri = triangulation_match.triangulate_rays

        def solve_shadowed(R, p, pre, **kw):
            out = solve(R, p, pre, **kw)
            cpu = solve(*on("cpu", (R, p, pre)), **kw)
            fix = kw.get("fix_scale", False)
            seeds = [float(inertial._linear_init(*a, fix)[0]) for a in (
                (R, p, pre), on("cpu", (R, p, pre)),
                (R.cpu().double(), p.cpu().double(),
                 pre.map(lambda a: a.cpu().double())))]
            rec["init_shadow"].append(dict(
                frame=frame_no[0], scale=float(out["scale"]),
                scale_rel=abs(float(out["scale"]) / float(cpu["scale"]) - 1),
                bias=float((out["bias"].cpu() - cpu["bias"]).abs().max()),
                seed_card_cpu_f64=seeds))
            return out

        def tri_shadowed(*args):
            X = tri(*args)
            if frame_no[0] < SHADOW_FRAMES:
                X32 = host(tri(*on("cpu", args)))
                X64 = host(tri(*(a.cpu().double() for a in args)))
                near = (np.isfinite(X64).all(-1) & np.isfinite(X32).all(-1)
                        & (np.abs(X64).max(-1) < 40.0))
                rec["tri_shadow"].append(dict(
                    frame=frame_no[0], n=int(near.sum()),
                    card_cpu=float(np.abs(host(X) - X32)[near].max()),
                    f32_f64=float(np.abs(X32 - X64)[near].max())))
            return X

        monkeypatch.setattr(inertial_tracking, "inertial_only_optimization",
                            solve_shadowed)
        monkeypatch.setattr(triangulation_match, "triangulate_rays",
                            tri_shadowed)
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    slam = SlamSystem(SystemConfig(
        sensor="mono-inertial", imu_init_times=TIMES_PHASE14,
        tracker=TrackerConfig(fps=10, device="cuda"), device="cuda"))
    tr = slam.tracker
    run_init = tr._run_imu_init

    def recording_init(chain, rows, priors, frame, force=False):
        ok = run_init(chain, rows, priors, frame, force)
        rec["attempts"].append((frame_no[0], bool(ok),
                                round(float(tr.stats["imu_init_last_s"]), 4),
                                round(float(np.median(
                                    tr.stats["imu_init_edge_norms"])), 1)))
        return ok

    tr._run_imu_init = recording_init
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        for i, f in enumerate(frames):
            frame_no[0] = i
            fr = slam.track_monocular(*f, traj["timestamps"][i],
                                      imu=traj["imu"][i])
            rec["centres"].append(
                -fr.R_cw.T @ fr.t_cw if fr.R_cw is not None
                else np.full(3, np.nan))
            rec["bound"].append(int((fr.kp_lm >= 0).sum()))
    finally:
        torch.use_deterministic_algorithms(was)
    rec.update(stage=tr.imu_stage, scale=tr.stats.get("imu_init_scale"),
               gyro_err=float(np.abs(tr.bias[:3] - traj["bias"][:3]).max()))
    return rec


@pytest.mark.slow
def test_mono_inertial_card_record(dev, monkeypatch):
    """Phase 14's session three times on the card: once with torch's
    deterministic algorithms and every inertial-only solve and early
    triangulation shadowed on the CPU, twice with the default kernels.
    The two default sessions agree bit for bit (camera centres, bound
    keypoints, init attempts, gyro bias and scale): the solvers' sums run
    in a fixed order on the card (ops/segment.py).  Each session
    initializes its IMU and passes the phase's gyro-bias wall (3e-3); on
    the same inputs the card's init scale is within 1e-3 of the CPU's, and
    the default sessions' init scale within 1e-3 of the deterministic
    one's.  The RECORD line holds each session's init attempts, gyro-bias
    error and first-init scale, the shadows (the card's triangulation
    against the CPU's beside float32's own error against float64) and how
    the first default session's camera centres drift from the
    deterministic one's, frame by frame.  Run on a GPU machine with

        python -m pytest -q -s -m slow tests/test_torch_inertial_cuda.py
    """
    import json
    frames, traj = inertial_scenario(11, N_PHASE14, "mono-inertial")
    det = _phase14_session(frames, traj, True, True, monkeypatch)
    monkeypatch.undo()
    default = [_phase14_session(frames, traj, False, False, monkeypatch)
               for _ in range(2)]
    drift = np.abs(np.asarray(det["centres"])
                   - np.asarray(default[0]["centres"])).max(-1)

    def summary(r):
        return dict(gyro_err=r["gyro_err"], scale=r["scale"],
                    stage=r["stage"], attempts=r["attempts"],
                    median_bound_after_35=float(np.median(r["bound"][35:])))

    a, b = default
    same = {k: np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
            for k in ("centres", "bound", "attempts", "gyro_err", "scale",
                      "stage")}
    print("RECORD", json.dumps(dict(
        deterministic=dict(summary(det), init_shadow=det["init_shadow"],
                           tri_shadow=det["tri_shadow"]),
        default=[summary(r) for r in default], default_identical=same,
        centre_drift=[None if not np.isfinite(d) else float(d)
                      for d in drift])))
    assert all(same.values()), same
    for r in (det, *default):
        assert r["stage"] >= 1 and r["gyro_err"] < 3e-3, summary(r)
    assert det["init_shadow"] and max(
        s["scale_rel"] for s in det["init_shadow"]) < 1e-3
    assert abs(a["scale"] / det["scale"] - 1) < 1e-3, (a["scale"],
                                                       det["scale"])
