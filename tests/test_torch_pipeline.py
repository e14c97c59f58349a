"""The torch port's main path against the JAX reference package.

One module-scoped JAX run of ``test_mono_slam_smoke``'s scenario (loop
closing off, seed 1, 18 frames at 752x480) provides: the tracker state just
before frame K (carried into the port with ``tracker_state_from_numpy``),
the reference's fused-frame result at frame K, the RANSAC key chain, and
the reference trajectory.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.cameras import twoview as jtwoview
from orb_slam3_study_kr_tpu.evaluation import align_horn, ate_rmse
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM

torch.set_num_threads(2)

N_FRAMES = 18
K_FRAME = 12          # frame whose fused slice is compared (state carried)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames():
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(N_FRAMES, x_span=0.5, z_span=0.0,
                                              y_amp=0.0)
    imgs = [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            for i in range(N_FRAMES)]
    return imgs, R_gt, t_gt


def _capture(slam):
    """Numpy snapshot of the reference tracker's state."""
    tr = slam.tracker
    m = tr.map
    tables = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in vars(m).items()
              if isinstance(v, (np.ndarray, int, float, bool))}
    lf = tr.last_frame
    last = {k: np.array(getattr(lf, k)) for k in
            ("uv", "uv_raw", "level", "angle", "response", "desc", "valid",
             "patch")}
    last.update(kp_lm=lf.kp_lm.copy(), R_cw=np.array(lf.R_cw),
                t_cw=np.array(lf.t_cw), frame_id=lf.frame_id,
                timestamp=lf.timestamp, ref_kf=lf.ref_kf, pose_ok=lf.pose_ok,
                rel_ref=lf.rel_ref, rel_R=np.array(lf.rel_R),
                rel_t=np.array(lf.rel_t))
    blk = None
    if getattr(tr, "_fblk", None) is not None:
        blk = {k: (np.array(v) if not isinstance(v, (int, type(m))) else v)
               for k, v in tr._fblk.items() if k != "map_ref"}
    return dict(map_tables=tables, last_frame=last,
                velocity=tuple(np.array(a) for a in tr.velocity),
                ref_kf=tr.ref_kf, speed_hist=list(tr._speed_hist),
                state=tr.state.name, frame_count=tr.frame_count,
                last_kf_frame_id=tr.last_kf_frame_id, fused_block=blk,
                last_change_idx=getattr(tr, "_last_change_idx", -1))


@pytest.fixture(scope="module")
def reference():
    imgs, R_gt, t_gt = _frames()
    slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10),
                                     enable_loop_closing=False))
    tr = slam.tracker
    fused = {}
    orig = tr._track_fused_frame

    def recording(frame, R_pred=None, t_pred=None):
        n = orig(frame, R_pred=R_pred, t_pred=t_pred)
        if frame.frame_id == K_FRAME and "n" not in fused:
            fused.update(n=n, R=np.array(frame.R_cw), t=np.array(frame.t_cw),
                         kp_lm=frame.kp_lm.copy())
        return n

    tr._track_fused_frame = recording
    state = None
    for i in range(N_FRAMES):
        if i == K_FRAME:
            state = _capture(slam)
        slam.track_monocular(imgs[i], i * 0.1)
    rows = slam.trajectory()
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(N_FRAMES) * 0.1,
                           centers, True)
    return dict(imgs=imgs, centers=centers, state=state, fused=fused,
                rows=rows, rmse=rmse, nm=nm, n_kf=slam.stats()["n_kf"],
                jax_state=slam.state)


def _port_system(**kw):
    return SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   enable_loop_closing=False, device="cpu"),
                      **kw)


def test_fused_track_frame_from_carried_state(reference):
    """One fused-frame slice from the reference's state: pose within 1e-4
    (translation in map units, rotation matrix entries), inlier count
    within 1 % and >= 99 % of keypoint bindings identical.  The frame's
    features come from the port's own extraction, whose pyramid differs
    from the reference's by float32 ulps (tests/test_torch_orb.py), so a
    borderline match may differ; measured on CPU: identical inliers and
    bindings, pose within 3e-8."""
    ref = reference
    assert ref["fused"]["n"] is not None and ref["fused"]["n"] > 25
    slam = _port_system()
    tr = slam.tracker
    convert.tracker_state_from_numpy(tr, **ref["state"])
    frame = tr._extract_frame(ref["imgs"][K_FRAME], K_FRAME * 0.1)
    assert frame.frame_id == K_FRAME
    tr._update_last_frame()
    n = tr._track_fused_frame(frame)
    jf = ref["fused"]
    assert n is not None
    assert abs(n - jf["n"]) <= 0.01 * jf["n"]
    np.testing.assert_allclose(frame.R_cw, jf["R"], atol=1e-4)
    np.testing.assert_allclose(frame.t_cw, jf["t"], atol=1e-4)
    both = (frame.kp_lm != NO_LM) | (jf["kp_lm"] != NO_LM)
    assert (frame.kp_lm[both] == jf["kp_lm"][both]).mean() >= 0.99


def _flat(x):
    """The tensors of a nested output (a mono frame's ur slot is None)."""
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [] if x is None else [x]


def test_fused_frame_packs_descriptors_once(reference, monkeypatch):
    """Within one fused frame the frame's descriptors are packed once and
    the landmark block arrives packed (cached with the block), so every K2
    call gets int32 words on both sides and the CUDA wrapper packs nothing.
    The same fused_track_frame call with the block's descriptors as bits
    gives identical outputs."""
    from orb_slam3_study_kr_tpu_torch.ops import cuda_matching, track_match
    from orb_slam3_study_kr_tpu_torch.pipeline import tracking

    slam = _port_system()
    tr = slam.tracker
    convert.tracker_state_from_numpy(tr, **reference["state"])
    frame = tr._extract_frame(reference["imgs"][K_FRAME], K_FRAME * 0.1)
    tr._update_last_frame()
    packs, k2, calls = [], [], []
    pack, gnn, ftf = (cuda_matching.pack_desc, track_match.gated_nn,
                      tracking.fused_track_frame)

    def counting_pack(d):
        packs.append(tuple(d.shape))
        return pack(d)

    def recording_gnn(q_desc, *a, **kw):
        k2.append((q_desc.dtype, q_desc.shape[-1], a[3].dtype, a[3].shape[-1]))
        return gnn(q_desc, *a, **kw)

    def recording_ftf(*a, **kw):
        calls.append((a, kw))
        return ftf(*a, **kw)

    monkeypatch.setattr(cuda_matching, "pack_desc", counting_pack)
    monkeypatch.setattr(track_match, "gated_nn", recording_gnn)
    monkeypatch.setattr(tracking, "fused_track_frame", recording_ftf)
    assert tr._track_fused_frame(frame) is not None and len(calls) == 1
    assert packs == [(tr.cfg.orb_config.total_slots, 256)], packs
    assert len(k2) >= 4
    assert set(k2) == {(torch.int32, 8, torch.int32, 8)}, k2
    args, kw = calls[0]
    assert args[6].dtype == torch.int32 and args[6].shape[-1] == 8
    bits = list(args)
    bits[6] = cuda_matching.unpack_desc(args[6])
    for x, y in zip(_flat(ftf(*args, **kw)), _flat(ftf(*bits, **kw))):
        assert torch.equal(x, y)


class _JaxKeyChain:
    """The reference tracker's RANSAC draws: PRNGKey(seed), one split per
    reconstruction attempt, then one split into (homography, fundamental)
    keys inside reconstruct_two_views."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, mask, iters):
        self.key, sub = jax.random.split(self.key)
        kh, kf = jax.random.split(sub)
        m = jnp.asarray(mask)
        return tuple(np.asarray(jtwoview._sample_minimal_sets(k, m, iters))
                     for k in (kh, kf))


def test_mono_slam_smoke_session_matches_reference(reference):
    """test_mono_slam_smoke's walls on the port (state OK, nm > 10, ATE <
    0.05), n_kf within 1 of the reference run, and — with the reference's
    RANSAC draws injected — camera centres within 1e-3 (ground-truth
    metres, trajectory span 0.5) of the reference's, frame by frame, after
    each is sim3-aligned to the ground truth (measured on CPU: 2.5e-5)."""
    ref = reference
    slam = _port_system(ransac_sets_fn=_JaxKeyChain(0))
    for i, img in enumerate(ref["imgs"]):
        slam.track_monocular(img, i * 0.1)
    rows = slam.trajectory()
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4],
                           np.arange(N_FRAMES) * 0.1, ref["centers"], True)
    stats = slam.stats()
    assert slam.state == TrackState.OK, stats
    assert nm > 10
    assert rmse < 0.05, rmse
    assert abs(stats["n_kf"] - ref["n_kf"]) <= 1, (stats["n_kf"], ref["n_kf"])

    def aligned(r):
        idx = np.rint(r[:, 0] / 0.1).astype(int)
        gt = ref["centers"][idx]
        R, t, s = align_horn(r[:, 1:4].T, gt.T, True)
        return dict(zip(idx, (s * R @ r[:, 1:4].T + t).T))

    a, b = aligned(rows), aligned(ref["rows"])
    common = sorted(set(a) & set(b))
    assert len(common) >= 10
    err = max(np.linalg.norm(a[i] - b[i]) for i in common)
    assert err < 1e-3, err


def _run_port(render, R_gt, t_gt, enable_loop_closing=False):
    n = R_gt.shape[0]
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   enable_loop_closing=enable_loop_closing,
                                   device="cpu"))
    for i in range(n):
        slam.track_monocular(render(i), i * 0.1)
    rows = slam.trajectory()
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1,
                           centers, True)
    return slam, rows, rmse, nm


@pytest.mark.slow
def test_mono_slam_textured_lateral_port(tmp_path):
    """The reference's slow-tier lateral walls (tests/test_pipeline.py) on
    the port, loop closing off: OK, n_kf >= 3, nm > 25, ATE < 0.06, and a
    TUM trajectory file with one 8-column row per frame."""
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(40, x_span=1.0, z_span=0.0,
                                              y_amp=0.0)
    slam, rows, rmse, nm = _run_port(
        lambda i: synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng),
        R_gt, t_gt)
    stats = slam.stats()
    assert slam.state == TrackState.OK, stats
    assert stats["n_kf"] >= 3, stats
    assert nm > 25
    assert rmse < 0.06, rmse
    path = tmp_path / "traj.txt"
    slam.save_trajectory_tum(path)
    lines = path.read_text().strip().splitlines()
    assert len(lines) == rows.shape[0]
    assert len(lines[0].split()) == 8


@pytest.mark.slow
def test_mono_slam_blob_orbit_robustness_port():
    """The reference's blob-field orbit walls on the port, with loop closing
    on as the reference runs it (tests/test_pipeline.py).  Never LOST,
    n_kf >= 2, nm >= 15, ATE < 0.25."""
    rng = np.random.default_rng(5)
    scene = synthetic.make_scene(rng, n_points=700)
    R_gt, t_gt = synthetic.circular_trajectory(30, radius=1.2, span=0.35)
    slam, _, rmse, nm = _run_port(
        lambda i: synthetic.render(scene, R_gt[i], t_gt[i], rng=rng)[0],
        R_gt, t_gt, enable_loop_closing=True)
    stats = slam.stats()
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST), stats
    assert stats["n_kf"] >= 2
    assert nm >= 15
    assert rmse < 0.25, rmse


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline\n"
            "import orb_slam3_study_kr_tpu_torch.convert\n"
            "import orb_slam3_study_kr_tpu_torch.ops.cuda_lib\n"
            "import orb_slam3_study_kr_tpu_torch.ops.cuda_hamming\n"
            "import orb_slam3_study_kr_tpu_torch.bow\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.loop_closing\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.global_ba\n"
            "import orb_slam3_study_kr_tpu_torch.solvers.pnp\n"
            "import orb_slam3_study_kr_tpu_torch.solvers.sim3_solver\n"
            "import orb_slam3_study_kr_tpu_torch.solvers.pose_graph\n"
            "import orb_slam3_study_kr_tpu_torch.ops.stereo\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.stereo_tracking\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.async_mapping\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.map_merging\n"
            "import orb_slam3_study_kr_tpu_torch.io.rectify\n"
            "import orb_slam3_study_kr_tpu_torch.io.synthetic\n"
            "import orb_slam3_study_kr_tpu_torch.imu\n"
            "import orb_slam3_study_kr_tpu_torch.solvers.inertial\n"
            "import orb_slam3_study_kr_tpu_torch.solvers.inertial_ba\n"
            "import orb_slam3_study_kr_tpu_torch.pipeline.inertial_tracking\n"
            "import orb_slam3_study_kr_tpu_torch.cameras.kb8\n"
            "import orb_slam3_study_kr_tpu_torch.cameras.camera\n"
            "import orb_slam3_study_kr_tpu_torch.ops.fisheye_stereo\n"
            "import orb_slam3_study_kr_tpu_torch.io.png\n"
            "import orb_slam3_study_kr_tpu_torch.io.settings\n"
            "import orb_slam3_study_kr_tpu_torch.io.datasets\n"
            "import orb_slam3_study_kr_tpu_torch.parity\n"
            "import orb_slam3_study_kr_tpu_torch.viz\n"
            "import orb_slam3_study_kr_tpu_torch.examples.run_euroc\n"
            "import orb_slam3_study_kr_tpu_torch.examples.run_kitti\n"
            "import orb_slam3_study_kr_tpu_torch.examples.run_synthetic\n"
            "import orb_slam3_study_kr_tpu_torch.examples.ros_node\n"
            "import orb_slam3_study_kr_tpu_torch.parallel\n"
            "import orb_slam3_study_kr_tpu_torch.parallel.dist_ba\n"
            "import orb_slam3_study_kr_tpu_torch.parallel.multihost\n"
            "import orb_slam3_study_kr_tpu_torch.parallel.multihost_worker\n"
            "import orb_slam3_study_kr_tpu_torch.parallel.bench_scaling\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('orb_slam3_study_kr_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_device_without_cuda_raises():
    """device="cuda" (the default) raises instead of running on the CPU."""
    assert SystemConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(SystemConfig(enable_loop_closing=False, device="cuda"))


@pytest.mark.parametrize("kw", [
    dict(enable_loop_closing=True, ba_devices=2),
    dict(sensor="stereo-inertial",
         tracker=TrackerConfig(camera_model="kb8", ambig_obs_weight=0.5)),
    dict(sensor="rgbd-inertial", tracker=TrackerConfig(patch_zncc_min=0.5)),
    dict(sensor="stereo",
         tracker=TrackerConfig(camera_model="kb8", refkf_anchor=True)),
    dict(sensor="mono-inertial", tracker=TrackerConfig(klt_refine=False)),
    dict(tracker=TrackerConfig(camera_model="kb8", klt_refine=False)),
], ids=["loop_closing", "stereo_inertial", "rgbd_inertial", "kb8_stereo",
        "mono_inertial", "kb8"])
def test_reference_routes_build(kw):
    """The routes that raised before they were ported build a session: the
    multi-device global BA (item 19, two CPU shards here) and the tracker
    knobs of item 12a (KLT off, refkf_anchor, patch ZNCC,
    ambiguous-observation weights), with a fisheye or an inertial sensor as
    without; the session keeps each knob."""
    cfg = dict(enable_loop_closing=False, device="cpu")
    cfg.update(kw)
    slam = SlamSystem(SystemConfig(**cfg))
    if "tracker" in kw:
        assert slam.tracker.cfg == dataclasses.replace(kw["tracker"],
                                                       bf=slam.cfg.tracker.bf,
                                                       device="cpu")
    else:
        assert slam.ba_mesh.size == 2


def test_no_unported_route_left():
    """No NotImplementedError naming a ROADMAP item is left in the port."""
    pkg = os.path.join(REPO, "orb_slam3_study_kr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert not ("NotImplementedError" in text
                            and "ROADMAP" in text), name


def test_default_config_runs_and_merge_raises():
    """SystemConfig() (loop closing on) builds on the CPU; with one map
    there is nothing to merge, and once the map is stored on a loss and a
    second map recognises it (tests/test_map_merging.py's two gauges of
    one scene), _try_merge welds the active map into the stored one
    instead of raising: one map left, the stored one active, the session
    rebound to it and its welding BA run."""
    from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase, train_vocabulary
    from test_map_merging import _build_pair
    from test_torch_atlas import _install

    slam = SlamSystem(SystemConfig(device="cpu"))
    assert slam.cfg.enable_loop_closing and slam.loop_closer is None
    _, jA, jB, *_ = _build_pair(np.random.default_rng(0))
    m0 = slam.atlas.active_map
    _install(m0, jB)
    kfs = np.nonzero(m0.kf_valid)[0]
    slam.voc = train_vocabulary(m0.kf_desc[kfs][m0.kf_kp_valid[kfs]], k=4, L=2,
                                device="cpu")
    slam.db = KeyframeDatabase(slam.voc)
    slam.map_dbs[m0.map_id] = slam.db
    for kf in kfs:
        slam.db.add(int(kf), m0.kf_desc[kf], m0.kf_kp_valid[kf])
    assert not slam._try_merge(0)           # one map: nothing to merge
    slam.cfg.min_kf_spawn = 1               # store the map on loss
    slam._on_tracking_lost()
    assert len(slam.atlas.maps) == 2 and slam.loop_closer is not None
    m1 = slam.atlas.active_map
    assert m1 is not m0
    _install(m1, jA)
    slam.tracker.ref_kf = 0
    assert slam._try_merge(0)
    assert slam.atlas.maps == [m0] and slam.atlas.active_map is m0
    assert slam.tracker.map is m0 and slam.local_mapper.map is m0
    assert slam.loop_closer.map is m0 and slam.map_dbs == {m0.map_id: slam.db}
    assert slam.merger.stats == {"n_attempts": 1, "n_verified": 1, "n_merged": 1}
    assert slam.local_mapper.stats["n_welding_ba"] == 1
    assert m0.n_kf == 6 and len(slam.db.vectors) == 6


def test_config_conversion_from_reference_fields():
    jt = JTrackerConfig(fps=10, n_features=800, dist=(0.1, 0.0, 0.0, 0.0, 0.0))
    tt = convert.tracker_config_from_dict(dataclasses.asdict(jt))
    for f in dataclasses.fields(TrackerConfig):
        if f.name != "device":
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    js = JSystemConfig(tracker=jt, enable_loop_closing=False, max_lm=5000)
    ts = convert.system_config_from_dict(dataclasses.asdict(js), device="cpu")
    assert ts.max_lm == 5000 and not ts.enable_loop_closing
    assert ts.tracker.n_features == 800 and ts.device == "cpu"
    js = JSystemConfig(sensor="stereo", baseline=0.2, depth_factor=35.0,
                       async_mapping=True, async_max_pending=2)
    ts = convert.system_config_from_dict(dataclasses.asdict(js), device="cpu")
    assert (ts.sensor, ts.baseline, ts.depth_factor) == ("stereo", 0.2, 35.0)
    assert ts.async_mapping and ts.async_max_pending == 2


def test_config_conversion_fisheye_rig():
    """The TUM-VI stereo-inertial rig converts: the left and right KB8
    trackers, stereo_R_rl / stereo_t_rl as tuples; the session it builds on
    the CPU is the fisheye stereo-inertial tracker with that extrinsic, the
    right lens on the session's device and bf kept at 0; a carried last
    frame keeps its stereo points."""
    kb8 = dict(width=512, height=512, fx=190.978, fy=190.973, cx=254.932,
               cy=256.897, dist=(0.0035, 0.0007, -0.002, 0.0002),
               camera_model="kb8")
    R_rl = np.eye(3, dtype=np.float32)
    js = JSystemConfig(sensor="stereo-inertial", tracker=JTrackerConfig(**kb8),
                       tracker_right=JTrackerConfig(**dict(kb8, fx=191.5)),
                       stereo_R_rl=R_rl, stereo_t_rl=(-0.1, 0.0, 0.0))
    ts = convert.system_config_from_dict(dataclasses.asdict(js), device="cpu")
    assert ts.stereo_t_rl == (-0.1, 0.0, 0.0)
    assert ts.stereo_R_rl == tuple(tuple(r) for r in R_rl.tolist())
    assert ts.tracker.camera_model == ts.tracker_right.camera_model == "kb8"
    assert ts.tracker_right.fx == 191.5
    ts.enable_loop_closing = False
    tr = SlamSystem(ts).tracker
    assert type(tr).__name__ == "FisheyeStereoInertialTracker"
    assert tr.cfg.bf == 0.0 and tr.cfg_right.fx == 191.5
    assert tr.cfg_right.cam_params.device.type == "cpu"
    np.testing.assert_allclose(tr.t_rl, [-0.1, 0.0, 0.0])
    assert abs(tr.baseline - 0.1) < 1e-7
    pc = np.arange(12, dtype=np.float32).reshape(4, 3)
    convert.tracker_state_from_numpy(
        tr, {}, dict(frame_id=3, timestamp=0.3, kp_lm=np.full(4, -1),
                     R_cw=np.eye(3), t_cw=np.zeros(3), stereo_pc=pc),
        None, -1, [])
    np.testing.assert_array_equal(tr.last_frame.stereo_pc, pc)


def test_config_conversion_reference_only_fields():
    """The table of reference fields the port lacks holds the reference's
    own defaults and, with the port's fields, covers every reference field.
    Such a field converts at its default and raises with any other value,
    as does a key neither config has.  The IMU settings and the fisheye
    lens limits are port fields and convert at any value."""
    for jcls, tcls in ((JTrackerConfig, TrackerConfig),
                       (JSystemConfig, SystemConfig)):
        table = convert.REFERENCE_ONLY[tcls.__name__]
        port = {f.name for f in dataclasses.fields(tcls)}
        ref = {f.name: getattr(jcls(), f.name) for f in dataclasses.fields(jcls)}
        assert set(ref) - port == set(table), tcls.__name__
        for k, v in table.items():
            assert v == ref[k], k
    ts = convert.system_config_from_dict(dataclasses.asdict(JSystemConfig(
        sensor="mono-inertial", imu_freq=100.0, imu_init_times=(1.0, 2.0, 3.0))),
        device="cpu")
    assert (ts.sensor, ts.imu_freq, ts.imu_init_times) == (
        "mono-inertial", 100.0, (1.0, 2.0, 3.0))
    tt = convert.tracker_config_from_dict(dataclasses.asdict(JTrackerConfig(
        camera_model="kb8", fov_max_deg=60.0, fisheye_half_fov_deg=95.0)))
    assert (tt.camera_model, tt.fov_max_deg, tt.fisheye_half_fov_deg) == (
        "kb8", 60.0, 95.0)
    with pytest.raises(ValueError, match="no_such_field"):
        convert.tracker_config_from_dict({"fps": 10, "no_such_field": 1})
