"""The port's drivers, trajectory writers, ROS message core and viewers
against the JAX reference, on the CPU.

- ``run_euroc.build_system`` of both packages from the same YAML gives
  equal ``SystemConfig``s for mono, stereo (a rectified legacy rig and the
  TUM-VI KB8 rig), the raw distorted rig (rectifier maps: integer parts
  exact, fractions within 1e-5) and stereo-inertial.  The reference's
  inertial branch raises (it reads ``ImuCalib.freq``, which its ImuCalib
  does not have, and would pass the per-sample noise where the per-sqrt(Hz)
  density belongs); the port's config equals the reference's stereo config
  with the YAML's IMU block, ``imu_R_bc`` within 1e-9 of the reference's
  ``R_bc @ R_rect_l.T``.
- The writers, fed the same ``trajectory()`` rows and keyframe tables: TUM
  and EuRoC files byte for byte; the keyframe TUM file and KITTI within
  1e-6 (their poses pass through float32 arithmetic in both packages).
- ``final_trajectory(with_map_ids=True)`` on a log that spans two maps: the
  reference's (rows, map_ids) pair.
- ``upload_image``'s dtype rule is the reference's.
- 3-frame CLI smokes of run_euroc, run_kitti and run_synthetic (with
  ``--viz``) with ``--device cpu``.
- The ROS core's decoders and IMU windows equal the reference's on fake
  messages; ``FrameDrawer`` overlays equal the reference's bit for bit;
  ``MapDrawer.save`` writes a PNG.
- ``run_sequence`` on chip_smoke.py phase 19a's files feeds each frame
  the written images and the generator's IMU rows.
- Under ``-m slow``: tests/test_run_euroc.py's two-sequence session and
  parity-mode run through the port, and chip_smoke.py phase 19 rehearsed
  on the CPU with its walls (19a beside the same session fed in line).
"""

import argparse
import dataclasses
import importlib.util
import io
import os
import types

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.io.settings import Settings as JSettings
from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.frame import Frame as JFrame
from orb_slam3_study_kr_tpu.pipeline.tracking import MonoTracker as JMonoTracker
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackState as JTrackState
from orb_slam3_study_kr_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_study_kr_tpu.viz import FrameDrawer as JFrameDrawer
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.examples import (ros_node, run_euroc,
                                                   run_kitti, run_synthetic)
from orb_slam3_study_kr_tpu_torch.io import png, synthetic
from orb_slam3_study_kr_tpu_torch.io.datasets import load_euroc
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackerConfig,
                                                            TrackState)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
from orb_slam3_study_kr_tpu_torch.viz import FrameDrawer, MapDrawer
from test_torch_io import write_kitti, write_yaml

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrun_euroc = _reference_example("run_euroc")
jros = _reference_example("ros_node")


@pytest.fixture(scope="module")
def frames():
    """Three rendered 752x480 frames of a short lateral move, as uint8."""
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R, t = synthetic.lateral_trajectory(3, x_span=0.2, z_span=0.0)
    return [np.clip(synthetic.render_textured(world, R[i], t[i], rng=rng),
                    0, 255).astype(np.uint8) for i in range(3)]


# ---------------------------------------------------------------------------
# build_system


def _args(settings, sensor, **kw):
    return argparse.Namespace(settings=settings, sensor=sensor,
                              vocabulary=None, **kw)


def _as_port_config(jcfg):
    """The reference's SystemConfig in the port's terms, on the CPU."""
    cfg = convert.system_config_from_dict(dataclasses.asdict(jcfg),
                                          device="cpu")
    cfg.tracker = dataclasses.replace(cfg.tracker, device="cpu")
    if cfg.tracker_right is not None:
        cfg.tracker_right = dataclasses.replace(cfg.tracker_right, device="cpu")
    return cfg


@pytest.mark.parametrize("yaml_name,sensor", [
    (None, "mono"), ("raw_stereo", "mono"), ("legacy", "stereo"),
    ("tumvi_kb8", "stereo"), ("raw_stereo", "stereo")])
def test_build_system_matches_reference(yaml_name, sensor, tmp_path):
    path = write_yaml(tmp_path, yaml_name) if yaml_name else None
    j = jrun_euroc.build_system(_args(path, sensor))
    t = run_euroc.build_system(_args(path, sensor, device="cpu"))
    assert t.device.type == "cpu"
    assert t.cfg == _as_port_config(j.cfg)
    assert (t.rectifier is None) == (j.rectifier is None)
    if j.rectifier is not None:
        for side in ("left", "right"):
            a, b = getattr(t.rectifier, side), getattr(j.rectifier, side)
            np.testing.assert_array_equal(a.x0, b.x0)
            np.testing.assert_array_equal(a.y0, b.y0)
            np.testing.assert_allclose(a.wx, b.wx, atol=1e-5)
            np.testing.assert_allclose(a.wy, b.wy, atol=1e-5)
        np.testing.assert_array_equal(t.rectifier.R_rect_l, j.rectifier.R_rect_l)


IMU_FIELDS = ("imu_noise_gyro", "imu_noise_acc", "imu_walk_gyro",
              "imu_walk_acc", "imu_freq", "imu_R_bc", "imu_t_bc")


@pytest.mark.parametrize("yaml_name", ["raw_stereo_imu", "tumvi_kb8", "legacy"])
def test_build_system_stereo_inertial(yaml_name, tmp_path):
    """The reference's inertial branch raises on ImuCalib.freq; the port's
    config is the reference's stereo config plus the file's IMU block, with
    the rectifying rotation folded into R_bc for the raw rig."""
    path = write_yaml(tmp_path, yaml_name)
    with pytest.raises(AttributeError, match="freq"):
        jrun_euroc.build_system(_args(path, "stereo-inertial"))
    j = jrun_euroc.build_system(_args(path, "stereo"))
    t = run_euroc.build_system(_args(path, "stereo-inertial", device="cpu"))
    ref = _as_port_config(j.cfg)
    assert dataclasses.replace(
        t.cfg, sensor="stereo", **{f: getattr(ref, f) for f in IMU_FIELDS}) == ref

    st = JSettings(path)
    calib = st.imu_calib()
    R_bc = np.asarray(calib.R_bc, np.float64)
    if j.rectifier is not None:
        R_bc = R_bc @ j.rectifier.R_rect_l.T
    np.testing.assert_allclose(np.asarray(t.cfg.imu_R_bc), R_bc, rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(t.cfg.imu_t_bc),
                                  np.asarray(calib.t_bc, np.float64))
    keys = ("IMU.NoiseGyro", "IMU.NoiseAcc", "IMU.GyroWalk", "IMU.AccWalk",
            "IMU.Frequency")
    assert [getattr(t.cfg, f) for f in IMU_FIELDS[:5]] == \
        [float(st.get(k)) for k in keys]
    # The session's ImuCalib scales the densities to per-sample once.
    sf = float(st.get("IMU.Frequency")) ** 0.5
    np.testing.assert_allclose(float(t.tracker.calib.noise_gyro),
                               float(st.get("IMU.NoiseGyro")) * sf, rtol=1e-6)


def test_build_system_refuses_a_missing_block(tmp_path):
    path = write_yaml(tmp_path, "raw_stereo")
    with pytest.raises(SystemExit, match="no IMU block"):
        run_euroc.build_system(_args(path, "stereo-inertial", device="cpu"))
    mono = tmp_path / "mono.yaml"
    mono.write_text("%YAML:1.0\nCamera.fx: 400.0\nCamera.fy: 400.0\n"
                    "Camera.cx: 376.0\nCamera.cy: 240.0\n")
    with pytest.raises(SystemExit, match="no stereo calibration"):
        run_euroc.build_system(_args(str(mono), "stereo", device="cpu"))


# ---------------------------------------------------------------------------
# Trajectory writers


def _fill(slam, rows, kf_poses):
    slam.trajectory = lambda with_map_ids=False: rows
    m = slam.atlas.active_map
    n = m.kf_kp_uv.shape[1]
    for i, (R, t, ts) in enumerate(kf_poses):
        m.add_keyframe(R, t, np.zeros((n, 2), np.float32),
                       np.zeros(n, np.int32), np.zeros(n, np.float32),
                       np.zeros(n, bool), np.zeros((n, 256), np.uint8), i, ts)


def test_trajectory_writers_match_reference(tmp_path):
    rng = np.random.default_rng(11)
    n = 25
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.sign(q[:, :1])
    rows = np.concatenate([(1403636579.7635556 + 0.05 * np.arange(n))[:, None],
                           rng.normal(0, 2, (n, 3)), q], axis=1)
    kf_poses = []
    for i in rng.permutation(6):      # keyframes out of timestamp order
        w = rng.normal(0, 1.0, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        kf_poses.append((R.astype(np.float32),
                         rng.normal(0, 1, 3).astype(np.float32), 10.0 + 0.3 * i))
    j = JSlamSystem(JSystemConfig())
    t = SlamSystem(SystemConfig(device="cpu"))
    _fill(j, rows, kf_poses)
    _fill(t, rows, kf_poses)
    for name in ("save_trajectory_tum", "save_trajectory_euroc",
                 "save_keyframe_trajectory_tum", "save_trajectory_kitti"):
        a, b = tmp_path / f"{name}_port.txt", tmp_path / f"{name}_ref.txt"
        getattr(t, name)(str(a))
        getattr(j, name)(str(b))
        if name in ("save_trajectory_tum", "save_trajectory_euroc"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            # Float32 arithmetic in both packages (the keyframe file's
            # inverse pose and quaternion, KITTI's rotation), whose last
            # ulp may round the printed digit the other way.
            va, vb = np.loadtxt(a), np.loadtxt(b)
            assert va.shape == vb.shape == ((6, 8) if "keyframe" in name
                                            else (n, 12))
            np.testing.assert_allclose(va, vb, rtol=0, atol=1e-6)


def _two_map_log(MapStateCls, rng):
    """A trajectory log over two maps (ids 0 and 1, two keyframes each),
    with one row lost and one bound to a culled keyframe."""
    maps, log = [], []
    for mid in (0, 1):
        m = MapStateCls(max_kf=4, max_kp=8, max_lm=16, map_id=mid)
        for k in range(2):
            R = np.eye(3, dtype=np.float32)
            t = rng.normal(0, 1, 3).astype(np.float32)
            m.add_keyframe(R, t, np.zeros((8, 2), np.float32),
                           np.zeros(8, np.int32), np.zeros(8, np.float32),
                           np.ones(8, bool), np.zeros((8, 256), np.uint8),
                           k, 10.0 * mid + k)
        maps.append(m)
    for i in range(8):
        m = maps[i // 4]
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        Rrel = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        trel = np.array([0.01 * i, 0.0, 0.02], np.float32)
        log.append((10.0 * (i // 4) + 0.1 * i, i % 2, Rrel, trel, None,
                    i != 2, m))
    return log


def test_with_map_ids_matches_reference():
    """final_trajectory(with_map_ids=True): the rows and the owning map id
    per row, as the reference returns them (the pair run_euroc reads for
    its per-map ATE)."""
    jrows, jids = JMonoTracker.final_trajectory(
        types.SimpleNamespace(trajectory=_two_map_log(
            JMapState, np.random.default_rng(3))), with_map_ids=True)
    trows, tids = MonoTracker.final_trajectory(
        types.SimpleNamespace(trajectory=_two_map_log(
            MapState, np.random.default_rng(3))), with_map_ids=True)
    assert tids.dtype == jids.dtype == np.int64
    np.testing.assert_array_equal(tids, jids)
    assert list(tids) == [0, 0, 0, 1, 1, 1, 1]
    np.testing.assert_allclose(trows, jrows, rtol=0, atol=1e-6)


def test_upload_image_dtype_rule_as_reference():
    """uint8 stays uint8, any other dtype becomes float32 (the reference's
    rule); a tensor already on the session's device passes through."""
    j = JSlamSystem(JSystemConfig())
    t = SlamSystem(SystemConfig(device="cpu"))
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (6, 7), np.uint8),
                rng.uniform(0, 255, (6, 7)), rng.uniform(0, 255, (6, 7)).astype(
                    np.float32), rng.integers(0, 4000, (6, 7), np.uint16)):
        a, b = t.upload_image(img), j.upload_image(img)
        assert a.device.type == "cpu" and str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert t.upload_image(a) is a
    img = np.full((6, 7), 7, np.uint8)
    up = t.upload_image(img)
    img[0, 0] = 9                 # the upload is a copy, not a view
    assert int(up[0, 0]) == 7


# ---------------------------------------------------------------------------
# CLI smokes (--device cpu)


def test_run_euroc_cli_smoke(tmp_path, frames, capsys):
    root = tmp_path / "seq" / "mav0"
    os.makedirs(root / "cam0" / "data")
    with open(root / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i, img in enumerate(frames):
            ns = int(i * 1e8)
            png.write_png(root / "cam0" / "data" / f"{ns}.png", img)
            f.write(f"{ns},{ns}.png\n")
    out = tmp_path / "t.txt"
    rc = run_euroc.main([str(root), "--sensor", "mono", "--max-frames", "3",
                         "--out", str(out), "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert "tracked 3 frames" in capsys.readouterr().out
    assert len(load_euroc(str(root))) == 3


def test_run_kitti_cli_smoke(tmp_path, frames, capsys):
    write_kitti(tmp_path, frames, fx=458.654, stereo=False)
    out = tmp_path / "traj_kitti.txt"
    rc = run_kitti.main([str(tmp_path), "--sensor", "mono", "--out", str(out),
                         "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert capsys.readouterr().out.startswith("3 frames")
    for line in out.read_text().splitlines():
        row = np.asarray([float(x) for x in line.split()])
        assert row.size == 12
        R = row.reshape(3, 4)[:, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_run_synthetic_cli_smoke(tmp_path, capsys):
    out = tmp_path / "traj.txt"
    viz = tmp_path / "viz"
    rc = run_synthetic.main(["3", str(out), "--viz", str(viz), "--device",
                             "cpu"])
    assert rc == 0 and out.exists()
    text = capsys.readouterr().out
    assert "RMS ATE" in text and "stats:" in text and "track/extract" in text
    assert (viz / "frame_00000.png").exists()


def test_drivers_raise_without_a_card(tmp_path):
    """--device defaults to cuda: without a card the drivers raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_euroc.main([str(tmp_path), "--sensor", "mono"])
    write_kitti(tmp_path, [np.zeros((48, 64), np.uint8)], stereo=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_kitti.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_synthetic.main(["1", str(tmp_path / "t.txt")])


# ---------------------------------------------------------------------------
# ROS message core


class _Stamp:
    def __init__(self, t):
        self.secs = int(t)
        self.nsecs = int(round((t - int(t)) * 1e9))


class _ImageMsg:
    def __init__(self, img, encoding, pad=0, t=0.0, bigendian=0):
        img = np.asarray(img)
        self.height, self.width = img.shape[:2]
        self.encoding = encoding
        self.is_bigendian = bigendian
        ch = 1 if img.ndim == 2 else img.shape[2]
        self.step = (self.width * ch + pad) * img.dtype.itemsize
        self.data = b"".join(r.tobytes() + b"\0" * (self.step - r.nbytes)
                             for r in img)
        self.header = types.SimpleNamespace(stamp=_Stamp(t))


def _imu_msg(t, acc, gyro):
    v = lambda x: types.SimpleNamespace(x=x[0], y=x[1], z=x[2])  # noqa: E731
    return types.SimpleNamespace(header=types.SimpleNamespace(stamp=_Stamp(t)),
                                 linear_acceleration=v(acc),
                                 angular_velocity=v(gyro))


def test_ros_decoders_match_reference():
    rng = np.random.default_rng(5)
    g8 = rng.integers(0, 256, (7, 9), np.uint8)
    c8 = rng.integers(0, 256, (7, 9, 3), np.uint8)
    g16 = rng.integers(0, 65536, (7, 9), np.uint16)
    msgs = [_ImageMsg(g8, "mono8", pad=3), _ImageMsg(g8, "8UC1"),
            _ImageMsg(c8, "bgr8", pad=2), _ImageMsg(c8, "rgb8"),
            _ImageMsg(g16, "mono16", pad=1),
            _ImageMsg(g16.astype(">u2"), "16UC1", bigendian=1)]
    for msg in msgs:
        a, b = ros_node.decode_image(msg), jros.decode_image(msg)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ros_node.decode_image(msgs[-1]),
                                  g16.astype(np.float32))
    with pytest.raises(ValueError, match="bayer"):
        ros_node.decode_image(_ImageMsg(g8, "bayer_rggb8"))
    for t in (0.0, 3.25, 1403636579.763555):
        assert ros_node.stamp_to_sec(_Stamp(t)) == jros.stamp_to_sec(_Stamp(t))


class _FakeSlam:
    def __init__(self):
        self.calls = []

    def track_monocular(self, img, ts, imu=None):
        self.calls.append(("mono", ts, img, imu))

    def track_stereo(self, left, right, ts, imu=None):
        self.calls.append(("stereo", ts, left, imu))

    def track_rgbd(self, img, depth, ts, imu=None):
        self.calls.append(("rgbd", ts, depth, imu))


@pytest.mark.parametrize("sensor", ["mono-inertial", "stereo-inertial",
                                    "rgbd", "mono"])
def test_ros_node_windows_match_reference(sensor):
    """The same messages through both SlamNodes: the same calls, IMU windows
    [dt, acc, gyro] in (t_prev, t], queue left over, depth scaling."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (8, 8), np.uint8)
    depth = rng.integers(0, 5000, (8, 8), np.uint16)
    imu = [_imu_msg(0.01 * (k + 1), rng.normal(size=3), rng.normal(size=3))
           for k in range(35)]
    calls = []
    for mod in (ros_node, jros):
        slam = _FakeSlam()
        node = mod.SlamNode(slam, sensor, imu_freq=100.0)
        for msg in imu:
            node.on_imu(msg)
        for t in (0.1, 0.2, 0.25):
            msg = _ImageMsg(img, "mono8", t=t)
            if sensor.startswith("stereo"):
                node.on_stereo(msg, msg)
            elif sensor == "rgbd":
                node.on_rgbd(msg, _ImageMsg(depth, "mono16", t=t))
            else:
                node.on_image(msg)
        calls.append((slam.calls, node._imu, node.n_frames))
    (ca, qa, na), (cb, qb, nb) = calls
    assert na == nb == 3 and qa == qb
    for a, b in zip(ca, cb):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        if a[3] is None:
            assert b[3] is None
        else:
            np.testing.assert_array_equal(a[3], b[3])
    if sensor.endswith("-inertial"):
        assert [c[3].shape[0] for c in ca] == [1, 10, 5]


def test_ros_main_without_rospy(capsys):
    assert ros_node.main([]) == 2
    assert "rospy" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Viewers


@pytest.mark.parametrize("state", ["OK", "RECENTLY_LOST", "NOT_INITIALIZED"])
def test_frame_drawer_matches_reference(state):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    n = 60
    kw = dict(frame_id=0, timestamp=0.0,
              uv=rng.uniform(-4, 165, (n, 2)).astype(np.float32),
              level=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
              response=np.zeros(n, np.float32),
              desc=np.zeros((n, 256), np.uint8), valid=rng.random(n) > 0.2)
    jf, tf = JFrame(**kw), Frame(**kw, device="cpu")
    lm = np.where(rng.random(n) > 0.5, np.arange(n), -1).astype(np.int32)
    jf.kp_lm[:] = lm
    tf.kp_lm[:] = lm
    stats = {"n_maps": 2, "n_kf": 13, "n_lm": 1234}
    a = FrameDrawer().draw(img, tf, state=TrackState[state], stats=stats)
    b = JFrameDrawer().draw(img, jf, state=JTrackState[state], stats=stats)
    assert a.dtype == np.uint8 and a.shape == (134, 160, 3)
    np.testing.assert_array_equal(a, b)
    rgb = np.stack([img, 255 - img, img / 2], -1)
    np.testing.assert_array_equal(FrameDrawer().draw(rgb, tf),
                                  JFrameDrawer().draw(rgb, jf))


def test_map_drawer_saves_png(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    m = MapState(max_kf=8, max_kp=64, max_lm=256)
    uv = rng.uniform(10, 100, (64, 2)).astype(np.float32)
    desc = (rng.random((64, 256)) > 0.5).astype(np.uint8)
    for k in range(3):
        m.add_keyframe(np.eye(3, dtype=np.float32),
                       np.array([0.1 * k, 0, 0], np.float32), uv,
                       np.zeros(64, np.int32), np.zeros(64, np.float32),
                       np.ones(64, bool), desc, k, float(k))
    ids = m.add_landmarks(
        rng.uniform(-1, 1, (32, 3)).astype(np.float32) + [0, 0, 3], desc[:32], 0)
    for k in (0, 1):
        m.bind(k, np.arange(32, dtype=np.int32), ids)
    path = tmp_path / "map.png"
    MapDrawer(m).save(str(path), current_pose=(np.eye(3, dtype=np.float32),
                                               np.zeros(3, np.float32)),
                      trajectory=np.zeros((5, 3), np.float32))
    img = png.read_png(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[0] > 100


# ---------------------------------------------------------------------------
# tests/test_run_euroc.py's sessions through the port (-m slow)


def _write_sequence(root, world, R_gt, t_gt, ts0, rng):
    """A mono mav0 folder at 10 Hz from ts0 seconds (test_run_euroc.py's)."""
    n = R_gt.shape[0]
    frames = [(synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng),)
              for i in range(n)]
    _chip_smoke()._write_mav0(str(root), [int((ts0 + i * 0.1) * 1e9)
                                          for i in range(n)], frames)


@pytest.mark.slow
def test_multisequence_session(tmp_path):
    """Two sequences 100 s apart through one port session: the timestamp
    jump stores the first map (min_kf_spawn=3) and spawns a second; rows of
    both sequences survive, each with the id of a live map (the second map
    may weld back into the first: both views see the same world)."""
    rng = np.random.default_rng(6)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n = 18
    R_gt, t_gt = synthetic.lateral_trajectory(2 * n, x_span=1.6, z_span=0.0,
                                              y_amp=0.05)
    root1, root2 = tmp_path / "seq1" / "mav0", tmp_path / "seq2" / "mav0"
    _write_sequence(root1, world, R_gt[:n], t_gt[:n], 10.0, rng)
    _write_sequence(root2, world, R_gt[n:], t_gt[n:], 110.0, rng)
    args = argparse.Namespace(sensor="mono", pace=False, max_frames=-1)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   min_kf_spawn=3, device="cpu"))
    for root in (root1, root2):
        seq = load_euroc(str(root))
        assert len(seq) == n
        run_euroc.run_sequence(slam, seq, args, inertial=False)
    assert slam.sys_stats.get("n_ts_resets", 0) == 1
    assert slam.state == TrackState.OK, slam.tracker.stats
    out = tmp_path / "traj.txt"
    slam.save_trajectory_tum(str(out))
    assert len(out.read_text().strip().splitlines()) > n
    rows, ids = slam.trajectory(with_map_ids=True)
    assert len(rows) == len(ids)
    assert set(ids.tolist()) <= {m.map_id for m in slam.atlas.maps}
    assert (rows[:, 0] < 100).any() and (rows[:, 0] > 100).any()


@pytest.mark.slow
def test_parity_mode(tmp_path):
    rng = np.random.default_rng(6)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n = 16
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=1.2, z_span=0.0,
                                              y_amp=0.0)
    root = tmp_path / "MH_01_easy" / "mav0"
    _write_sequence(root, world, R_gt, t_gt, 10.0, rng)
    os.makedirs(root / "state_groundtruth_estimate0", exist_ok=True)
    cen = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    with open(root / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        for i in range(n):
            ns = int((10.0 + i * 0.1) * 1e9)
            f.write(f"{ns},{cen[i, 0]},{cen[i, 1]},{cen[i, 2]},1,0,0,0\n")
    rc = run_euroc.main(["--parity", str(tmp_path), "--sensor", "mono",
                         "--device", "cpu"])
    assert rc in (0, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_phase19_writes_pngs_as_libpng_filters_them(tmp_path, frames):
    """chip_smoke.py phase 19's PNG writer picks each row's filter by
    libpng's default rule (the least sum of residuals read as signed bytes):
    Pillow and the port decode its files to the frame, and on a rendered
    frame most rows are Average or Paeth."""
    Image = pytest.importorskip("PIL.Image")
    cs = _chip_smoke()
    img = frames[0]
    data, rows = cs._encode_png_adaptive(img)
    assert rows.sum() == img.shape[0] and rows[3] + rows[4] > img.shape[0] // 2
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))), img)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.read_png(path), img)


def _write_driver_scenario(cs, root, scen):
    """chip_smoke.py phase 19a's mav0 folder for the scenario `scen`."""
    t_ns = [cs.EUROC_T0_NS + i * 100_000_000 for i in range(len(scen["frames"]))]
    cs._write_mav0(root, t_ns, scen["frames"], imu=scen["imu"],
                   centres=cs._centers(scen["R_gt"], scen["t_gt"]))


def test_run_sequence_feeds_what_was_written(tmp_path):
    """run_sequence on chip_smoke.py phase 19a's files (6 frames of the seed
    13 path, tiny images): each stereo call gets the written pair and the
    IMU rows [dt, acc, gyro] of (t_prev, t] that the synthetic generator
    made, within the files' rounding (float32 samples; stamps of 1.4e9 s
    resolve 2.4e-7 s, so dt within 1e-6)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(13)
    traj = synthetic.inertial_trajectory(
        6, fps=10.0, imu_freq=200.0, rng=rng, amp=(0.45, 0.18, 0.0),
        omega=(1.5, 0.9, 0.0), rot_amp=(0.0, 0.0, 0.0))
    frames = [tuple(rng.uniform(0, 255, (2, 6, 8)).astype(np.float32))
              for _ in range(6)]
    root = str(tmp_path / "mav0")
    _write_driver_scenario(cs, root, dict(frames=frames, imu=traj["imu"],
                                          R_gt=traj["R_cw"], t_gt=traj["t_cw"]))
    seq = load_euroc(root)
    slam = _FakeSlam()
    slam.cfg = SystemConfig(imu_freq=200.0, device="cpu")
    args = argparse.Namespace(sensor="stereo-inertial", pace=False,
                              max_frames=-1)
    assert run_euroc.run_sequence(slam, seq, args, inertial=True) == 6
    assert [c[0] for c in slam.calls] == ["stereo"] * 6
    for i, (_, ts, left, imu) in enumerate(slam.calls):
        assert ts == seq.cam0_ts[i]
        np.testing.assert_array_equal(left, cs._u8(frames[i][0]))
        want = traj["imu"][i]
        assert imu.shape == want.shape == ((0, 7) if i == 0 else (20, 7))
        np.testing.assert_allclose(imu[:, 0], want[:, 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(imu[:, 1:], want[:, 1:], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(seq.gt_pos, cs._centers(traj["R_cw"],
                                                       traj["t_cw"]), atol=1e-6)


@pytest.fixture
def cpu_phases(monkeypatch):
    """chip_smoke.py's phases rehearsed on the CPU: no device sync, each
    kernel wrapper's plain version counts as its launch, 4 threads."""
    from orb_slam3_study_kr_tpu_torch.ops import (cuda_fast, cuda_hamming,
                                                  cuda_lib, cuda_matching)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for mod, plain, wrapper in (
            (cuda_fast, "fast_nms_blur_pyramid_plain", "fast_nms_blur_pyramid"),
            (cuda_matching, "gated_nn_plain", "gated_nn"),
            (cuda_hamming, "hamming_nn_plain", "hamming_nn")):
        def counted(*a, _f=getattr(mod, plain), _w=getattr(mod, wrapper), **kw):
            cuda_lib.count_launch(_w)
            return _f(*a, **kw)
        monkeypatch.setattr(mod, plain, counted)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield _chip_smoke()
    torch.set_num_threads(threads)


@pytest.mark.slow
def test_phase19a_on_the_cpu(cpu_phases, tmp_path):
    """chip_smoke.py phase 19a on the CPU, its walls included (stage >= 1,
    init scale 1, metric ATE < 0.25 over > 35 frames from the TUM file, >= 1
    split frame, K1 two per frame, K2 per round), beside the same session
    fed in line (uint8 and float images, the generator's IMU rows and
    stamps).  Prints the phase's line and the in-line metric ATEs (-s)."""
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse

    cs = cpu_phases
    scen = cs.render_scenario("driver_si")
    r = cs.phase_driver_stereo_inertial(torch.device("cpu"), scen,
                                        str(tmp_path))
    in_line = {}
    for kind in ("uint8", "float"):
        s = SlamSystem(SystemConfig(sensor="stereo-inertial", baseline=0.11,
                                    tracker=TrackerConfig(fps=10), device="cpu"))
        for i, (left, right) in enumerate(scen["frames"]):
            if kind == "uint8":
                left, right = cs._u8(left), cs._u8(right)
            s.track_stereo(left, right, scen["timestamps"][i],
                           imu=scen["imu"][i])
        rows = s.trajectory()
        in_line[kind] = ate_rmse(rows[:, 0], rows[:, 1:4], scen["timestamps"],
                                 cs._centers(scen["R_gt"], scen["t_gt"]),
                                 with_scale=False)[0]
    print(f"19a metric ATE: driver {r['ate_metric']:.6f}; in line, uint8 "
          f"images {in_line['uint8']:.6f}, float images "
          f"{in_line['float']:.6f}")


@pytest.mark.slow
def test_phase19b_on_the_cpu(cpu_phases, tmp_path):
    """chip_smoke.py phase 19b on the CPU, its walls included."""
    cs = cpu_phases
    r = cs.phase_driver_mono(torch.device("cpu"),
                             cs.render_scenario("driver_mono"), str(tmp_path))
    assert r["n_ts_resets"] == 1 and r["n_rows"] > 18
