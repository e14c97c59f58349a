"""The port's settings reader, dataset loaders, PNG codec and constants
audit against the JAX reference, on fixtures written to tmp_path.

- ``Settings``: five calibration YAMLs (a raw EuRoC stereo rig, the same
  with an IMU block, a v1.0 TUM-VI KB8 stereo-inertial rig, a legacy flat
  ``Camera.*`` + ``Tlr`` file and one with a ``1e-3`` scalar, which PyYAML
  reads as a string and the port's reader as a float).  Every accessor
  agrees: ``tracker_config()`` (through ``convert``), ``stereo()`` (arrays
  within 1e-12), ``imu_calib()``, ``atlas_files()``, ``make_camera()``.
- The loaders: identical timestamps, file lists, IMU windows, calibration
  and images (exact) on EuRoC, TUM RGB-D and KITTI fixture folders.
- ``io/png.py`` decodes exactly as Pillow does (8-bit gray, gray + alpha,
  RGB, RGBA, 16-bit gray; rendered and random images; hand-built scanlines
  with each of the five filters, in turn and at random from the first row)
  and its encoder round-trips through Pillow.
- ``parity.audit_rows()``: the port's table equals the reference's row for
  row.
"""

import dataclasses
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import parity as jparity
from orb_slam3_study_kr_tpu.io import datasets as jdatasets
from orb_slam3_study_kr_tpu.io.settings import Settings as JSettings
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch import parity as tparity
from orb_slam3_study_kr_tpu_torch.io import datasets as tdatasets
from orb_slam3_study_kr_tpu_torch.io import png, synthetic
from orb_slam3_study_kr_tpu_torch.io.settings import Settings, parse_opencv_yaml

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_rectify.py's raw EuRoC stereo rig (distorted, not rectified).
RAW_STEREO = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 0.0000176187114
Camera2.fx: 457.587
Camera2.fy: 456.134
Camera2.cx: 379.999
Camera2.cy: 255.238
Camera2.k1: -0.28368365
Camera2.k2: 0.07451284
Camera2.p1: -0.00010473
Camera2.p2: -0.0000035559
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997, 0.002312, 0.000376, 0.110074,
         -0.002317, 0.999898, 0.014090, 0.000399,
         -0.000343, -0.014091, 0.999901, -0.000853,
         0.0, 0.0, 0.0, 1.0]
"""

# The same rig with EuRoC's IMU block (its cam0 extrinsic).
IMU_BLOCK = """
# Transformation from camera 0 to body-frame (imu)
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

IMU.NoiseGyro: 1.7e-4 # 1.6968e-04
IMU.NoiseAcc: 2.0000e-3 # 2.0e-3
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0000e-03 # 3e-03
IMU.Frequency: 200.0
"""
RAW_STEREO_IMU = RAW_STEREO + IMU_BLOCK

# A v1.0 TUM-VI stereo-inertial file: two KB8 lenses, the rig's extrinsic,
# the IMU block, the extractor and viewer keys.
TUMVI_KB8 = """%YAML:1.0

#--------------------------------------------------------------------------------------------
# System config
#--------------------------------------------------------------------------------------------
File.version: "1.0"

Camera.type: "KannalaBrandt8"

# Left Camera calibration and distortion parameters (OpenCV)
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442

# Kannala-Brandt distortion parameters
Camera1.k1: 0.0034823894022493434
Camera1.k2: 0.0007150348452162257
Camera1.k3: -0.0020532361418706202
Camera1.k4: 0.00020293673591811182

# Right Camera calibration and distortion parameters (OpenCV)
Camera2.fx: 190.442369
Camera2.fy: 190.4344189
Camera2.cx: 252.597202
Camera2.cy: 254.9174861

# Kannala-Brandt distortion parameters
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039

# Transformation matrix from right camera to left camera
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [ 0.999999445773493,   0.000791687752817,   0.000694034010224,   0.101063427414194,
         -0.000823363992158,   0.998899461915674,   0.046895490788700,   0.001946204678584,
         -0.000656143613644,  -0.046896036240590,   0.998899560146304,   0.001015350132563,
          0.0, 0.0, 0.0, 1.0]

# Overlapping area between images (in pixels)
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511

Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 511

# Camera resolution
Camera.width: 512
Camera.height: 512

# Camera frames per second
Camera.fps: 20

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Close/Far threshold. Baseline times.
Stereo.ThDepth: 40.0

# Transformation from body-frame (imu) to left camera
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [-0.9995250378696743, 0.0075019185074052044, -0.02989013031643309, 0.045574835649698026,
         0.029615343885863205, -0.03439736061393144, -0.998969345370175, -0.071161801837997044,
         -0.008522328211654736, -0.9993800792498829, 0.03415885127385616, -0.044681254117144367,
         0.0, 0.0, 0.0, 1.0]

# IMU noise (Use those from VINS-mono)
IMU.NoiseGyro: 0.004 # rad/s^0.5
IMU.NoiseAcc: 0.04 # m/s^1.5
IMU.GyroWalk: 0.000022 # rad/s^1.5
IMU.AccWalk: 0.0004 # m/s^2.5
IMU.Frequency: 200.0

System.SaveAtlasToFile: "tumvi_atlas"

# ORB Extractor: Number of features per image
ORBextractor.nFeatures: 1500 # Tested with 1250

# ORB Extractor: Scale factor between levels in the scale pyramid
ORBextractor.scaleFactor: 1.2

# ORB Extractor: Number of levels in the scale pyramid
ORBextractor.nLevels: 8

# ORB Extractor: Fast threshold
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.CameraLineWidth: 3.0
Viewer.ViewpointF: 500.0
"""

# The legacy flat format (ORB-SLAM2 style): Camera.*, Camera.bf, Tlr, Tbc.
LEGACY = """%YAML:1.0

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297

Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0

Camera.width: 752
Camera.height: 480

# Camera frames per second
Camera.fps: 20.0

# stereo baseline times fx
Camera.bf: 47.90639384423901

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Close/Far threshold. Baseline times.
ThDepth: 35

Tlr: !!opencv-matrix
  rows: 3
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.110073808127187,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0]

Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.01,
         0.0, 1.0, 0.0, -0.02,
         0.0, 0.0, 1.0, 0.03,
         0.0, 0.0, 0.0, 1.0]

IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200

ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

# Scalars without a dot: PyYAML reads "1e-3" as a string, the port's reader
# as a float; the accessors call float() on both.
SCI = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera.width: 752
Camera.height: 480
Camera.fps: 1e1
Camera.bf: 50.45194
Stereo.ThDepth: 4e1
IMU.NoiseGyro: 1e-3
IMU.NoiseAcc: 2e-2
IMU.GyroWalk: 2e-5
IMU.AccWalk: 3e-3
IMU.Frequency: 2e2
System.LoadAtlasFromFile: 'atlas_in'  # quoted with '
"""

YAMLS = {"raw_stereo": RAW_STEREO, "raw_stereo_imu": RAW_STEREO_IMU,
         "tumvi_kb8": TUMVI_KB8, "legacy": LEGACY, "sci": SCI}


def write_yaml(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAMLS[name])
    return str(path)


# ---------------------------------------------------------------------------
# Settings


def test_reader_reads_what_pyyaml_reads(tmp_path):
    """Key for key the port's reader gives PyYAML's table, except the
    dot-less exponents, which it reads as the floats PyYAML leaves as
    strings."""
    for name in YAMLS:
        path = write_yaml(tmp_path, name)
        ours = parse_opencv_yaml(path)
        ref = JSettings(path).raw
        assert set(ours) == set(ref), name
        for k, v in ref.items():
            if isinstance(v, str) and v != ours[k]:
                assert float(v) == ours[k], (name, k)
            else:
                assert ours[k] == v and type(ours[k]) is type(v), (name, k)
    assert parse_opencv_yaml(write_yaml(tmp_path, "sci"))["IMU.NoiseGyro"] == 1e-3


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_settings_accessors_match_reference(name, tmp_path):
    path = write_yaml(tmp_path, name)
    js, ts = JSettings(path), Settings(path)
    assert ts.version == js.version and ts.camera_kind() == js.camera_kind()
    ref_cfg = convert.tracker_config_from_dict(
        dataclasses.asdict(js.tracker_config()), device="cpu")
    assert ts.tracker_config(device="cpu") == ref_cfg
    assert ts.atlas_files() == js.atlas_files()

    jr, tr = js.stereo(), ts.stereo()
    assert (jr is None) == (tr is None)
    if jr is not None:
        assert set(tr) == set(jr)
        for k, v in jr.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(tr[k], v, rtol=0, atol=1e-12)
            else:
                assert tr[k] == v, k

    jc, tc = js.imu_calib(), ts.imu_calib(device="cpu")
    assert (jc is None) == (tc is None)
    if jc is not None:
        for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "R_bc",
                  "t_bc"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)), err_msg=f)

    jcam, tcam = js.make_camera(), ts.make_camera(device="cpu")
    assert tcam.kind.value == jcam.kind.value
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height)
    np.testing.assert_array_equal(tcam.params.numpy(), np.asarray(jcam.params))


def test_settings_defaults_to_the_card(tmp_path):
    """The device-taking accessors run on the card unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    st = Settings(write_yaml(tmp_path, "raw_stereo_imu"))
    assert st.tracker_config().device == "cuda"
    for call in (st.make_camera, st.imu_calib):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_reader_errors_name_the_file(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("%YAML:1.0\nCamera.fx 458.0\n")
    with pytest.raises(ValueError, match="bad.yaml:2"):
        Settings(str(bad))
    with pytest.raises(KeyError, match="Camera.fx"):
        bad.write_text("%YAML:1.0\nCamera.width: 752\n")
        Settings(str(bad)).tracker_config(device="cpu")


# ---------------------------------------------------------------------------
# Loaders

T0_NS = 1403636579763555584


@pytest.fixture(scope="module")
def frames():
    """Four rendered 752x480 frames as uint8 (one world for the module)."""
    rng = np.random.default_rng(3)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R, t = synthetic.lateral_trajectory(4, x_span=0.2, z_span=0.0)
    return [np.clip(synthetic.render_textured(world, R[i], t[i], rng=rng),
                    0, 255).astype(np.uint8) for i in range(4)]


def write_euroc(root, imgs, imgs_r=None, rng=None):
    """A mav0 folder: cam0 (and cam1) PNGs at 20 Hz, imu0 at 200 Hz, the
    ground truth at 200 Hz."""
    rng = rng or np.random.default_rng(0)
    for cam, frames in (("cam0", imgs), ("cam1", imgs_r)):
        if frames is None:
            continue
        os.makedirs(root / cam / "data", exist_ok=True)
        with open(root / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, img in enumerate(frames):
                ns = T0_NS + i * 50_000_000
                png.write_png(root / cam / "data" / f"{ns}.png", img)
                f.write(f"{ns},{ns}.png\n")
    n_imu = 10 * len(imgs) + 5
    os.makedirs(root / "imu0", exist_ok=True)
    os.makedirs(root / "state_groundtruth_estimate0", exist_ok=True)
    with open(root / "imu0" / "data.csv", "w") as f, \
            open(root / "state_groundtruth_estimate0" / "data.csv", "w") as g:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z\n")
        g.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for k in range(n_imu):
            ns = T0_NS - 10_000_000 + k * 5_000_000
            w, a = rng.normal(0, 0.1, 3), rng.normal(0, 1, 3) + [0, 0, 9.81]
            f.write(f"{ns}," + ",".join(repr(float(x)) for x in (*w, *a)) + "\n")
            p = rng.normal(0, 1, 3)
            g.write(f"{ns}," + ",".join(repr(float(x)) for x in p)
                    + ",1.0,0.0,0.0,0.0\n")


def _same_fields(a, b, names):
    for k in names:
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def test_euroc_loader_matches_reference(tmp_path, frames):
    imgs = frames
    root = tmp_path / "mav0"
    write_euroc(root, imgs, imgs_r=[255 - x for x in imgs])
    j, t = jdatasets.load_euroc(str(root)), tdatasets.load_euroc(str(root))
    assert len(t) == len(j) == 4
    _same_fields(t, j, ("root", "cam0_ts", "cam0_files", "cam1_ts",
                        "cam1_files", "imu_ts", "imu_gyro", "imu_acc",
                        "gt_ts", "gt_pos"))
    for i in range(len(t)):
        for cam in (0, 1):
            a, b = t.image(i, cam), j.image(i, cam)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        t0 = t.cam0_ts[i - 1] if i else t.cam0_ts[0] - 0.005
        for a, b in zip(t.imu_between(t0, t.cam0_ts[i]),
                        j.imu_between(t0, j.cam0_ts[i])):
            np.testing.assert_array_equal(a, b)
    assert len(t.imu_between(t.cam0_ts[0], t.cam0_ts[1])[0]) == 10


def test_tum_rgbd_loader_matches_reference(tmp_path, frames):
    rng = np.random.default_rng(4)
    gray = frames[1:]
    os.makedirs(tmp_path / "rgb")
    os.makedirs(tmp_path / "depth")
    with open(tmp_path / "rgb.txt", "w") as f, \
            open(tmp_path / "depth.txt", "w") as g:
        f.write("# color images\n# file: 'rgbd_dataset'\n# timestamp filename\n")
        g.write("# depth maps\n")
        for i, img in enumerate(gray):
            ts = 1305031102.175304 + i * 0.033
            rgb = np.stack([img, 255 - img, img // 2], -1)
            if i == 2:      # an RGBA frame
                rgb = np.concatenate([rgb, np.full_like(img, 200)[..., None]], -1)
            png.write_png(tmp_path / "rgb" / f"{ts:.6f}.png", rgb)
            depth = rng.integers(0, 40000, img.shape).astype(np.uint16)
            png.write_png(tmp_path / "depth" / f"{ts:.6f}.png", depth)
            f.write(f"{ts:.6f} rgb/{ts:.6f}.png\n")
            g.write(f"{ts + 0.002:.6f} depth/{ts:.6f}.png\n")
    j, t = jdatasets.load_tum_rgbd(str(tmp_path)), tdatasets.load_tum_rgbd(
        str(tmp_path))
    assert len(t) == len(j) == 3
    _same_fields(t, j, ("root", "rgb_ts", "rgb_files", "depth_ts",
                        "depth_files"))
    for i in range(3):
        for a, b in ((t.image(i), j.image(i)), (t.depth(i), j.depth(i))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def write_kitti(root, imgs, fx=718.856, baseline=0.54, stereo=True):
    os.makedirs(root / "image_0", exist_ok=True)
    if stereo:
        os.makedirs(root / "image_1", exist_ok=True)
    with open(root / "times.txt", "w") as f:
        for i, img in enumerate(imgs):
            f.write(f"{i * 0.1036:.6e}\n")
            png.write_png(root / "image_0" / f"{i:06d}.png", img)
            if stereo:
                png.write_png(root / "image_1" / f"{i:06d}.png", img[:, ::-1])
    p0 = np.array([fx, 0, 607.1928, 0, 0, fx, 185.2157, 0, 0, 0, 1, 0])
    p1 = p0.copy()
    p1[3] = -fx * baseline
    with open(root / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(f"{x:.12e}" for x in p0) + "\n")
        f.write("P1: " + " ".join(f"{x:.12e}" for x in p1) + "\n")
        f.write("Tr: " + " ".join(["0"] * 11) + "\n")    # 11 values: skipped


def test_kitti_loader_matches_reference(tmp_path, frames):
    write_kitti(tmp_path, frames[:3])
    j, t = jdatasets.load_kitti(str(tmp_path)), tdatasets.load_kitti(
        str(tmp_path))
    _same_fields(t, j, ("root", "ts", "left_files", "right_files"))
    assert set(t.calib) == set(j.calib) == {"P0", "P1"}
    for k in t.calib:
        np.testing.assert_array_equal(t.calib[k], j.calib[k])
    for i in range(3):
        for cam in (0, 1):
            np.testing.assert_array_equal(t.image(i, cam), j.image(i, cam))


# ---------------------------------------------------------------------------
# PNG


def _pil():
    return pytest.importorskip("PIL.Image")


def _pil_png(arr, mode=None):
    Image = _pil()
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def _pil_decode(data):
    Image = _pil()
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba",
                                  "gray16", "random_gray", "random_rgb",
                                  "full_frame"])
def test_png_decodes_as_pillow(kind, frames):
    """Pillow's adaptive encoder picks a filter per row: its files carry a
    mix of the five filters (on rendered frames mostly Paeth)."""
    _pil()
    rng = np.random.default_rng(7)
    img = frames[2][:160, :224]
    arr = {"gray": img,
           "gray_alpha": np.stack([img, 255 - img], -1),
           "rgb": np.stack([img, 255 - img, img // 3], -1),
           "rgba": np.stack([img, 255 - img, img // 3, img // 2 + 60], -1),
           "gray16": (img.astype(np.uint16) * 257
                      + rng.integers(0, 200, img.shape).astype(np.uint16)),
           "random_gray": rng.integers(0, 256, (37, 53), np.uint8),
           "random_rgb": rng.integers(0, 256, (29, 41, 3), np.uint8),
           "full_frame": frames[3]}[kind]
    data = _pil_png(arr, "LA" if kind == "gray_alpha" else None)
    ref = _pil_decode(data)
    out = png.decode_png(data)
    assert out.shape == ref.shape and out.dtype.itemsize == ref.dtype.itemsize
    np.testing.assert_array_equal(out, ref)


def _filter_row(ftype, row, prior, bpp):
    """Encode one scanline with PNG filter `ftype` (the spec's formulas)."""
    r, p = row.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (a + p) // 2
    else:
        pp = a + p - c
        pa, pb, pc = np.abs(pp - a), np.abs(pp - p), np.abs(pp - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


@pytest.mark.parametrize("colour,ch", [(0, 1), (2, 3), (6, 4), (4, 2)])
def test_png_every_filter(colour, ch):
    """Hand-built scanlines: row y uses filter y % 5, so each of the five
    filters follows each other; decoded as Pillow decodes them."""
    _pil()
    rng = np.random.default_rng(colour)
    h, w = 15, 23
    img = rng.integers(0, 256, (h, w * ch), np.uint8)
    img[3:6] = img[2]           # repeated rows exercise Up / Paeth ties
    raw, prior = b"", np.zeros(w * ch, np.uint8)
    for y in range(h):
        f = y % 5
        raw += bytes([f]) + _filter_row(f, img[y], prior, ch).tobytes()
        prior = img[y]
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)[:40])
            + _chunk(b"IDAT", zlib.compress(raw)[40:])
            + _chunk(b"IEND", b""))
    want = img.reshape(h, w, ch) if ch > 1 else img
    np.testing.assert_array_equal(_pil_decode(data), want)
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("colour,ch", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_random_filters_from_the_first_row(colour, ch):
    """Rows take random filters, Average or Paeth from the first row on (so
    the diagonal sweep starts on the zero prior row), and mixed with None,
    Sub and Up rows that the sweep reverses too."""
    _pil()
    rng = np.random.default_rng(10 + colour)
    h, w = 19, 37
    img = rng.integers(0, 256, (h, w * ch), np.uint8)
    img[7:10] = img[6]
    ftypes = rng.integers(0, 5, h)
    ftypes[0] = 3 + colour % 2
    raw, prior = b"", np.zeros(w * ch, np.uint8)
    for y, f in enumerate(ftypes):
        raw += bytes([f]) + _filter_row(f, img[y], prior, ch).tobytes()
        prior = img[y]
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    want = img.reshape(h, w, ch) if ch > 1 else img
    np.testing.assert_array_equal(_pil_decode(data), want)
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (31, 47)),
                                         (np.uint8, (31, 47, 3)),
                                         (np.uint8, (31, 47, 4)),
                                         (np.uint16, (31, 47))])
def test_png_encoder_round_trips_through_pillow(dtype, shape, tmp_path):
    _pil()
    rng = np.random.default_rng(2)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = png.write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(_pil_decode(path.read_bytes()), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_does_not_decode(tmp_path):
    def header(depth, colour, interlace=0):
        return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, depth, colour, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(b"\0" * 40)) + _chunk(b"IEND", b""))

    for data, what in ((header(8, 3), "palette"), (header(8, 0, 1), "interlaced"),
                       (header(4, 0), "bit depth"), (header(16, 2), "bit depth"),
                       (b"GIF89a", "not a PNG")):
        path = tmp_path / "bad.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"bad.png.*{what}"):
            png.read_png(path)


# ---------------------------------------------------------------------------
# The constants audit and the import guard


def test_parity_audit_matches_reference():
    """The port's audit, from its own live values, equals the reference's
    row for row: every load-bearing constant is the reference's."""
    rows, ref = tparity.audit_rows(), jparity.audit_rows()
    assert [dataclasses.astuple(r) for r in rows] == \
        [dataclasses.astuple(r) for r in ref]
    mism, devs = tparity.audit()
    assert not mism and len(devs) == len(jparity.audit()[1])
    assert tparity.main() == 0


NEW_MODULES = ("io.png", "io.settings", "io.datasets", "parity", "viz",
               "viz.frame_drawer", "viz.map_drawer", "viz.viewer",
               "examples.run_euroc", "examples.run_kitti",
               "examples.run_synthetic", "examples.ros_node")


def test_new_modules_load_no_optional_packages():
    """Importing the slice's modules loads neither JAX, nor the reference
    package, nor PyYAML, Pillow, imageio or matplotlib (the card's machine
    has none of the last four)."""
    code = ("import sys\n"
            + "".join(f"import orb_slam3_study_kr_tpu_torch.{m}\n"
                      for m in NEW_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'yaml', 'PIL', 'imageio', 'matplotlib', "
              "'orb_slam3_study_kr_tpu'))\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
