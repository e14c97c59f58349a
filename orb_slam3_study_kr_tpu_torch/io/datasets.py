"""Dataset loaders: the EuRoC MAV (and TUM-VI), TUM RGB-D and KITTI odometry
directory layouts.

Counterpart of ``orb_slam3_study_kr_tpu/io/datasets.py`` (the reference's
example-side loaders: mono_euroc.cc LoadImages, the stereo-inertial image
and IMU sync, mono_kitti.cc LoadImages).  Images are decoded by the port's
own PNG reader (``io/png.py``); everything else is plain CSV parsing.  A
colour image becomes the mean of its channels, and every image float32.
"""

import csv
import os
from dataclasses import dataclass

import numpy as np

from orb_slam3_study_kr_tpu_torch.io.png import read_png


def _load_image(path):
    img = read_png(path)
    if img.ndim == 3:
        img = img.mean(axis=2)
    return img.astype(np.float32)


def _csv_rows(path):
    """The rows of a CSV file, '#' comment lines and empty rows left out."""
    with open(path) as f:
        return [row for row in csv.reader(f)
                if row and not row[0].startswith("#")]


@dataclass
class EurocSequence:
    root: str                   # .../<seq>/mav0
    cam0_ts: np.ndarray         # (N,) seconds
    cam0_files: list
    cam1_ts: np.ndarray = None
    cam1_files: list = None
    imu_ts: np.ndarray = None   # (M,) seconds
    imu_gyro: np.ndarray = None  # (M, 3)
    imu_acc: np.ndarray = None   # (M, 3)
    gt_ts: np.ndarray = None
    gt_pos: np.ndarray = None

    def __len__(self):
        return len(self.cam0_files)

    def image(self, i, cam=0):
        files = self.cam0_files if cam == 0 else self.cam1_files
        sub = "cam0" if cam == 0 else "cam1"
        return _load_image(os.path.join(self.root, sub, "data", files[i]))

    def imu_between(self, t0, t1):
        """IMU samples with t0 < t <= t1 (the tracker's preintegration
        window, Tracking::PreintegrateIMU)."""
        sel = (self.imu_ts > t0) & (self.imu_ts <= t1)
        return self.imu_ts[sel], self.imu_gyro[sel], self.imu_acc[sel]


def load_euroc(root):
    """root: path to <sequence>/mav0."""

    def read_cam(sub):
        path = os.path.join(root, sub, "data.csv")
        if not os.path.exists(path):
            return None, None
        rows = _csv_rows(path)
        return (np.asarray([int(r[0]) * 1e-9 for r in rows]),
                [r[1].strip() for r in rows])

    cam0_ts, cam0_files = read_cam("cam0")
    cam1_ts, cam1_files = read_cam("cam1")

    imu_ts = imu_gyro = imu_acc = None
    imu_path = os.path.join(root, "imu0", "data.csv")
    if os.path.exists(imu_path):
        arr = np.asarray([[float(x) for x in r] for r in _csv_rows(imu_path)])
        imu_ts = arr[:, 0] * 1e-9
        imu_gyro = arr[:, 1:4].astype(np.float32)
        imu_acc = arr[:, 4:7].astype(np.float32)

    gt_ts = gt_pos = None
    gt_path = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_path):
        arr = np.asarray([[float(x) for x in r[:8]]
                          for r in _csv_rows(gt_path)])
        gt_ts = arr[:, 0] * 1e-9
        gt_pos = arr[:, 1:4]

    return EurocSequence(
        root=root, cam0_ts=cam0_ts, cam0_files=cam0_files,
        cam1_ts=cam1_ts, cam1_files=cam1_files,
        imu_ts=imu_ts, imu_gyro=imu_gyro, imu_acc=imu_acc,
        gt_ts=gt_ts, gt_pos=gt_pos,
    )


@dataclass
class TumRgbdSequence:
    root: str
    rgb_ts: np.ndarray
    rgb_files: list
    depth_ts: np.ndarray = None
    depth_files: list = None

    def __len__(self):
        return len(self.rgb_files)

    def image(self, i):
        return _load_image(os.path.join(self.root, self.rgb_files[i]))

    def depth(self, i, scale=1.0 / 5000.0):
        d = _load_image(os.path.join(self.root, self.depth_files[i]))
        return d * scale


def load_tum_rgbd(root):
    def read_list(name):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            return None, None
        ts, files = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()[:2]
                ts.append(float(a))
                files.append(b)
        return np.asarray(ts), files

    rgb_ts, rgb_files = read_list("rgb.txt")
    depth_ts, depth_files = read_list("depth.txt")
    return TumRgbdSequence(root=root, rgb_ts=rgb_ts, rgb_files=rgb_files,
                           depth_ts=depth_ts, depth_files=depth_files)


@dataclass
class KittiSequence:
    """KITTI odometry sequence (gray): <seq>/times.txt + image_0/ (+ image_1/
    for stereo) with 6-digit zero-padded .png frames."""
    root: str
    ts: np.ndarray              # (N,) seconds
    left_files: list
    right_files: list = None
    calib: dict = None          # P0/P1... projection rows from calib.txt

    def __len__(self):
        return len(self.left_files)

    def image(self, i, cam=0):
        files = self.left_files if cam == 0 else self.right_files
        return _load_image(files[i])


def load_kitti(root):
    """root: path to the sequence directory (e.g. .../sequences/00)."""
    with open(os.path.join(root, "times.txt")) as f:
        ts = np.asarray([float(line) for line in f if line.strip()])

    def frames(sub):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            return None
        return [os.path.join(d, f"{i:06d}.png") for i in range(len(ts))]

    # calib.txt: "P0: <12 floats>" per line, the 3x4 projection matrices
    # the drivers take fx and the stereo baseline from.
    calib = {}
    calib_path = os.path.join(root, "calib.txt")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                v = np.asarray([float(x) for x in vals.split()])
                if v.size == 12:
                    calib[key.strip()] = v.reshape(3, 4)
    return KittiSequence(root=root, ts=ts, left_files=frames("image_0"),
                         right_files=frames("image_1"), calib=calib or None)
