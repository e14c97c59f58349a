"""Typed settings loader for the calibration YAMLs of the supported datasets.

Counterpart of ``orb_slam3_study_kr_tpu/io/settings.py`` (the reference's
src/Settings.cc): reads both the "File.version: 1.0" format (Camera1.fx
etc.) and the legacy flat format (Camera.fx), including OpenCV matrix
nodes (rows/cols/data), and builds the TrackerConfig, the camera model, the
stereo rig and the IMU calibration.  Required keys abort with the offending
name.

The reference parses the file with PyYAML.  The port reads the OpenCV
FileStorage subset these files use with its own reader (``parse_opencv_yaml``),
so that it needs nothing beyond numpy:

- the ``%YAML:1.0`` directive, ``#`` comments and blank lines;
- flat ``key: value`` lines, keys with dots;
- quoted strings, ints, floats (``1e-3`` too: OpenCV reads it as a float,
  where PyYAML's YAML 1.1 rule gives the string "1e-3"; every accessor below
  calls ``float()`` on what it reads, so both readers give the same
  settings), ``true``/``false``;
- ``!!opencv-matrix`` nodes (``rows``, ``cols``, ``dt``, ``data: [...]``,
  ``data`` possibly over several lines) and flow lists ``[...]``.
"""

import re

import numpy as np

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")


def _strip_comment(line):
    """The line without a trailing ``# comment`` (outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("", "~", "null"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _flow_list(text, path, lineno):
    text = text.strip()
    if not (text.startswith("[") and text.endswith("]")):
        raise ValueError(f"{path}:{lineno}: unterminated list")
    body = text[1:-1].strip()
    return [_scalar(x) for x in body.split(",")] if body else []


def _statements(path, text):
    """(lineno, indent, key, value text) per logical line; a value opening a
    ``[`` list runs on to its ``]``."""
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        lineno, raw = i + 1, _strip_comment(lines[i]).rstrip()
        i += 1
        if not raw.strip() or raw.lstrip().startswith("%") or raw.strip() == "---":
            continue
        if ":" not in raw:
            raise ValueError(f"{path}:{lineno}: expected 'key: value'")
        key, value = raw.split(":", 1)
        value = value.strip()
        if value.startswith("[") and "]" not in value:
            while i < len(lines) and "]" not in value:
                value += " " + _strip_comment(lines[i]).strip()
                i += 1
        yield lineno, len(raw) - len(raw.lstrip()), key.strip(), value


def parse_opencv_yaml(path):
    """The key/value table of an OpenCV FileStorage YAML file.  A matrix
    node becomes ``{"rows", "cols", "dt", "data"}`` as PyYAML gives it."""
    with open(path) as f:
        text = f.read()
    out, node, node_indent = {}, None, -1
    for lineno, indent, key, value in _statements(path, text):
        if node is not None and indent > node_indent:
            node[key] = (_flow_list(value, path, lineno)
                         if value.startswith("[") else _scalar(value))
            continue
        node = None
        if value.startswith("!!") or value == "":
            # A nested mapping (an !!opencv-matrix node) on the lines below.
            node, node_indent = {}, indent
            out[key] = node
        elif value.startswith("["):
            out[key] = _flow_list(value, path, lineno)
        else:
            out[key] = _scalar(value)
    return out


class Settings:
    def __init__(self, path):
        self.raw = parse_opencv_yaml(path)
        self.version = str(self.raw.get("File.version", "legacy"))

    def get(self, key, default=None, required=False):
        if key in self.raw:
            return self.raw[key]
        if required:
            raise KeyError(f"required settings key missing: {key}")
        return default

    def matrix(self, key):
        node = self.get(key)
        if node is None:
            return None
        if isinstance(node, dict):
            return np.asarray(node["data"], np.float64).reshape(
                node["rows"], node["cols"])
        return np.asarray(node, np.float64)

    # ------------------------------------------------------------------
    def camera_kind(self):
        t = self.get("Camera.type", self.get("Camera1.type", "PinHole"))
        return str(t)

    def _cam_key(self, name):
        # v1.0 uses Camera1.*, legacy uses Camera.*
        for prefix in ("Camera1", "Camera"):
            v = self.get(f"{prefix}.{name}")
            if v is not None:
                return float(v)
        raise KeyError(f"required settings key missing: Camera.{name}")

    def _pinhole_dist(self):
        return tuple(float(self.get(f"Camera1.{k}", self.get(f"Camera.{k}", 0.0))
                           or 0.0) for k in ("k1", "k2", "p1", "p2", "k3"))

    def make_camera(self, width=None, height=None, device="cuda"):
        from orb_slam3_study_kr_tpu_torch.cameras import make_kb8, make_pinhole

        w = int(self.get("Camera.width", width or 752))
        h = int(self.get("Camera.height", height or 480))
        fx = self._cam_key("fx")
        fy = self._cam_key("fy")
        cx = self._cam_key("cx")
        cy = self._cam_key("cy")
        if self.camera_kind() == "KannalaBrandt8":
            ks = [self._cam_key(f"k{i}") for i in (1, 2, 3, 4)]
            return make_kb8(fx, fy, cx, cy, *ks, width=w, height=h,
                            device=device)
        return make_pinhole(fx, fy, cx, cy, *self._pinhole_dist(), width=w,
                            height=h, device=device)

    def tracker_config(self, device="cuda"):
        from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig

        if self.camera_kind() == "KannalaBrandt8":
            camera_model = "kb8"
            dist = tuple(self._cam_key(f"k{i}") for i in (1, 2, 3, 4))
        else:
            camera_model = "pinhole"
            dist = self._pinhole_dist()
        return TrackerConfig(
            width=int(self.get("Camera.width", 752)),
            height=int(self.get("Camera.height", 480)),
            fx=self._cam_key("fx"), fy=self._cam_key("fy"),
            cx=self._cam_key("cx"), cy=self._cam_key("cy"), dist=dist,
            camera_model=camera_model,
            fps=float(self.get("Camera.fps", 30.0)),
            n_features=int(self.get("ORBextractor.nFeatures", 1000)),
            orb_n_levels=int(self.get("ORBextractor.nLevels", 8)),
            orb_scale_factor=float(self.get("ORBextractor.scaleFactor", 1.2)),
            orb_ini_th_fast=int(self.get("ORBextractor.iniThFAST", 20)),
            orb_min_th_fast=int(self.get("ORBextractor.minThFAST", 7)),
            # A fisheye rig is never rectified: bf stays 0.
            bf=float(self.get("Camera.bf", 0.0) or 0.0)
            if camera_model != "kb8" else 0.0,
            device=device,
        )

    # ------------------------------------------------------------------
    def stereo(self):
        """The stereo rig (Settings.h stereo block), None for a monocular
        file, else a dict with:
          bf / baseline / th_depth: the rectified rig's scalars;
          R_rl, t_rl: the pose of the left camera in the right camera's
            frame, from v1.0 ``Stereo.T_c1_c2`` (the reference's Tlr) or the
            legacy ``Tlr`` when present, else from bf;
          cam2: (fx, fy, cx, cy, dists...) of the right camera when the file
            carries Camera2.* keys."""
        bf = self.get("Camera.bf")
        T12 = self.matrix("Stereo.T_c1_c2")
        if T12 is None:
            T12 = self.matrix("Tlr")
        if bf is None and T12 is None:
            return None
        out = {"bf": float(bf) if bf is not None else None,
               "th_depth": float(self.get(
                   "ThDepth", self.get("Stereo.ThDepth", 35.0)) or 35.0)}
        if T12 is not None:
            # T_c1_c2 maps right-camera coordinates into the left camera:
            # p_l = R12 p_r + t12, so p_r = R12^T p_l - R12^T t12.
            R12 = T12[:3, :3]
            t12 = T12[:3, 3]
            out["R_rl"] = R12.T
            out["t_rl"] = -R12.T @ t12
            out["baseline"] = float(np.linalg.norm(t12))
        elif bf is not None:
            out["baseline"] = float(bf) / self._cam_key("fx")
            out["R_rl"] = np.eye(3)
            out["t_rl"] = np.array([-out["baseline"], 0.0, 0.0])
        if self.get("Camera2.fx") is not None:
            ks = (("k1", "k2", "k3", "k4")
                  if self.camera_kind() == "KannalaBrandt8"
                  else ("k1", "k2", "p1", "p2", "k3"))
            out["cam2"] = tuple(
                float(self.get(f"Camera2.{k}", 0.0) or 0.0)
                for k in ("fx", "fy", "cx", "cy", *ks))
        return out

    def atlas_files(self):
        """System.LoadAtlasFromFile / System.SaveAtlasToFile."""
        return (self.get("System.LoadAtlasFromFile"),
                self.get("System.SaveAtlasToFile"))

    def imu_params(self):
        """The IMU block as the file states it: the continuous noise
        densities, the bias random walks, the rate and the body <- camera
        extrinsic (from ``IMU.T_b_c1`` or the legacy ``Tbc``; None when
        absent).  None when the file has no IMU block."""
        if self.get("IMU.NoiseGyro") is None:
            return None
        Tbc = self.matrix("IMU.T_b_c1")
        if Tbc is None:
            Tbc = self.matrix("Tbc")
        return dict(
            noise_gyro=float(self.get("IMU.NoiseGyro", required=True)),
            noise_acc=float(self.get("IMU.NoiseAcc", required=True)),
            walk_gyro=float(self.get("IMU.GyroWalk", required=True)),
            walk_acc=float(self.get("IMU.AccWalk", required=True)),
            freq=float(self.get("IMU.Frequency", 200.0)),
            R_bc=Tbc[:3, :3] if Tbc is not None else None,
            t_bc=Tbc[:3, 3] if Tbc is not None else None)

    def imu_calib(self, device="cuda"):
        """The IMU calibration (the port's ImuCalib, per-sample noise) on
        ``device``; None when the file has no IMU block."""
        from orb_slam3_study_kr_tpu_torch.imu import ImuCalib

        p = self.imu_params()
        return None if p is None else ImuCalib.make(**p, device=device)
