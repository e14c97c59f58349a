"""The port runs on the card unless the caller asks for the CPU: every
object (a Frame too), vocabulary entry point, driver's build_system and
SlamSystem.upload_image built with the default device raises without a
card, and the same calls with device="cpu" run."""

import argparse
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch import cameras, convert
from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase
from orb_slam3_study_kr_tpu_torch.bow import vocabulary as voc_mod
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.async_mapping import AsyncMapping
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.imu import ImuCalib
from orb_slam3_study_kr_tpu_torch.pipeline.global_ba import global_bundle_adjustment
from orb_slam3_study_kr_tpu_torch.pipeline.inertial_tracking import (
    FisheyeStereoInertialTracker, InertialTracker, RgbdInertialTracker,
    StereoInertialTracker)
from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.pipeline.map_merging import MapMerger
from orb_slam3_study_kr_tpu_torch.pipeline.stereo_tracking import (
    FisheyeStereoTracker, StereoTracker)
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import MonoTracker, TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
from orb_slam3_study_kr_tpu_torch.examples import run_euroc, run_kitti
from orb_slam3_study_kr_tpu_torch.io import png
from orb_slam3_study_kr_tpu_torch.io.datasets import load_kitti
from orb_slam3_study_kr_tpu_torch.parallel import make_ba_mesh, multihost_worker
from test_torch_fisheye_cuda import KB8, kb8_kw

torch.set_num_threads(2)

DESC = np.random.default_rng(0).integers(0, 2, (64, 256)).astype(np.uint8)


def _map():
    return MapState(max_kf=4, max_kp=16, max_lm=64)


def _db():
    return KeyframeDatabase(voc=voc_mod.train_vocabulary(DESC, k=2, L=2,
                                                         device="cpu"))


def _saved(tmp_path):
    path = tmp_path / "voc.npz"
    voc_mod.save_vocabulary(voc_mod.train_vocabulary(DESC, k=2, L=2,
                                                     device="cpu"), path)
    return path


def _stopped_worker(device):
    w = AsyncMapping(device=device)
    w.shutdown()
    return w


def _session(device, **kw):
    """A SlamSystem of the given sensor or mode, its worker stopped."""
    slam = SlamSystem(SystemConfig(device=device, **kw))
    slam.shutdown()
    return slam


def _kb8(cfg):
    """The same config with the TUM-VI 512x512 fisheye lens."""
    return dataclasses.replace(cfg, **kb8_kw())


def _kb8_session(cfg, sensor):
    return _session(cfg.device, sensor=sensor, tracker=_kb8(cfg),
                    stereo_t_rl=(-0.1, 0.0, 0.0))


def _dbow2(tmp_path):
    path = tmp_path / "voc.txt"
    with open(path, "w") as f:
        f.write("2 1 0 0\n")
        for w in (0.5, 0.7):
            f.write("0 1 " + " ".join(["0"] * 32) + f" {w}\n")
    return path


STEREO_INERTIAL_YAML = """%YAML:1.0
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.bf: 50.45
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
"""


def _euroc_driver(device, tmp_path, sensor="mono"):
    """run_euroc.build_system: the EuRoC defaults, or a stereo-inertial
    YAML."""
    settings = None
    if sensor != "mono":
        settings = tmp_path / "si.yaml"
        settings.write_text(STEREO_INERTIAL_YAML)
    return run_euroc.build_system(argparse.Namespace(
        settings=settings and str(settings), sensor=sensor, vocabulary=None,
        device=device))


def _kitti_driver(device, tmp_path):
    """run_kitti.build_system from a one-frame sequence's calib.txt."""
    os.makedirs(tmp_path / "image_0", exist_ok=True)
    png.write_png(tmp_path / "image_0" / "000000.png",
                  np.zeros((48, 64), np.uint8))
    (tmp_path / "times.txt").write_text("0.0\n")
    (tmp_path / "calib.txt").write_text(
        "P0: 400 0 32 0 0 400 24 0 0 0 1 0\n")
    return run_kitti.build_system(load_kitti(str(tmp_path)), argparse.Namespace(
        settings=None, sensor="mono", device=device))


def _mesh(device):
    """make_ba_mesh() takes every visible card; on the CPU, CPU shards."""
    mesh = make_ba_mesh() if device == "cuda" else make_ba_mesh([device] * 2)
    return torch.zeros(1, device=mesh.devices[0])


def _worker_device(device):
    """The multi-process worker's device: its --device default, or cpu."""
    argv = ["0", "1", "0"] + ([] if device == "cuda" else ["--device", device])
    args = multihost_worker.parse_args(argv)
    return torch.zeros(1, device=multihost_worker.rank_device(args.device, 0))


BUILDS = {
    "make_ba_mesh": lambda cfg, tmp: _mesh(cfg.device),
    "multihost_worker": lambda cfg, tmp: _worker_device(cfg.device),
    "SlamSystem(ba_devices=2)": lambda cfg, tmp: _session(cfg.device,
                                                         ba_devices=2),
    "run_euroc.build_system": lambda cfg, tmp: _euroc_driver(cfg.device, tmp),
    "run_euroc.build_system(stereo-inertial)": lambda cfg, tmp: _euroc_driver(
        cfg.device, tmp, "stereo-inertial"),
    "run_kitti.build_system": lambda cfg, tmp: _kitti_driver(cfg.device, tmp),
    "SlamSystem.upload_image": lambda cfg, tmp: _session(
        cfg.device).upload_image(np.zeros((4, 4), np.uint8)),
    "Frame": lambda cfg, tmp: Frame(frame_id=0, timestamp=0.0, n_kp=4,
                                    device=cfg.device),
    "MonoTracker": lambda cfg, tmp: MonoTracker(cfg, _map()),
    "StereoTracker": lambda cfg, tmp: StereoTracker(cfg, _map()),
    "AsyncMapping": lambda cfg, tmp: _stopped_worker(cfg.device),
    "SlamSystem(stereo)": lambda cfg, tmp: _session(cfg.device, sensor="stereo"),
    "SlamSystem(rgbd)": lambda cfg, tmp: _session(cfg.device, sensor="rgbd"),
    "SlamSystem(async)": lambda cfg, tmp: _session(cfg.device,
                                                  async_mapping=True),
    "InertialTracker": lambda cfg, tmp: InertialTracker(cfg, _map()),
    "StereoInertialTracker": lambda cfg, tmp: StereoInertialTracker(cfg, _map()),
    "RgbdInertialTracker": lambda cfg, tmp: RgbdInertialTracker(cfg, _map()),
    "ImuCalib": lambda cfg, tmp: ImuCalib.make(device=cfg.device),
    "SlamSystem(mono-inertial)": lambda cfg, tmp: _session(
        cfg.device, sensor="mono-inertial"),
    "SlamSystem(stereo-inertial)": lambda cfg, tmp: _session(
        cfg.device, sensor="stereo-inertial"),
    "SlamSystem(rgbd-inertial)": lambda cfg, tmp: _session(
        cfg.device, sensor="rgbd-inertial"),
    "TrackerConfig(kb8)": lambda cfg, tmp: _kb8(cfg).ideal_params,
    "make_kb8": lambda cfg, tmp: cameras.make_kb8(
        *KB8, device=cfg.device).params,
    "FisheyeStereoTracker": lambda cfg, tmp: FisheyeStereoTracker(
        _kb8(cfg), _map()),
    "FisheyeStereoInertialTracker": lambda cfg, tmp:
        FisheyeStereoInertialTracker(_kb8(cfg), _map()),
    "SlamSystem(kb8 mono)": lambda cfg, tmp: _kb8_session(cfg, "mono"),
    "SlamSystem(kb8 stereo)": lambda cfg, tmp: _kb8_session(cfg, "stereo"),
    "SlamSystem(kb8 stereo-inertial)": lambda cfg, tmp: _kb8_session(
        cfg, "stereo-inertial"),
    "LocalMapper": lambda cfg, tmp: LocalMapper(cfg=cfg, map=_map()),
    "LoopCloser": lambda cfg, tmp: LoopCloser(cfg=cfg, map=_map(), db=_db()),
    "MapMerger": lambda cfg, tmp: MapMerger(cfg=cfg),
    "global_bundle_adjustment": lambda cfg, tmp: global_bundle_adjustment(
        cfg, _map()),
    "train_vocabulary": lambda cfg, tmp: voc_mod.train_vocabulary(
        DESC, k=2, L=2, device=cfg.device),
    "load_vocabulary": lambda cfg, tmp: voc_mod.load_vocabulary(
        _saved(tmp), device=cfg.device),
    "load_dbow2_text": lambda cfg, tmp: voc_mod.load_dbow2_text(
        _dbow2(tmp), device=cfg.device),
    "vocabulary_from_arrays": lambda cfg, tmp: voc_mod.vocabulary_from_arrays(
        voc_mod.vocabulary_arrays(voc_mod.train_vocabulary(
            DESC, k=2, L=2, device="cpu")), device=cfg.device),
    "vocabulary_from_numpy": lambda cfg, tmp: convert.vocabulary_from_numpy(
        voc_mod.vocabulary_arrays(voc_mod.train_vocabulary(
            DESC, k=2, L=2, device="cpu")), device=cfg.device),
}


def test_tracker_config_defaults_to_the_card():
    assert TrackerConfig().device == "cuda"
    assert inspect.signature(Frame).parameters["device"].default == "cuda"
    assert inspect.signature(AsyncMapping).parameters["device"].default == "cuda"
    assert inspect.signature(ImuCalib.make).parameters["device"].default == "cuda"
    for fn in (cameras.make_kb8, cameras.make_pinhole):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (voc_mod.train_vocabulary, voc_mod.load_vocabulary,
               voc_mod.load_dbow2_text, voc_mod.vocabulary_from_arrays,
               convert.vocabulary_from_numpy):
        assert fn.__defaults__[-1] == "cuda", fn.__name__


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_default_device_raises_without_a_card(name, tmp_path):
    """Built from TrackerConfig() (device "cuda"): RuntimeError naming CUDA,
    never a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BUILDS[name](TrackerConfig(), tmp_path)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_cpu_when_asked(name, tmp_path):
    """The same calls with device="cpu" run, on the CPU."""
    out = BUILDS[name](TrackerConfig(device="cpu"), tmp_path)
    dev = getattr(out, "device", torch.device("cpu"))
    assert torch.device(dev).type == "cpu"
