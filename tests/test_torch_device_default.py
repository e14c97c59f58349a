"""The port runs on the card unless the caller asks for the CPU: every
object (a Frame too) and vocabulary entry point built with the default
device raises without a card, and the same calls with device="cpu" run."""

import inspect

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase
from orb_slam3_study_kr_tpu_torch.bow import vocabulary as voc_mod
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.global_ba import global_bundle_adjustment
from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import MonoTracker, TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState

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


def _dbow2(tmp_path):
    path = tmp_path / "voc.txt"
    with open(path, "w") as f:
        f.write("2 1 0 0\n")
        for w in (0.5, 0.7):
            f.write("0 1 " + " ".join(["0"] * 32) + f" {w}\n")
    return path


BUILDS = {
    "Frame": lambda cfg, tmp: Frame(frame_id=0, timestamp=0.0, n_kp=4,
                                    device=cfg.device),
    "MonoTracker": lambda cfg, tmp: MonoTracker(cfg, _map()),
    "LocalMapper": lambda cfg, tmp: LocalMapper(cfg=cfg, map=_map()),
    "LoopCloser": lambda cfg, tmp: LoopCloser(cfg=cfg, map=_map(), db=_db()),
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
