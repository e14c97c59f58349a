"""Carry configuration and tracker state over from the reference package.

The SLAM system has no learned weights; what has to match between the
reference package and this port is configuration and state.  These helpers
take plain Python/numpy values (never objects of the reference package), so
this module imports neither package's JAX side:

- ``tracker_config_from_dict`` / ``system_config_from_dict`` build the
  port's configs from a dict of the reference configs' fields
  (``dataclasses.asdict`` of them).  A reference field the port does not
  have converts only at its reference default (``REFERENCE_ONLY``); any
  other value, and any key neither config knows, raises ValueError rather
  than giving a session that runs something else;
- ``tracker_state_from_numpy`` loads a map's numpy tables plus the
  tracker's host state into a port ``MonoTracker``, so that one frame can be
  tracked in both packages from the same state;
- ``vocabulary_from_numpy`` builds the port's vocabulary from the
  reference's ``vocabulary_arrays`` (the same checksum);
- ``loop_closer_state_from_numpy`` installs loop edges, a pending detection
  and the cascade's counters into a port ``LoopCloser``;
- ``imu_state_from_numpy`` installs an inertial tracker's IMU state (bias,
  stage, keyframe interval chain, raw log, carried prior) and the map's
  inertial tables into a port inertial tracker.

- ``session_map_from_numpy`` installs a reference map and its vocabulary
  into a port ``SlamSystem`` and rebuilds the keyframe database and the
  loop closer from them (the reference's atlas-restore path), so the port
  can relocalize against a map the reference built.
"""

import dataclasses

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.bow.vocabulary import vocabulary_from_arrays
from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import pack_desc_np
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.system import SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState


# Fields of the reference configs that the port's configs do not have, with
# the reference's default values (none at present: every field of the
# reference's TrackerConfig and SystemConfig is a field of the port's, and
# the port runs every value of each).
REFERENCE_ONLY = {
    "TrackerConfig": {},
    "SystemConfig": {},
}


def _plain(v):
    return tuple(_plain(x) for x in v) if isinstance(v, (list, tuple)) else v


def _port_kwargs(cls, d):
    """The entries of d that are fields of the port's ``cls``.  A
    reference-only field is dropped at its reference default; another value,
    or a key neither config has, raises ValueError."""
    names = {f.name for f in dataclasses.fields(cls)}
    ref_only = REFERENCE_ONLY[cls.__name__]
    kw = {}
    for k, v in d.items():
        if k in names:
            kw[k] = v
        elif k not in ref_only:
            raise ValueError(f"{cls.__name__}: unknown field {k!r}")
        elif _plain(v) != _plain(ref_only[k]):
            raise ValueError(
                f"{cls.__name__}.{k}={v!r}: the port has no such option; only "
                f"the reference default {ref_only[k]!r} converts")
    return kw


def tracker_config_from_dict(d, **overrides) -> TrackerConfig:
    """Port TrackerConfig from the reference TrackerConfig's fields."""
    kw = _port_kwargs(TrackerConfig, d)
    if "dist" in kw:
        kw["dist"] = tuple(kw["dist"])
    kw.update(overrides)
    return TrackerConfig(**kw)


def system_config_from_dict(d, device="cuda", **overrides) -> SystemConfig:
    """Port SystemConfig from the reference SystemConfig's fields (the
    nested ``tracker`` and ``tracker_right`` dicts included; the fisheye
    rig's extrinsic as tuples)."""
    kw = _port_kwargs(SystemConfig, {k: v for k, v in d.items()
                                     if k not in ("tracker", "tracker_right")})
    kw["tracker"] = tracker_config_from_dict(d.get("tracker", {}))
    if d.get("tracker_right") is not None:
        kw["tracker_right"] = tracker_config_from_dict(d["tracker_right"])
    for k in ("stereo_R_rl", "stereo_t_rl"):
        if kw.get(k) is not None:
            kw[k] = _plain(np.asarray(kw[k]).tolist())
    kw["device"] = device
    kw.update(overrides)
    return SystemConfig(**kw)


def _install_map_tables(m, map_tables):
    for k, v in map_tables.items():
        setattr(m, k, np.array(v) if isinstance(v, np.ndarray) else v)


def tracker_state_from_numpy(tracker, map_tables, last_frame, velocity,
                             ref_kf, speed_hist, state="OK", frame_count=None,
                             last_kf_frame_id=-1, fused_block=None,
                             last_change_idx=None):
    """Install reference state into a port tracker (in place).

    map_tables: {attribute: numpy array or scalar} of the map (MapState's
      kf_*/lm_* tables and counters such as n_kf, next_lm, change_idx).
    last_frame: dict with the last frame's host arrays (uv, uv_raw, level,
      angle, response, desc, valid, patch), kp_lm, R_cw, t_cw, frame_id,
      timestamp, ref_kf, pose_ok and optionally rel_ref/rel_R/rel_t and a
      fisheye stereo frame's stereo_pc (its left-camera points).
    velocity: (R, t) numpy pair or None; speed_hist: list of floats.
    fused_block: the cached fused-frame candidate block as numpy (cand,
      ref_kf, row_of, obs, change_idx, member_idx and the pos, desc, gid,
      patch, normal, min_d, max_d, mask_all rows), or None to rebuild it.
      The port caches the block's descriptors as K2's packed words.
    """
    m = tracker.map
    _install_map_tables(m, map_tables)
    lf = dict(last_frame)
    host = {k: np.array(lf.pop(k)) for k in
            ("uv", "uv_raw", "level", "angle", "response", "desc", "valid",
             "patch") if k in lf}
    frame = Frame(frame_id=lf["frame_id"], timestamp=lf["timestamp"],
                  kp_lm=np.array(lf["kp_lm"], np.int32),
                  R_cw=np.array(lf["R_cw"], np.float32),
                  t_cw=np.array(lf["t_cw"], np.float32),
                  ref_kf=int(lf.get("ref_kf", -1)),
                  pose_ok=bool(lf.get("pose_ok", True)),
                  device=tracker.device, **host)
    if lf.get("stereo_pc") is not None:
        frame.stereo_pc = np.array(lf["stereo_pc"], np.float32)
    if lf.get("rel_ref", -1) >= 0:
        frame.rel_ref = int(lf["rel_ref"])
        frame.rel_R = np.array(lf["rel_R"])
        frame.rel_t = np.array(lf["rel_t"])
    tracker.last_frame = frame
    tracker.velocity = (None if velocity is None else
                        (np.array(velocity[0]), np.array(velocity[1])))
    tracker.ref_kf = int(ref_kf)
    tracker._speed_hist = [float(s) for s in speed_hist]
    tracker.state = TrackState[state] if isinstance(state, str) else state
    tracker.frame_count = (frame.frame_id + 1 if frame_count is None
                           else int(frame_count))
    tracker.last_kf_frame_id = int(last_kf_frame_id)
    # The map change index the last frame was anchored at: the next frame
    # re-anchors the last frame's pose only when the map moved since.
    tracker._last_change_idx = (m.change_idx if last_change_idx is None
                                else int(last_change_idx))
    if fused_block is None:
        tracker._fblk = None
        return tracker
    blk = dict(fused_block)
    blk["desc_words"] = pack_desc_np(blk.pop("desc"))
    for k in ("pos", "desc_words", "gid", "patch", "normal", "min_d", "max_d",
              "mask_all"):
        blk[k] = torch.as_tensor(np.asarray(blk[k]), device=tracker.device)
    blk["cand"] = np.asarray(blk["cand"])
    blk["row_of"] = np.asarray(blk["row_of"])
    blk["obs"] = np.asarray(blk["obs"])
    blk["map_ref"] = m
    tracker._fblk = blk
    return tracker


def imu_state_from_numpy(tracker, bias, imu_stage, kf_imu, imu_log,
                         prior_info=None, prior_change_idx=-1, prev_kf_id=None,
                         first_kf_ts=None, last_glitch_ts=-1e9, kf_v=None,
                         kf_bias=None,
                         imu_initialized=None, imu_ba2=None, stats=None,
                         last_v_w=None, last_ok_ts=None):
    """Install a reference inertial tracker's IMU state into a port
    inertial tracker (in place), after ``tracker_state_from_numpy``.

    kf_imu: {kf: (prev_kf, rows (M, 7))}; imu_log: [(frame_ts, rows)];
    prior_info: (15, 15) or None with the map change index it was made at;
    kf_v, kf_bias,
    imu_initialized, imu_ba2: the map's inertial tables and flags; stats:
    tracker counters to copy (imu_init_scale and the like); last_v_w: the
    last frame's body velocity; last_ok_ts: the last OK frame's time."""
    tracker.bias = np.array(bias, np.float32)
    tracker.imu_stage = int(imu_stage)
    tracker.kf_imu = {int(k): (int(p), np.array(r, np.float32).reshape(-1, 7))
                      for k, (p, r) in kf_imu.items()}
    tracker._imu_log = [(float(t), np.array(r, np.float32).reshape(-1, 7))
                        for t, r in imu_log]
    tracker._prior_info = (None if prior_info is None
                           else np.array(prior_info, np.float32))
    tracker._prior_change_idx = int(prior_change_idx)
    tracker._prev_kf_id = None if prev_kf_id is None else int(prev_kf_id)
    tracker._first_kf_ts = None if first_kf_ts is None else float(first_kf_ts)
    tracker._last_glitch_ts = float(last_glitch_ts)
    m = tracker.map
    if kf_v is not None:
        m.kf_v = np.array(kf_v, np.float32)
    if kf_bias is not None:
        m.kf_bias = np.array(kf_bias, np.float32)
    if imu_initialized is not None:
        m.imu_initialized = bool(imu_initialized)
    if imu_ba2 is not None:
        m.imu_ba2 = bool(imu_ba2)
    if stats:
        tracker.stats.update(stats)
    if last_v_w is not None:
        tracker.last_frame.v_w = np.array(last_v_w, np.float32)
    if last_ok_ts is not None:
        tracker.last_ok_ts = float(last_ok_ts)
    return tracker


def vocabulary_from_numpy(arrays, device="cuda"):
    """Port vocabulary from the reference's ``vocabulary_arrays(voc)``
    dict (or an npz of it): same arrays, same checksum.  On the card by
    default (raises without one); pass ``device="cpu"`` for the CPU."""
    return vocabulary_from_arrays(arrays, device=device)


def loop_closer_state_from_numpy(loop_closer, loop_edges=(), pending=None,
                                 stats=None):
    """Install reference loop-closing state into a port LoopCloser (in
    place): accepted loop edges [(kf, cand), ...], the pending detection
    awaiting temporal consistency (dict with cand, window, Scw = (R, t, s),
    last_kf, count, not_found) and the cascade's counters."""
    loop_closer.loop_edges = [(int(a), int(b)) for a, b in loop_edges]
    if pending is None:
        loop_closer._pending = None
    else:
        R, t, s = pending["Scw"]
        loop_closer._pending = dict(
            cand=int(pending["cand"]),
            window=np.array(pending["window"], np.int32),
            Scw=(np.array(R, np.float32), np.array(t, np.float32), float(s)),
            last_kf=int(pending["last_kf"]), count=int(pending["count"]),
            not_found=int(pending["not_found"]))
    if stats is not None:
        loop_closer.stats.update({k: int(v) for k, v in stats.items()})
    return loop_closer


def session_map_from_numpy(slam, map_tables, vocabulary, ref_kf=None,
                           database=None):
    """Install a reference map (MapState tables as in
    ``tracker_state_from_numpy``) and its vocabulary (``vocabulary_arrays``
    of it) into a port SlamSystem (in place) and set the tracker to
    relocalize against the map (RECENTLY_LOST, reference keyframe ``ref_kf``
    or the newest one).  The keyframe database is rebuilt from the map's
    keyframes, or installed as given: ``database`` = dict(vectors={kf:
    (words, weights)}, inv_file={word: [kf, ...]}) of a live reference
    session (whose inverted file can list a keyframe twice)."""
    from orb_slam3_study_kr_tpu_torch.bow.database import KeyframeDatabase
    from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser

    m = slam.atlas.active_map
    _install_map_tables(m, map_tables)
    slam.voc = vocabulary_from_numpy(vocabulary, device=slam.device)
    slam.db = KeyframeDatabase(slam.voc)
    slam.map_dbs = {m.map_id: slam.db}
    slam.loop_closer = LoopCloser(cfg=slam.cfg.tracker, map=m, db=slam.db,
                                  ba_mesh=slam.ba_mesh)
    kfs = np.nonzero(m.kf_valid)[0]
    if database is None:
        for k in kfs:
            slam.db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])
    else:
        for k, (words, vals) in database["vectors"].items():
            slam.db.vectors[int(k)] = (np.array(words, np.int64),
                                       np.array(vals, np.float32))
        for w, lst in database["inv_file"].items():
            slam.db.inv_file[int(w)] = [int(k) for k in lst]
    tr = slam.tracker
    tr.ref_kf = int(kfs[-1] if ref_kf is None else ref_kf)
    tr.state = TrackState.RECENTLY_LOST
    return slam
