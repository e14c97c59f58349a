"""The port's Atlas at the session level against the JAX reference, on the
CPU: ``SlamSystem._try_merge`` -> ``_apply_merge`` (synchronous and as the
background worker's "merge" event), the Atlas checkpoint (``save_atlas`` /
``load_atlas``, across the two packages in both directions), the
vocabulary's checksum binding, spawning a new map on a sustained loss, and
map-table growth.  Under ``-m slow``: the blackout session of
``tests/test_atlas_merge_e2e.py`` through both packages, and the pipeline
under tiny table caps on the port."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.bow import KeyframeDatabase as JDatabase
from orb_slam3_study_kr_tpu.bow.vocabulary import train_vocabulary as j_train
from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.frame import Frame as JFrame
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackState as JTrackState
from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase as TDatabase
from orb_slam3_study_kr_tpu_torch.bow import vocabulary as tvoc
from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.ops import orb
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig, TrackState
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState

from test_map_merging import _build_pair
from test_torch_map_merging import _JaxUniforms

torch.set_num_threads(2)

KF = 2          # the active map's keyframe that closes the merge


def _install(m, src):
    """Replace a map's tables with copies of another MapState's."""
    for k, v in vars(src).items():
        if isinstance(v, np.ndarray):
            setattr(m, k, v.copy())
        elif isinstance(v, (bool, int, float)) and k != "map_id":
            setattr(m, k, v)


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _two_maps(pkg, sensor="mono", async_mapping=False, sigma=0.7):
    """A session of package pkg with a stored map B (``_build_pair``'s
    target gauge, with a vocabulary and its recognition index) and an
    active map A (the other gauge) tracking at keyframe KF: a last frame
    bound like KF and re-anchored on it, a velocity, a speed history and
    trajectory rows on both maps."""
    _, jA, jB, *_ = _build_pair(np.random.default_rng(0), sigma=sigma)
    descs = jB.kf_desc[jB.kf_valid][jB.kf_kp_valid[jB.kf_valid]]
    if pkg == "jax":
        slam = JSlamSystem(JSystemConfig(sensor=sensor, async_mapping=async_mapping,
                                         tracker=JTrackerConfig(fps=10)))
        voc = j_train(jnp.asarray(descs), k=4, L=2, seed=0)
        db_cls, frame_kw, state = JDatabase, {}, JTrackState.OK
    else:
        slam = SlamSystem(SystemConfig(sensor=sensor, async_mapping=async_mapping,
                                       tracker=TrackerConfig(fps=10),
                                       device="cpu"),
                          merge_uniforms_fn=_JaxUniforms(23))
        voc = tvoc.train_vocabulary(descs, k=4, L=2, seed=0, device="cpu")
        db_cls, frame_kw, state = TDatabase, dict(device="cpu"), TrackState.OK
    mB = slam.atlas.active_map
    _install(mB, jB)
    slam.voc, slam.db = voc, db_cls(voc)
    slam.map_dbs[mB.map_id] = slam.db
    for k in np.nonzero(mB.kf_valid)[0]:
        slam.db.add(int(k), mB.kf_desc[k], mB.kf_kp_valid[k])
    slam.cfg.min_kf_spawn = 1
    slam._on_tracking_lost()          # stores B, spawns the active map
    mA = slam.atlas.active_map
    _install(mA, jA)
    tr = slam.tracker
    tr.state = state
    tr.ref_kf = KF
    lf = (JFrame if pkg == "jax" else Frame)(
        frame_id=7, timestamp=7.0, uv=mA.kf_kp_uv[KF].copy(),
        level=mA.kf_kp_level[KF].copy(), angle=mA.kf_kp_angle[KF].copy(),
        response=np.zeros(mA.max_kp, np.float32), desc=mA.kf_desc[KF].copy(),
        valid=mA.kf_kp_valid[KF].copy(), **frame_kw)
    lf.kp_lm = mA.kf_kp_lm[KF].copy()
    lf.rel_ref, lf.rel_R = KF, _rot(0.01)
    lf.rel_t = np.array([0.02, 0.0, 0.01], np.float32)
    lf.R_cw = (lf.rel_R @ mA.kf_R[KF]).astype(np.float32)
    lf.t_cw = (lf.rel_R @ mA.kf_t[KF] + lf.rel_t).astype(np.float32)
    lf.pose_ok, lf.ref_kf = True, KF
    tr.last_frame = lf
    tr.velocity = (_rot(0.005), np.array([0.03, 0.0, 0.01], np.float32))
    tr._speed_hist = [0.05, 0.06, 0.04]
    tr.trajectory = [
        (0.0, 1, _rot(0.0), np.array([0.1, 0, 0], np.float32), state, True, mB),
        (5.0, 0, _rot(0.02), np.array([0.0, 0.1, 0], np.float32), state, True, mA),
        (6.0, KF, _rot(0.01), np.array([0.01, 0, 0], np.float32), state, True, mA)]
    return slam


def _session_record(slam, maps_before):
    tr, lf = slam.tracker, slam.tracker.last_frame
    return dict(
        n_maps=len(slam.atlas.maps),
        active=maps_before.index(slam.atlas.active_map),
        ref_kf=tr.ref_kf, lf_kp_lm=lf.kp_lm.copy(), lf_ref_kf=lf.ref_kf,
        lf_R=np.array(lf.R_cw), lf_t=np.array(lf.t_cw), rel_ref=lf.rel_ref,
        vel_R=np.array(tr.velocity[0]), vel_t=np.array(tr.velocity[1]),
        speed=np.array(tr._speed_hist),
        rows=[(ts, int(ref), np.array(R), np.array(t), st.name, ok,
               maps_before.index(m))
              for ts, ref, R, t, st, ok, m in tr.trajectory],
        n_welding_ba=slam.local_mapper.stats.get("n_welding_ba", 0),
        n_ba=slam.local_mapper.stats["n_ba"], n_db=len(slam.db.vectors),
        merger=dict(slam.merger.stats))


def _merge_both(sensor="mono"):
    out = {}
    for pkg in ("jax", "torch"):
        slam = _two_maps(pkg, sensor=sensor)
        before = list(slam.atlas.maps)
        assert slam._try_merge(KF)
        out[pkg] = (slam, _session_record(slam, before))
    return out


def test_try_merge_applies_like_reference():
    """_try_merge -> _apply_merge in both packages from the same two maps
    and tracker state: one map left (the stored one, active), the same
    reference keyframe, the last frame's bindings and pose, trajectory rows,
    sigma-scaled velocity and speed history, one welding BA, and the
    welded tables within 1e-3 of the reference."""
    out = _merge_both()
    (js, j), (ts, t) = out["jax"], out["torch"]
    assert j["n_maps"] == t["n_maps"] == 1 and j["active"] == t["active"] == 0
    for k in ("ref_kf", "lf_ref_kf", "n_welding_ba", "n_ba", "n_db", "merger"):
        assert t[k] == j[k], k
    assert t["n_welding_ba"] == 1 and t["merger"]["n_merged"] == 1
    np.testing.assert_array_equal(t["lf_kp_lm"], j["lf_kp_lm"])
    for k in ("lf_R", "lf_t", "vel_R", "vel_t"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(t["speed"], j["speed"], rtol=2.5e-3)
    assert len(t["rows"]) == len(j["rows"]) == 3
    for rt, rj in zip(t["rows"], j["rows"]):
        assert (rt[0], rt[1], rt[4], rt[5], rt[6]) == (rj[0], rj[1], rj[4],
                                                        rj[5], rj[6])
        np.testing.assert_allclose(rt[2], rj[2], atol=1e-6)
        np.testing.assert_allclose(rt[3], rj[3], atol=1e-4)
    mt, mj = ts.atlas.active_map, js.atlas.active_map
    assert ts.tracker.map is mt and ts.local_mapper.map is mt
    assert ts.loop_closer.map is mt
    for f in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(getattr(mt, f), getattr(mj, f), atol=1e-3,
                                   err_msg=f)
    for f in ("kf_valid", "lm_valid", "kf_kp_lm"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), err_msg=f)
    np.testing.assert_array_equal(ts.trajectory()[:, 0], js.trajectory()[:, 0])
    np.testing.assert_allclose(ts.trajectory()[:, 1:4],
                               js.trajectory()[:, 1:4], atol=1e-3)


def test_last_frame_rel_ref_after_merge_as_reference():
    """A reference behaviour the port keeps (ROADMAP §3): _apply_merge
    leaves the last frame's rel_ref, an id of the absorbed map, and the
    tracker's change-index cache does not know the map, so the next
    _update_last_frame resolves that id in the merged map.  Both packages
    give the same re-anchored pose, the relative pose composed with the
    merged map's keyframe of that id."""
    poses = {}
    for pkg, (slam, rec) in _merge_both().items():
        tr = slam.tracker
        assert rec["rel_ref"] == KF
        tr._last_change_idx = -1
        tr._update_last_frame()
        m = tr.map
        lf = tr.last_frame
        np.testing.assert_allclose(lf.R_cw, lf.rel_R @ m.kf_R[KF], atol=1e-5)
        np.testing.assert_allclose(lf.t_cw, lf.rel_R @ m.kf_t[KF] + lf.rel_t,
                                   atol=1e-5)
        poses[pkg] = (np.array(lf.R_cw), np.array(lf.t_cw))
    for a, b in zip(poses["torch"], poses["jax"]):
        np.testing.assert_allclose(a, b, atol=1e-3)


def _fix_scales(pkg, async_mapping):
    """The fix_scale of every merge verification in a two-map stereo
    session, synchronous or through the worker's "merge" event."""
    slam = _two_maps(pkg, sensor="stereo", async_mapping=async_mapping,
                     sigma=1.0)
    if slam.merger is None:
        from orb_slam3_study_kr_tpu.pipeline.map_merging import MapMerger
        slam.merger = MapMerger(cfg=slam.cfg.tracker)
    seen = []
    verify = slam.merger.verify

    def recording(*a, fix_scale=False):
        seen.append(bool(fix_scale))
        return verify(*a, fix_scale=fix_scale)

    slam.merger.verify = recording
    try:
        if async_mapping:
            slam.async_map.submit(lambda: slam._on_keyframe_for_loops(KF))
            slam.flush()
        else:
            assert slam._try_merge(KF)
        return seen, len(slam.atlas.maps), slam.sys_stats.get("n_stale_merges", 0)
    finally:
        slam.shutdown()


@pytest.mark.parametrize("async_mapping", [False, True], ids=["sync", "async"])
def test_merge_fix_scale_as_reference(async_mapping):
    """A reference behaviour the port keeps (ROADMAP §3): a stereo session
    verifies a merge with a fixed scale on the synchronous path (sensor !=
    "mono") but re-verifies the worker's merge with a free scale (fixed
    only for two IMU-initialized maps).  Both packages record the same
    fix_scale sequence and weld the maps."""
    j, t = _fix_scales("jax", async_mapping), _fix_scales("torch", async_mapping)
    assert t == j
    assert t[0] == ([True, False] if async_mapping else [True])
    assert t[1] == 1 and t[2] == 0


def test_async_merge_event():
    """A two-map session with the worker: the worker's loop callback
    verifies and posts "merge"; after flush() the maps are one (or the
    re-verify dropped it as stale), the merge was applied on the tracker's
    thread, and the worker raised nothing."""
    slam = _two_maps("torch", async_mapping=True)
    posted, applied_on = [], []
    post = slam.async_map.post_event
    slam.async_map.post_event = lambda kind, payload=None: (
        posted.append(kind), post(kind, payload))
    apply = slam._apply_merge
    slam._apply_merge = lambda *a: (
        applied_on.append(threading.current_thread()), apply(*a))[1]
    try:
        slam.async_map.submit(lambda: slam._on_keyframe_for_loops(KF))
        slam.flush()
        assert "merge" in posted
        stale = slam.sys_stats.get("n_stale_merges", 0)
        assert (len(slam.atlas.maps) == 1) != (stale == 1)
        assert slam.merger.stats["n_attempts"] == 2
        assert slam.async_map.stats["n_errors"] == 0
        if stale == 0:
            assert slam.tracker.velocity is None
            assert slam.local_mapper.stats["n_welding_ba"] == 1
            assert applied_on == [threading.main_thread()]
    finally:
        slam.shutdown()


# ----------------------------------------------------------------------
# Atlas checkpoints, on test_system_features.py's scene.

N_SESSION = 26


@pytest.fixture(scope="module")
def session():
    rng = np.random.default_rng(4)
    world = synthetic.make_textured_world(np.random.default_rng(8), depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(N_SESSION, x_span=1.2,
                                              z_span=0.0, y_amp=0.0)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), device="cpu"))
    for i in range(N_SESSION):
        img = synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
        slam.track_monocular(img, i * 0.1)
    assert slam.state == TrackState.OK and slam.voc is not None
    slam.loop_closer.loop_edges = [(5, 1), (7, 2)]
    return slam, world, R_gt, t_gt


def _frame(slam, world, R, t, seed):
    img = synthetic.render_textured(world, R, t, rng=np.random.default_rng(seed))
    feats = orb.extract_orb(torch.as_tensor(img), slam.cfg.tracker.orb_config)
    return Frame(frame_id=999, timestamp=99.0, device="cpu",
                 **{k: getattr(feats, k).numpy().copy()
                    for k in ("uv", "level", "angle", "response", "desc",
                              "valid")})


def _assert_atlas_equal(a, b):
    assert len(a.atlas.maps) == len(b.atlas.maps)
    assert a.atlas.active == b.atlas.active
    for ma, mb in zip(a.atlas.maps, b.atlas.maps):
        for f in SlamSystem.ATLAS_ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f),
                                          err_msg=f)
        for f in ("n_kf", "n_lm", "next_lm", "next_kf", "change_idx",
                  "map_id", "imu_initialized", "imu_ba2"):
            assert getattr(ma, f) == getattr(mb, f), f


def test_atlas_roundtrip_and_reloc(tmp_path, session):
    """Port -> port: identical tables, the vocabulary's checksum, the loop
    edges, state RECENTLY_LOST, and a fresh view relocalizes against the
    loaded map (tests/test_system_features.py's walls)."""
    slam, world, R_gt, t_gt = session
    p = tmp_path / "session.npz"
    slam.save_atlas(p)
    slam2 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), device="cpu"))
    slam2.load_atlas(p)
    _assert_atlas_equal(slam, slam2)
    assert (tvoc.vocabulary_checksum(slam2.voc)
            == tvoc.vocabulary_checksum(slam.voc))
    assert slam2.loop_closer.loop_edges == [(5, 1), (7, 2)]
    assert slam2.state == TrackState.RECENTLY_LOST
    m2 = slam2.atlas.active_map
    assert slam2.tracker.ref_kf == int(np.nonzero(m2.kf_valid)[0][-1])
    assert len(slam2.db.vectors) == m2.n_kf
    assert slam2._relocalize(_frame(slam2, world, R_gt[6], t_gt[6], 123))


def test_atlas_crosses_packages(tmp_path, session):
    """Port save_atlas -> JAX load_atlas, then JAX save_atlas -> port
    load_atlas: every array identical at each step, the same vocabulary
    checksum and loop edges."""
    from orb_slam3_study_kr_tpu.bow.vocabulary import vocabulary_checksum as jsum
    slam, *_ = session
    p_port, p_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    slam.save_atlas(p_port)
    js = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10)))
    js.load_atlas(p_port)
    _assert_atlas_equal(slam, js)
    assert jsum(js.voc) == tvoc.vocabulary_checksum(slam.voc)
    assert js.loop_closer.loop_edges == [(5, 1), (7, 2)]
    js.save_atlas(p_jax)
    a, b = np.load(p_port), np.load(p_jax)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    slam2 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), device="cpu"))
    slam2.load_atlas(p_jax)
    _assert_atlas_equal(slam, slam2)
    assert tvoc.vocabulary_checksum(slam2.voc) == jsum(js.voc)


def test_vocabulary_checksum_binding(tmp_path, session):
    """tests/test_serialization.py's binding on the port: loading against a
    vocabulary file with other content raises; without a configured file
    the checkpoint's own copy loads; a tampered copy is refused."""
    slam, *_ = session
    path = tmp_path / "session.npz"
    slam.save_atlas(path)
    descs = (np.random.default_rng(0).random((600, 256)) < 0.5).astype(np.uint8)
    other = tmp_path / "other_voc.npz"
    tvoc.save_vocabulary(tvoc.train_vocabulary(descs[::-1].copy(), k=4, L=2,
                                               seed=7, device="cpu"), other)
    cfg = dict(tracker=TrackerConfig(fps=10), device="cpu")
    slam2 = SlamSystem(SystemConfig(vocabulary_path=str(other), **cfg))
    with pytest.raises(ValueError, match="checksum"):
        slam2.load_atlas(path)
    slam3 = SlamSystem(SystemConfig(**cfg))
    slam3.load_atlas(path)
    assert (tvoc.vocabulary_checksum(slam3.voc)
            == tvoc.vocabulary_checksum(slam.voc))
    data = dict(np.load(path))
    data["voc/md5"] = np.frombuffer(b"0" * 32, np.uint8)
    bad = tmp_path / "tampered.npz"
    np.savez_compressed(bad, **data)
    with pytest.raises(ValueError, match="corrupt"):
        SlamSystem(SystemConfig(**cfg)).load_atlas(bad)


def test_lost_spawns_new_map(tmp_path, session):
    """tests/test_system_features.py's spawn on the port: the loaded
    session (relocalizing) is blinded past its loss deadline, which stores
    the established map and spawns a fresh one."""
    slam, *_ = session
    p = tmp_path / "session.npz"
    slam.save_atlas(p)
    slam2 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=4), device="cpu"))
    slam2.load_atlas(p)
    kfs_before = slam2.stats()["n_kf"]
    assert kfs_before >= 10
    blank = np.full((480, 752), 80.0, np.float32)
    for j in range(8):
        slam2.track_monocular(blank, 10.0 + j * 0.1)
    assert len(slam2.atlas.maps) == 2, slam2.stats()
    assert slam2.state in (TrackState.NOT_INITIALIZED, TrackState.LOST)
    assert int(slam2.atlas.maps[0].kf_valid.sum()) == kfs_before


def _add_kf(m, i, n_kp=16):
    return m.add_keyframe(
        np.eye(3, dtype=np.float32), np.asarray([0.01 * i, 0, 0], np.float32),
        np.random.default_rng(i).uniform(0, 100, (n_kp, 2)).astype(np.float32),
        np.zeros(n_kp, np.int32), np.zeros(n_kp, np.float32),
        np.ones(n_kp, bool), np.zeros((n_kp, 256), np.uint8), i, float(i))


def test_long_session_growth_with_culling():
    """tests/test_map_growth.py's unbounded session on the port's MapState:
    600 keyframes with culling never raise, ids stay monotonic, redirects
    resolve after growth."""
    rng = np.random.default_rng(0)
    m = MapState(max_kf=4, max_kp=16, max_lm=32)
    kfs = []
    for i in range(600):
        kf = _add_kf(m, i)
        kfs.append(kf)
        ids = m.add_landmarks(rng.uniform(-1, 1, (8, 3)).astype(np.float32),
                              np.zeros((8, 256), np.uint8), kf)
        m.bind(kf, np.arange(8), ids)
        if i % 3 == 2 and len(kfs) > 4:
            victim = kfs[-3]
            if m.kf_valid[victim]:
                m.cull_keyframe(victim, kfs[-1])
        if i % 5 == 4:
            lms = np.nonzero(m.lm_valid)[0]
            m.remove_landmarks(lms[: lms.size // 3])
    assert m.next_kf == 600
    assert m.max_kf >= 600 and m.max_lm >= m.next_lm
    assert m.kf_frame_id[kfs[100]] == 100
    culled = np.nonzero(~m.kf_valid[: m.next_kf]
                        & (m.kf_redirect[: m.next_kf] >= 0))[0]
    assert culled.size > 0
    ref, _, _ = m.resolve_kf(int(culled[-1]), np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32))
    assert ref >= 0 and m.kf_valid[ref]


# ----------------------------------------------------------------------
def _blackout(pkg, async_mapping=False):
    """tests/test_atlas_merge_e2e.py's session: 26 frames, 14 frames of
    noise, the 26 frames again; the merge wall and the scaled ATE over both
    segments.  The port gets the reference's Sim3 draws for the loop
    closers (one stream for all of them) and the merger.  With the worker
    on, the merge comes through its "merge" event; the threads that
    applied merges are recorded."""
    rng = np.random.default_rng(3)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n_seg, blackout = 26, 14
    R_gt, t_gt = synthetic.lateral_trajectory(n_seg, x_span=1.0, z_span=0.0,
                                              y_amp=0.0)
    kw = dict(vocab_min_kfs=4, min_kf_spawn=6, async_mapping=async_mapping)
    if pkg == "jax":
        slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=10), **kw))
    else:
        slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                       device="cpu", **kw),
                          loop_uniforms_fn=_JaxUniforms(17),
                          merge_uniforms_fn=_JaxUniforms(23))
    applied_on = []
    apply = slam._apply_merge
    slam._apply_merge = lambda *a: (
        applied_on.append(threading.current_thread().name), apply(*a))[1]
    ts, merged, n_maps_max, n_kf_1 = 0.0, False, 1, 0
    for seg in ("first", "blackout", "revisit"):
        for i in range(blackout if seg == "blackout" else n_seg):
            img = (rng.uniform(0, 8, (480, 752)).astype(np.float32)
                   if seg == "blackout"
                   else synthetic.render_textured(world, R_gt[i], t_gt[i],
                                                  rng=rng))
            slam.track_monocular(img, ts)
            ts += 0.1
            n_maps_max = max(n_maps_max, len(slam.atlas.maps))
            merged |= seg == "revisit" and len(slam.atlas.maps) == 1
        if seg == "first":
            n_kf_1 = slam.atlas.active_map.n_kf
    if async_mapping:
        slam.flush()
        merged |= len(slam.atlas.maps) == 1
    rows = slam.trajectory()
    if async_mapping:
        slam.shutdown()
    gt_ts = np.concatenate([np.arange(n_seg) * 0.1,
                            (n_seg + blackout) * 0.1 + np.arange(n_seg) * 0.1])
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], gt_ts,
                           np.concatenate([centers, centers]), with_scale=True)
    return dict(merged=merged, n_maps_max=n_maps_max, n_kf_1=n_kf_1,
                n_kf=slam.atlas.active_map.n_kf, ate=float(rmse), nm=nm,
                merger=dict(slam.merger.stats) if slam.merger else None,
                applied_on=applied_on)


@pytest.mark.slow
@pytest.mark.parametrize("async_mapping", [False, True], ids=["sync", "async"])
def test_blackout_merge_both_packages(async_mapping):
    """Both packages: a second map is spawned in the blackout and welded
    back on the revisit (one map at the end, keeping both segments'
    keyframes), and the post-merge scaled ATE over both segments is
    < 0.25 in each; both values are printed.  With the worker on, each
    merge was applied on the tracker's thread."""
    out = {pkg: _blackout(pkg, async_mapping) for pkg in ("jax", "torch")}
    print("blackout", out)
    for pkg, r in out.items():
        assert r["n_maps_max"] >= 2 and r["merged"], (pkg, r)
        assert r["n_kf"] > r["n_kf_1"], (pkg, r)
        assert r["nm"] > 25 and r["ate"] < 0.25, (pkg, r)
        assert set(r["applied_on"]) == {threading.main_thread().name}, (pkg, r)


@pytest.mark.slow
def test_pipeline_growth_under_tiny_caps():
    """tests/test_map_growth.py's session on the port, started with tables
    of 3 keyframes and 400 landmarks: they grow and tracking stays alive."""
    rng = np.random.default_rng(9)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n = 24
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=0.9, z_span=0.0,
                                              y_amp=0.0)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), max_kf=3,
                                   max_lm=400, device="cpu"))
    for i in range(n):
        slam.track_monocular(synthetic.render_textured(world, R_gt[i], t_gt[i],
                                                       rng=rng), i * 0.1)
    m = slam.atlas.active_map
    assert m.max_kf > 3 and m.max_lm > 400, "tables never grew"
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
    assert slam.stats()["n_kf"] >= 4
