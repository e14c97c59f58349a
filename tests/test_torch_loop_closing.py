"""The loop-verification cascade of the torch port against the JAX
reference, on tests/test_loop_cascade.py's ring world (seed 11): cameras on
a circle looking out at a landmark cylinder, a first pass of N_FIRST
keyframes, then three drifted revisit keyframes bound to duplicate
landmarks.  The maps are built twice from the same seed (numpy only), one
per package; the reference's Sim3 RANSAC draws (PRNGKey(17) split per
cascade) are injected into the port.  Besides the monocular ring (a Sim3
drift), an inertial one (drift in rotation and translation at scale 1: the
fixed-scale Sim3 and the 4-DoF essential graph) and a stereo one (every
observation with its virtual right coordinate: the Sim3 loop of a stereo
map, the GBA with the stereo row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu import lie as jlie
from orb_slam3_study_kr_tpu.bow.database import KeyframeDatabase as JDatabase
from orb_slam3_study_kr_tpu.bow.vocabulary import train_vocabulary as j_train
from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser as JLoopCloser
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_study_kr_tpu_torch import convert
from orb_slam3_study_kr_tpu_torch.bow.database import KeyframeDatabase as TDatabase
from orb_slam3_study_kr_tpu_torch.bow.vocabulary import train_vocabulary as t_train
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState as TMapState

torch.set_num_threads(2)

JCFG = JTrackerConfig(fps=10)
TCFG = TrackerConfig(fps=10, device="cpu")
BF = JCFG.fx * 0.11                      # the stereo tests' baseline
N_FIRST = 18
R_CAM, R_LM, N_LM = 3.0, 9.0, 1200
SEED = 11
THETAS = [0.0, 2 * np.pi / N_FIRST, 4 * np.pi / N_FIRST]


def _ring_pose(theta):
    u = np.array([np.cos(theta), 0.0, np.sin(theta)])
    xh = np.array([-np.sin(theta), 0.0, np.cos(theta)])
    R_cw = np.stack([xh, [0.0, 1.0, 0.0], u]).astype(np.float32)
    c = (R_CAM * u).astype(np.float32)
    return R_cw, (-R_cw @ c).astype(np.float32)


def _project(R, t, X):
    p = X @ R.T + t
    z = p[:, 2]
    uv = np.stack([JCFG.fx * p[:, 0] / z + JCFG.cx,
                   JCFG.fy * p[:, 1] / z + JCFG.cy], -1)
    vis = ((z > 0.2) & (uv[:, 0] > 10) & (uv[:, 0] < JCFG.width - 10)
           & (uv[:, 1] > 10) & (uv[:, 1] < JCFG.height - 10))
    return uv.astype(np.float32), vis, z


# The revisits' drift per ring: the monocular one drifts in scale; an
# inertial map keeps its scale; a stereo map's scale drifts little.
DRIFT = {"mono": np.log(1.06), "inertial": 0.0, "stereo": np.log(1.02)}


def _drift(kind="mono"):
    R, t, s = jlie.exp_sim3(jnp.asarray(
        [0.0, 0.05, 0.0, 0.15, 0.05, -0.1, DRIFT[kind]], jnp.float32))
    return np.asarray(R), np.asarray(t), float(s)


def _build_ring(map_cls, drift, bf=0.0):
    """tests/test_loop_cascade.py's _build_ring with revisits, on map_cls;
    with ``bf`` every observation carries its virtual right coordinate
    u - bf / z.  Returns (map, dup_of, gt)."""
    rng = np.random.default_rng(SEED)
    phi = rng.uniform(0, 2 * np.pi, N_LM)
    y = rng.uniform(-1.5, 1.5, N_LM)
    X = np.stack([R_LM * np.cos(phi), y, R_LM * np.sin(phi)], -1).astype(np.float32)
    desc = rng.integers(0, 2, (N_LM, 256)).astype(np.uint8)
    m = map_cls(max_kf=32, max_kp=512, max_lm=4096)
    lm_ids = m.add_landmarks(X, desc, first_kf=0)
    gt = []

    def add_kf(R, t, R_gt=None, t_gt=None, bind_ids=None):
        Rg = R if R_gt is None else R_gt
        tg = t if t_gt is None else t_gt
        uv, vis, z = _project(Rg, tg, X)
        sel = np.nonzero(vis)[0][: m.max_kp]
        d = desc[sel].copy()
        for i in range(sel.size):
            d[i, rng.integers(0, 256, 6)] ^= 1
        tgt = lm_ids[sel] if bind_ids is None else bind_ids[sel]
        uv_obs = uv[sel] + rng.normal(0, 0.3, (sel.size, 2)).astype(np.float32)
        ur = (uv_obs[:, 0] - bf / z[sel]).astype(np.float32) if bf else None
        m.add_keyframe(
            R, t, uv_obs,
            np.zeros(sel.size, np.int32), np.zeros(sel.size, np.float32),
            np.ones(sel.size, bool), d, frame_id=m.next_kf,
            timestamp=float(m.next_kf), kp_lm=tgt, ur=ur)
        gt.append((Rg, tg))

    for k in range(N_FIRST):
        add_kf(*_ring_pose(2 * np.pi * k / N_FIRST))
    Rd, td, sd = drift
    X_est = (sd * X @ Rd.T + td).astype(np.float32)
    bind_ids = lm_ids.copy()
    vis_any = np.zeros(N_LM, bool)
    for th in THETAS:
        vis_any |= _project(*_ring_pose(th), X)[1]
    need = np.nonzero(vis_any)[0]
    dups = m.add_landmarks(X_est[need], desc[need], first_kf=N_FIRST)
    bind_ids[need] = dups
    dup_of = {int(lm_ids[j]): int(d) for j, d in zip(need, dups)}
    for th in THETAS:
        Rg, tg = _ring_pose(th)
        R_est = (Rg @ Rd.T).astype(np.float32)
        add_kf(R_est, (sd * tg - R_est @ td).astype(np.float32), R_gt=Rg,
               t_gt=tg, bind_ids=bind_ids)
    m.update_landmark_stats(np.nonzero(m.lm_valid)[0])
    return m, dup_of, gt


class _JaxUniforms:
    """The reference LoopCloser's Sim3 RANSAC draws: PRNGKey(17), one split
    per cascade that reaches stage 3."""

    def __init__(self, seed=17):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, iters, n):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.uniform(sub, (iters, n)))


def _make_rings(kind):
    drift = _drift(kind)
    bf = BF if kind == "stereo" else 0.0
    jm, _, _ = _build_ring(JMapState, drift, bf)
    tm, dup_of, gt = _build_ring(TMapState, drift, bf)
    for k, v in vars(jm).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(tm, k), v, err_msg=k)
    valid = np.nonzero(jm.kf_valid)[0]
    descs = jm.kf_desc[valid][jm.kf_kp_valid[valid]][:4000]
    return dict(kind=kind, drift=drift, bf=bf, jm=jm, tm=tm, dup_of=dup_of,
                gt=gt, jvoc=j_train(jnp.asarray(descs), k=8, L=3, seed=0),
                tvoc=t_train(descs, k=8, L=3, seed=0, device="cpu"),
                jcfg=JTrackerConfig(fps=10, bf=bf),
                tcfg=TrackerConfig(fps=10, bf=bf, device="cpu"))


@pytest.fixture(scope="module")
def rings():
    return _make_rings("mono")


@pytest.fixture(scope="module")
def rings_inertial():
    return _make_rings("inertial")


@pytest.fixture(scope="module")
def rings_stereo():
    return _make_rings("stereo")


def _rings_of(request, kind):
    return request.getfixturevalue(
        "rings" if kind == "mono" else f"rings_{kind}")


def _closers(r, jm=None, tm=None, n_db=N_FIRST, **kw):
    jm, tm = jm or r["jm"], tm or r["tm"]
    kw.setdefault("run_gba", False)
    kw.setdefault("inertial", r["kind"] == "inertial")
    jl = JLoopCloser(cfg=r["jcfg"], map=jm, db=JDatabase(voc=r["jvoc"]), **kw)
    tl = LoopCloser(cfg=r["tcfg"], map=tm, db=TDatabase(voc=r["tvoc"]),
                    uniforms_fn=_JaxUniforms(), **kw)
    for k in range(n_db):
        jl.db.add(k, jm.kf_desc[k, : jm.max_kp], jm.kf_kp_valid[k])
        tl.db.add(k, tm.kf_desc[k, : tm.max_kp], tm.kf_kp_valid[k])
    return jl, tl


def test_detect_candidates_identical(rings):
    jl, tl = _closers(rings)
    n_hit = 0
    for kf in range(N_FIRST, N_FIRST + 3):
        jc = jl._detect(kf)
        assert tl._detect(kf) == jc
        n_hit += len(jc) > 0
    assert n_hit == 3


def test_bow_window_match_identical(rings):
    """(kp1, lm2, window) identical: the K3 window route (plain version
    here) against the reference's vmap of match_by_descriptor."""
    jl, tl = _closers(rings)
    kf = N_FIRST
    for cand in jl._detect(kf):
        jk, jlm, jw = jl._bow_window_match(kf, int(cand))
        tk, tlm, tw = tl._bow_window_match(kf, int(cand))
        assert tw == jw and len(tw) > 1
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tlm, jlm)
    assert jk.size >= jl.min_bow_matches


def _assert_scw_close(a, b):
    """Scw = (R, t, s): the rigid part [R | t/s] (what the guided
    projections use) within 1e-3, the scale within 2.5e-3 relative.  The
    scale sits in a flat valley of OptimizeSim3's two-sided reprojection
    cost: on this problem the two packages' 20 float32 LM steps stop
    1.3e-3 apart in s (measured on CPU), from step decisions that flip on
    last-bit differences of the cost sums."""
    (Ra, ta, sa), (Rb, tb, sb) = a, b
    np.testing.assert_allclose(Ra, Rb, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ta) / sa, np.asarray(tb) / sb,
                               atol=1e-3)
    assert abs(sa / sb - 1.0) < 2.5e-3, (sa, sb)


@pytest.mark.parametrize("kind", ["mono", "inertial"])
def test_verify_cascade_matches_reference(request, kind):
    """One cascade (stages 2-5) for the first revisit keyframe and its best
    candidate, the reference's draws injected: the same stage counters and
    window, Scw close (see _assert_scw_close); an inertial map's Sim3 keeps
    scale 1 exactly in both."""
    jl, tl = _closers(_rings_of(request, kind))
    kf = N_FIRST
    cand = int(jl._detect(kf)[0])
    jh = jl._verify_cascade(kf, cand)
    th = tl._verify_cascade(kf, cand)
    assert jh is not None and th is not None
    assert tl.stats == jl.stats
    assert jl.stats["n_stage_proj"] == 1
    np.testing.assert_array_equal(th["window"], jh["window"])
    _assert_scw_close(th["Scw"], jh["Scw"])
    if kind == "inertial":
        assert th["Scw"][2] == jh["Scw"][2] == 1.0


def test_loop_state_carry_over(rings):
    """A pending detection carried over from the reference
    (convert.loop_closer_state_from_numpy) advances in the port as in the
    reference: the next keyframe confirms it with the same count."""
    jl, tl = _closers(rings, n_db=N_FIRST + 1)
    kf = N_FIRST
    cand = int(jl._detect(kf)[0])
    hit = jl._verify_cascade(kf, cand)
    jl._pending = dict(cand=cand, window=hit["window"], Scw=hit["Scw"],
                       last_kf=kf, count=1, not_found=0)
    convert.loop_closer_state_from_numpy(
        tl, loop_edges=[(3, 1)], pending=jl._pending, stats=jl.stats)
    jl.loop_edges = [(3, 1)]
    assert not jl._advance_pending(kf + 1)
    assert not tl._advance_pending(kf + 1)
    assert tl._pending["count"] == jl._pending["count"] == 2
    assert tl._pending["last_kf"] == jl._pending["last_kf"] == kf + 1
    assert tl.stats == jl.stats and tl.loop_edges == jl.loop_edges
    _assert_scw_close(tl._pending["Scw"], jl._pending["Scw"])


def _record_corrections(closer):
    """Wrap ``closer._correct`` to record the scale of every correction."""
    seen, correct = [], closer._correct

    def record(kf, cand, sim3):
        seen.append(float(sim3["s12"]))
        return correct(kf, cand, sim3)
    closer._correct = record
    return seen


@pytest.mark.parametrize("kind", [
    pytest.param("mono", marks=pytest.mark.slow), "inertial", "stereo"])
def test_cascade_sequence_matches_reference(request, kind):
    """The whole process_keyframe sequence in both packages (fresh maps,
    the reference's draws injected): both correct exactly once, at
    N_FIRST + 2, with equal stats; the revisit centres agree (within 1e-3;
    the stereo tests' 2e-3 on the stereo ring) and lie within 0.25 of the
    ground truth.  Monocular: the duplicates are welded.  Inertial (the
    fixed-scale Sim3, the 4-DoF graph, then the GBA): the correction's
    scale is exactly 1 in both.  Stereo (a Sim3, then the GBA with the
    stereo row): the same landmarks survive in both."""
    rings = _rings_of(request, kind)
    drift, bf = rings["drift"], rings["bf"]
    jm, _, _ = _build_ring(JMapState, drift, bf)
    tm, dup_of, gt = _build_ring(TMapState, drift, bf)
    jl, tl = _closers(rings, jm=jm, tm=tm, n_db=0, run_gba=kind != "mono")
    j_s, t_s = _record_corrections(jl), _record_corrections(tl)
    j_at = [kf for kf in range(jm.next_kf) if jl.process_keyframe(kf)]
    t_at = [kf for kf in range(tm.next_kf) if tl.process_keyframe(kf)]
    assert j_at == t_at == [N_FIRST + 2]
    assert tl.stats == jl.stats
    assert tl.loop_edges == jl.loop_edges
    for kf in range(N_FIRST, N_FIRST + 3):
        np.testing.assert_allclose(tm.kf_center(kf), jm.kf_center(kf),
                                   atol=2e-3 if kind == "stereo" else 1e-3)
        Rg, tg = gt[kf]
        assert np.linalg.norm(tm.kf_center(kf) + Rg.T @ tg) < 0.25
    dups = np.array(list(dup_of.values()))
    if kind == "mono":
        assert tm.lm_valid[dups].mean() < 0.5
        assert tl.stats["n_fused_loop"] > 50
    else:
        assert tl.stats["n_gba"] == jl.stats["n_gba"] == 1
        np.testing.assert_array_equal(tm.lm_valid, jm.lm_valid)
    if kind == "inertial":
        assert t_s == j_s == [1.0]
    else:
        assert abs(t_s[0] / j_s[0] - 1.0) < 2.5e-3
