"""The hand-written CUDA kernels (K1 fast_nms_blur, K2 gated_nn, K3
hamming_nn) against their plain PyTorch versions on the card.  CUDA kernels have no CPU mode:
these tests skip where no card is present.  On a GPU machine run

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_matching
from orb_slam3_study_kr_tpu_torch.ops import orb, track_match
from orb_slam3_study_kr_tpu_torch.pipeline.map_merging import MapMerger
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(480, 752), (134, 210), (33, 47)])
def test_k1_kernel_matches_plain(dev, shape):
    """Score and NMS maps bit-exact (wrapping shifts in both); blur within
    1e-4 (same tap order, round-to-nearest products in both)."""
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.integers(0, 255, shape).astype(np.float32), device=dev)
    img = img + torch.rand(shape, device=dev) * (shape[0] % 2)
    ker = cuda_fast.fast_nms_blur(img, 7.0, 20.0)
    ref = cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
    torch.cuda.synchronize()
    for a, b in zip(ker[:3], ref[:3]):
        assert torch.equal(a, b)
    assert float((ker[3] - ref[3]).abs().max()) < 1e-4


def _k2_args(dev, N, L, n_proto, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    proto = (torch.rand((n_proto, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, n_proto, (N,), generator=g, device=dev)]
    t = proto[torch.randint(0, n_proto, (L,), generator=g, device=dev)]
    flip = torch.rand((L, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t)
    return (q, torch.rand((N, 2), generator=g, device=dev) * 100,
            torch.randint(0, 8, (N,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(N, generator=g, device=dev) < 0.9,
            t, torch.rand((L, 2), generator=g, device=dev) * 100,
            torch.rand(L, generator=g, device=dev) * 30,
            torch.randint(0, 8, (L,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(L, generator=g, device=dev) < 0.8)


def _k2_equal(args, slack):
    """The kernel on bits and on packed words against the plain version
    on bits and on words: all four (best, second, idx) identical."""
    words = list(args)
    words[0] = cuda_matching.pack_desc(args[0])
    words[4] = cuda_matching.pack_desc(args[4])
    ref = cuda_matching.gated_nn_plain(*args, level_slack=slack)
    for out in (cuda_matching.gated_nn(*args, level_slack=slack),
                cuda_matching.gated_nn(*words, level_slack=slack),
                cuda_matching.gated_nn_plain(*words, level_slack=slack)):
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("L", [1, 17, 255, 511, 4096, 5000])
def test_k2_kernel_matches_plain(dev, L):
    """(best, second, idx) identical, any L (smaller than the cluster, a
    ragged last chunk, chunks longer than one staged tile), on bits and on
    packed words, with ties among 6 prototypes and gated rows; the fuse
    step's batched layout (B = 3) too."""
    args = _k2_args(dev, 1000, L, 6, L)
    _k2_equal(args, 1)
    B = 3
    bargs = [a.expand(B, *a.shape) if i != 4 else a for i, a in enumerate(args)]
    _k2_equal(bargs, 7)


def test_k2_kernel_ties_and_all_gated(dev):
    """4 prototypes (nearly every distance ties), a quarter of the queries
    invalid, then every landmark gated: idx 0 and best = second = BIG."""
    args = list(_k2_args(dev, 1000, 4096, 4, 7))
    args[3][:250] = False
    best, second, idx = _k2_equal(args, 1)
    assert bool((best[:250] == cuda_matching.BIG).all())
    assert int((best < cuda_matching.BIG).sum()) > 100
    args[8] = torch.zeros_like(args[8])
    best, second, idx = _k2_equal(args, 1)
    assert bool((best == cuda_matching.BIG).all())
    assert bool((second == cuda_matching.BIG).all())
    assert not bool(idx.any())


def _pyramid(dev, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, 255, s).astype(np.float32)
                            + rng.random(s).astype(np.float32) * (i % 2),
                            device=dev) for i, s in enumerate(sizes)]


@pytest.mark.parametrize("sizes", [orb.OrbConfig().level_sizes,
                                   orb.OrbConfig(height=512,
                                                 width=512).level_sizes,
                                   ((7, 7), (33, 47), (65, 33))],
                         ids=["752x480_pyramid", "512x512_pyramid",
                              "odd_sizes"])
def test_k1_pyramid_matches_plain(dev, sizes):
    """One launch over all levels against the per-level plain version:
    score and NMS maps exact (interior and border), blur within 1e-4."""
    levels = _pyramid(dev, sizes)
    n0 = cuda_fast.fast_nms_blur_pyramid.launches
    ker = cuda_fast.fast_nms_blur_pyramid(levels, 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 1
    ref = cuda_fast.fast_nms_blur_pyramid_plain(levels, 7.0, 20.0)
    torch.cuda.synchronize()
    for k, r in zip(ker, ref):
        for a, b in zip(k[:3], r[:3]):
            assert torch.equal(a, b)
        assert float((k[3] - r[3]).abs().max()) < 1e-4


def test_wrappers_count_launches(dev):
    """One K1 launch per pyramid (and per single level), one K2 launch per
    call whether it is given bits or words; plain versions count none."""
    img = torch.zeros((64, 64), device=dev)
    n0 = cuda_fast.fast_nms_blur_pyramid.launches
    cuda_fast.fast_nms_blur(img, 7.0, 20.0)
    cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 1
    cuda_fast.fast_nms_blur_pyramid([img, img[:40, :50].contiguous()], 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 2
    N, L = 5, 7
    args = (torch.zeros((N, 256), dtype=torch.uint8, device=dev),
            torch.zeros((N, 2), device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.ones(N, dtype=torch.bool, device=dev),
            torch.zeros((L, 256), dtype=torch.uint8, device=dev),
            torch.zeros((L, 2), device=dev), torch.ones(L, device=dev),
            torch.zeros(L, dtype=torch.int32, device=dev),
            torch.ones(L, dtype=torch.bool, device=dev))
    n0 = cuda_matching.gated_nn.launches
    cuda_matching.gated_nn(*args)
    cuda_matching.gated_nn_plain(*args)
    assert cuda_matching.gated_nn.launches == n0 + 1
    words = list(args)
    words[0] = cuda_matching.pack_desc(args[0])
    words[4] = cuda_matching.pack_desc(args[4])
    cuda_matching.gated_nn(*words)
    assert cuda_matching.gated_nn.launches == n0 + 2


def _k3_equal(args):
    """Both K3 entry points, on bits and on packed words, against the plain
    versions: (best, second, idx) and back identical."""
    ref = cuda_hamming.hamming_nn_match_plain(*args)
    words = (cuda_matching.pack_desc(args[0]), args[1],
             cuda_matching.pack_desc(args[2]), args[3])
    for x in (args, words):
        rows = cuda_hamming.hamming_nn(*x)
        both = cuda_hamming.hamming_nn_match(*x)
        assert len(rows) == 3 and len(both) == 4
        for a, b in zip((*rows, *both), (*ref[:3], *ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("Q,T", [(Q, T) for Q in (1, 1000)
                                 for T in (1, 255, 1000, 1001, 4000)]
                         + [(4000, 1000)])
def test_k3_kernel_matches_plain(dev, Q, T):
    """Rows and columns identical for any Q and T (below, at and above the
    cluster's 1024 targets), on bits and on packed words, with invalid
    queries and targets, an all-invalid batch row, ties among 6
    prototypes, and the loop window layout (shared queries against W = 11
    target sets) and the sides swapped (batched queries, shared targets);
    match_by_descriptor equal to its dense form, one launch per call."""
    g = torch.Generator(device=dev).manual_seed(Q + T)
    W = 11
    proto = (torch.rand((6, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 6, (Q,), generator=g, device=dev)]
    t = proto[torch.randint(0, 6, (W, T), generator=g, device=dev)]
    flip = torch.rand((W, T, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t).contiguous()
    qv = torch.rand(Q, generator=g, device=dev) < 0.9
    tv = torch.rand((W, T), generator=g, device=dev) < 0.75
    tv[3] = False
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv), (t, tv, q, qv)):
        _k3_equal(args)
    n0 = cuda_hamming.hamming_nn.launches
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv)):
        a = track_match.match_by_descriptor(*args)
        b = track_match.match_by_descriptor_plain(*args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert cuda_hamming.hamming_nn.launches == n0 + 2


def test_k3_columns_all_gated_and_ties(dev):
    """An all-invalid query set: every column's back is 0 and every row
    BIG; with 2 prototypes nearly every column ties, and back keeps the
    lowest query index."""
    g = torch.Generator(device=dev).manual_seed(11)
    proto = (torch.rand((2, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 2, (1000,), generator=g, device=dev)]
    t = proto[torch.randint(0, 2, (1000,), generator=g, device=dev)]
    qv = torch.rand(1000, generator=g, device=dev) < 0.8
    tv = torch.ones(1000, dtype=torch.bool, device=dev)
    best, second, idx, back = _k3_equal((q, qv, t, tv))
    first = [int(torch.nonzero(qv & (q == p).all(-1))[0]) for p in proto]
    assert set(back.tolist()) <= set(first)
    best, second, idx, back = _k3_equal((q, torch.zeros_like(qv), t, tv))
    assert not bool(back.any()) and not bool(idx.any())
    assert bool((best == cuda_matching.BIG).all())


def test_k3_wrapper_checks(dev):
    q = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    v = torch.ones(4, dtype=torch.bool, device=dev)
    for fn in (cuda_hamming.hamming_nn, cuda_hamming.hamming_nn_match):
        with pytest.raises(ValueError, match="dtype|is torch"):
            fn(q.float(), v, q, v)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, v, torch.zeros((256, 4), dtype=torch.uint8, device=dev).T, v)
        with pytest.raises(ValueError, match="on cpu"):
            fn(q, v, q.cpu(), v)
        with pytest.raises(ValueError, match="aligned"):
            fn(q, v, torch.zeros(4 * 256 + 1, dtype=torch.uint8,
                                 device=dev)[1:].view(4, 256), v)


def _merge_pair(seed=0, sigma=0.7, n_pts=120):
    """tests/test_map_merging.py's two gauges of one scene (three keyframes
    each, map B = sigma Rz(0.4) map A + t), on the port's MapState."""
    rng = np.random.default_rng(seed)
    cfg = TrackerConfig(device="cpu")
    K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]],
                 np.float32)
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
    desc = (rng.random((n_pts, 256)) > 0.5).astype(np.uint8)

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    Rg, tg = rot_z(0.4), np.array([0.3, -0.2, 0.1], np.float32)

    def make(Xw, poses):
        m = MapState(max_kf=16, max_kp=n_pts, max_lm=1024)
        ids = m.add_landmarks(Xw, desc, 0)
        for k, (R, c) in enumerate(poses):
            t = (-R @ c).astype(np.float32)
            p = Xw @ R.T + t
            uv = ((p[:, :2] / p[:, 2:3]) @ K[:2, :2].T + K[:2, 2]).astype(np.float32)
            m.add_keyframe(R, t, uv, np.zeros(n_pts, np.int32),
                           np.zeros(n_pts, np.float32), np.ones(n_pts, bool),
                           desc, k, float(k), kp_lm=ids.astype(np.int32))
        return m

    poses = [(rot_z(0.03 * k), np.array([0.2 * k, 0.05 * k, -0.1 * k],
                                        np.float32)) for k in range(3)]
    mA = make(X, poses)
    mB = make((sigma * X @ Rg.T + tg).astype(np.float32),
              [((R @ Rg.T).astype(np.float32),
                (sigma * Rg @ c + tg).astype(np.float32)) for R, c in poses])
    return mA, mB


def test_merge_verify_on_the_card_matches_the_cpu(dev):
    """MapMerger.verify on the card against the same call on the CPU (the
    same RANSAC draws): identical verified pairs, the same Sim3 within
    float tolerance, and exactly one K3 launch per verification, with no
    fallback to the plain form."""
    draws = np.random.default_rng(9).random((128, 256)).astype(np.float32)
    out = {}
    for d in ("cpu", "cuda"):
        merger = MapMerger(cfg=TrackerConfig(device=d),
                           uniforms_fn=lambda iters, n: draws)
        cuda_hamming.hamming_nn.launches = 0
        out[d] = [merger.verify(*_merge_pair(seed)[:1], 0,
                                _merge_pair(seed)[1], 0) for seed in (0, 1)]
        torch.cuda.synchronize()
        out[d + "_k3"] = cuda_hamming.hamming_nn.launches
    assert out["cpu_k3"] == 0 and out["cuda_k3"] == 2
    for c, g in zip(out["cpu"], out["cuda"]):
        assert c is not None and g is not None
        for a, b in zip(c["pairs"], g["pairs"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(c["R12"], g["R12"], atol=1e-4)
        np.testing.assert_allclose(c["t12"], g["t12"], atol=1e-4)
        assert abs(c["s12"] / g["s12"] - 1.0) < 1e-4


def _split_session(n=10):
    """A short CPU session of the lateral world on the split rounds
    (fused_rounds=False) and the next rendered image."""
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R, t = synthetic.lateral_trajectory(18, x_span=0.5, z_span=0.0, y_amp=0.0)
    slam = SlamSystem(SystemConfig(
        tracker=TrackerConfig(fps=10, fused_rounds=False),
        enable_loop_closing=False, device="cpu"))
    for i in range(n):
        slam.track_monocular(
            synthetic.render_textured(world, R[i], t[i], rng=rng), i * 0.1)
    return slam, synthetic.render_textured(world, R[n], t[n], rng=rng)


def test_split_round_on_the_card_matches_the_cpu(dev):
    """One frame of the split rounds (flow anchor, motion-model match and
    solve, two local-map match <-> solve rounds) from the same carried state
    and the same features on the card and on the CPU: identical bindings,
    the pose within 1e-4, K2 launched on every match on the card and never
    on the CPU.  The frame carries no pyramid, so the KLT step is skipped in
    both."""
    from orb_slam3_study_kr_tpu_torch import convert
    from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                                TrackState)
    slam, img = _split_session()
    tr = slam.tracker
    assert slam.state == TrackState.OK and tr.velocity is not None
    m, lf = tr.map, tr.last_frame
    tables = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in vars(m).items()
              if isinstance(v, (np.ndarray, int, float, bool))}
    keys = ("uv", "uv_raw", "level", "angle", "response", "desc", "valid",
            "patch")
    last = {k: np.array(getattr(lf, k)) for k in keys}
    last.update(kp_lm=lf.kp_lm.copy(), R_cw=lf.R_cw, t_cw=lf.t_cw,
                frame_id=lf.frame_id, timestamp=lf.timestamp,
                ref_kf=lf.ref_kf, pose_ok=True, rel_ref=lf.rel_ref,
                rel_R=lf.rel_R, rel_t=lf.rel_t)
    new = tr._extract_frame(img, 1.0)
    host = {k: np.array(getattr(new, k)) for k in keys}
    out = {}
    for d in ("cpu", "cuda"):
        t2 = MonoTracker(TrackerConfig(fps=10, fused_rounds=False, device=d),
                         MapState(max_kf=m.max_kf, max_kp=m.max_kp,
                                  max_lm=m.max_lm))
        convert.tracker_state_from_numpy(
            t2, tables, dict(last), tr.velocity, tr.ref_kf, tr._speed_hist,
            frame_count=new.frame_id)
        f = Frame(frame_id=new.frame_id, timestamp=1.0, device=d,
                  **{k: v.copy() for k, v in host.items()})
        cuda_matching.gated_nn.launches = 0
        ok = t2._track_motion_model(f)
        n = t2._track_local_map(f)
        if d == "cuda":
            torch.cuda.synchronize()
        out[d] = (ok, n, f.kp_lm.copy(), f.R_cw, f.t_cw,
                  cuda_matching.gated_nn.launches,
                  t2.stats.get("split_frames", 0))
    (ok_c, n_c, kp_c, R_c, t_c, k2_c, s_c), (ok_g, n_g, kp_g, R_g, t_g, k2_g,
                                            s_g) = out["cpu"], out["cuda"]
    assert ok_c and ok_g and n_c > 25 and s_c == s_g == 1
    assert k2_c == 0 and k2_g >= 3
    np.testing.assert_array_equal(kp_g, kp_c)
    assert n_g == n_c
    np.testing.assert_allclose(R_g, R_c, atol=1e-4)
    np.testing.assert_allclose(t_g, t_c, atol=1e-4)
