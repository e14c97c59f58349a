#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (orb_slam3_study_kr_tpu_torch).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card and nvcc.  Phases, one printed line each:
  1. the card (nvidia-smi name and power limit);
  2. build of the hand-written kernels from csrc/ (one nvcc per source, in
     parallel, then one link);
  3. K1 (fast_nms_blur_pyramid) against its plain PyTorch version over the
     8-level pyramid of a rendered 752x480 frame, in one launch;
  4. K2 (gated_nn) against its plain version at N = total_slots, L = 4096
     with gates built from two rendered frames, on bits and packed words;
  5. K3 (hamming_nn, and hamming_nn_match with the column output of the
     same launch) and match_by_descriptor against their plain versions:
     frame B's features against frame A's, an 11-set window batch and the
     sides swapped, a tie case with invalid targets and an all-invalid
     batch row, T = 1 and 1001;
Phases 3-5 also time each kernel three ways: its device time per launch
(CUDA events around 100 back-to-back launches of the bare kernel on inputs
prepared once, queued behind a device-side sleep so that the host's enqueue
time stays outside the window), its route time per call (the wrapper as
the main path calls it, host time included: wall clock over back-to-back
calls ending in a synchronize) and the plain version's time per call the
same way; and they compute its bound from this run's inputs (the larger of
bytes over 3.35 TB/s and operations over 67 T/s, for K3's distances over
the int8 tensor-core rate of 1979 T/s).
  6. the loop-closing-off main path: an 18-frame monocular session on the
     lateral textured world through SlamSystem.track_monocular;
  7. the default configuration (loop closing on): the 40-frame lateral
     session, vocabulary, database and loop closer included;
  8. BoW relocalization of re-rendered views of frames 14 and 26 against
     that map;
  9. loop correction on the ring world (a first pass of 18 keyframes and
     three drifted revisits) with LoopCloser(run_gba=True).
Phases 6-9 are the main paths: each resets the kernels' launch counters just
before it and reads them just after; the kernels line sums them.  Any
failure raises (non-zero exit).  Before the last two lines the script prints
its own seconds; the line before the last is the kernels JSON; the last line
is {"ok": true, "device": {...}}.  Imports only the port, torch and numpy.
In the kernels JSON, `ms` is the route time per call, timed as `plain_ms`
is, and `device_ms` the bare kernel's time per launch (K3: the fused launch
at Q = T = 1000, rows and columns).
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "orb_slam3_study_kr_tpu_torch"

# Tolerances.  K1's score/NMS maps are min/max/compare of exact float
# differences: bit-exact.  The blur sums 7 taps in a fixed order with
# round-to-nearest products in both versions; 1e-4 absolute (gray levels
# 0..255) allows for a different multiply-add contraction in the plain
# version's elementwise kernels.  K2's and K3's distances are integer
# popcounts: (best, second, idx) must be identical, and so must
# match_by_descriptor's (idx, ok, best).
BLUR_TOL = 1e-4

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth,
# the float32 rate outside the tensor cores, which the integer and
# compare work of these kernels is counted against, and (below) the dense
# int8 tensor-core rate.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Operations per unit of work, counted from the algorithm each kernel runs:
# K1 per pixel: FAST 16 differences + 2 polarities x (42 shared arc
# min/max + 15 max over the arcs) + 3, NMS 8 max + 2 thresholds + 2 maps x
# 3 compare/select, 2 blur passes x (7 mul + 6 add): 175.
K1_OPS_PER_PX = 16 + 2 * (42 + 15) + 3 + (8 + 2 + 2 * 3) + 2 * 13
# K2 per pair: the gates (2 differences, 2 |.| <= r compares, a level
# difference and its 2 compares, 3 ands) = 10; a pair that passes adds 8
# xor, 8 popcounts and 8 adds or compares = 24.
GATE_OPS, PAIR_OPS = 10, 24
# K3, one fused launch, per pair: the distance as a 256-byte int8 dot
# product on the tensor cores (a multiply and an add per byte, dense,
# whatever the masks), and outside them the validity mask (1), the row's
# compares and selects of best, index and second (3) and the column's of
# best and index (2).  Per descriptor row 256 bytes and its validity byte
# in; per query best, second and idx (12 bytes) and per target back (4)
# out.
PEAK_INT8_OPS_S = 1979e12
K3_TC_OPS_PER_PAIR = 2 * 256
K3_CMP_OPS_PER_PAIR = 1 + 3 + 2
K3_ROW_OUT_B, K3_COL_OUT_B = 12, 4


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the memory and the compute time."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _per_call_ms(fn, n=50, repeats=3):
    """Median over `repeats` of the wall time per call of n back-to-back
    calls ending in a synchronize: what a caller pays, host or device."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return sorted(out)[len(out) // 2]


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return dict(nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.load()
    secs = time.perf_counter() - t0
    print(f"phase build: {os.path.relpath(so, HERE)} in {secs:.3f} s")
    return dict(build_s=secs)


def phase_k1(dev, frame_img):
    import torch
    from orb_slam3_study_kr_tpu_torch.utils.profiling import device_ms_per_launch
    from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, orb
    cfg = orb.OrbConfig()
    th = (float(cfg.fast_min_threshold), float(cfg.fast_threshold))
    levels = orb.build_pyramid(torch.as_tensor(frame_img, device=dev), cfg)
    ker = cuda_fast.fast_nms_blur_pyramid(levels, *th)
    ref = cuda_fast.fast_nms_blur_pyramid_plain(levels, *th)
    torch.cuda.synchronize()
    max_err = 0.0
    border_diff = 0
    for lvl, (k, r) in enumerate(zip(ker, ref)):
        for name, a, b in zip(("s_raw", "s20", "s7"), k[:3], r[:3]):
            bad = int((a[8:-8, 8:-8] != b[8:-8, 8:-8]).sum())
            if bad:
                raise AssertionError(f"K1 level {lvl} {name}: {bad} interior "
                                     "pixels differ")
            border_diff += int((a != b).sum())
        err = float((k[3] - r[3]).abs().max())
        if err > BLUR_TOL:
            raise AssertionError(f"K1 level {lvl} blur err {err} > {BLUR_TOL}")
        max_err = max(max_err, err)
    launch, _ = cuda_fast.fast_nms_blur_pyramid_call(levels, *th)
    device_ms = device_ms_per_launch(launch)
    route_ms = _per_call_ms(lambda: cuda_fast.fast_nms_blur_pyramid(levels, *th))
    plain_ms = _per_call_ms(
        lambda: cuda_fast.fast_nms_blur_pyramid_plain(levels, *th), n=10)
    px = sum(img.numel() for img in levels)
    nbytes, ops = px * (4 + 16), px * K1_OPS_PER_PX
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"phase K1: one launch over 8 levels 480x752..{tuple(levels[-1].shape)}"
          f" ({px} px), maps exact on the interior ({border_diff} border pixels"
          f" differ), blur max_abs_err {max_err:.3g}; device {device_ms:.5f} ms"
          f" per frame, route {route_ms:.5f} ms, plain {plain_ms:.5f} ms; bound"
          f" {bound_ms:.5f} ms by {bound_by} (max({nbytes} B / 3.35 TB/s, "
          f"{ops} op / 67 T/s); {K1_OPS_PER_PX} op/px), device time at "
          f"{bound_ms / device_ms:.3f} of the bound")
    return dict(max_abs_err=max_err, device_ms=device_ms, route_ms=route_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                px=px, bytes=nbytes, ops=ops, border_diff=border_diff)


def phase_k2(dev, img_a, img_b):
    import torch
    from orb_slam3_study_kr_tpu_torch.utils.profiling import device_ms_per_launch
    from orb_slam3_study_kr_tpu_torch.ops import cuda_matching, orb
    cfg = orb.OrbConfig()
    fa = orb.extract_orb(torch.as_tensor(img_a, device=dev), cfg)
    fb = orb.extract_orb(torch.as_tensor(img_b, device=dev), cfg)
    N = cfg.total_slots
    L = 4096
    g = torch.Generator(device=dev).manual_seed(0)
    # Landmarks: frame A's features, tiled to L rows with perturbed copies
    # (bit flips, shifted projections), projected where frame A saw them;
    # queries: frame B's features.  Gates as on the main path: radius
    # 4 * 1.2^level, level slack 1, visibility = validity.
    rep = -(-L // N)
    t_desc = fa.desc.repeat(rep, 1)[:L].clone()
    flip = torch.rand(t_desc.shape, generator=g, device=dev) < 0.05
    flip[:N] = False
    t_desc = torch.where(flip, 1 - t_desc, t_desc)
    t_uv = fa.uv.repeat(rep, 1)[:L] + 2.0 * torch.randn((L, 2), generator=g,
                                                        device=dev)
    t_level = fa.level.repeat(rep)[:L]
    t_radius = 4.0 * torch.pow(torch.tensor(1.2, device=dev),
                               t_level.to(torch.float32))
    t_valid = fa.valid.repeat(rep)[:L]
    args = (fb.desc, fb.uv, fb.level, fb.valid,
            t_desc, t_uv, t_radius, t_level, t_valid)
    cases = {"real": args}
    # Adversarial: descriptors from 4 prototypes (many equal distances),
    # one all-gated query row set.
    proto = (torch.rand((4, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    pick_q = torch.randint(0, 4, (N,), generator=g, device=dev)
    pick_t = torch.randint(0, 4, (L,), generator=g, device=dev)
    q_valid = fb.valid.clone()
    q_valid[: N // 4] = False
    cases["ties"] = (proto[pick_q], fb.uv, fb.level, q_valid, proto[pick_t],
                     t_uv, t_radius, t_level, t_valid)
    n_ok = 0
    max_err = 0.0
    for name, a in cases.items():
        words = (cuda_matching.pack_desc(a[0]), *a[1:4],
                 cuda_matching.pack_desc(a[4]), *a[5:])
        ref = cuda_matching.gated_nn_plain(*a, level_slack=1)
        for form, x in (("bits", a), ("words", words)):
            ker = cuda_matching.gated_nn(*x, level_slack=1)
            torch.cuda.synchronize()
            for what, k, r in zip(("best", "second", "idx"), ker, ref):
                bad = int((k != r).sum())
                if bad:
                    raise AssertionError(f"K2 {name} {form} {what}: {bad} of "
                                         f"{N} differ")
                max_err = max(max_err, float((k.double() - r.double()).abs().max()))
        n_ok += int((ref[0] < 1e9).sum())
    # Pairs of the real case that pass the gates (the plain version's mask).
    d_uv = (t_uv[:, None, :] - fb.uv[None, :, :]).abs()
    lvl = fb.level[None, :] - t_level[:, None]
    passing = int(((d_uv[..., 0] <= t_radius[:, None])
                   & (d_uv[..., 1] <= t_radius[:, None]) & (lvl.abs() <= 1)
                   & t_valid[:, None] & fb.valid[None, :]).sum())
    words = (cuda_matching.pack_desc(fb.desc), *args[1:4],
             cuda_matching.pack_desc(t_desc), *args[5:])
    launch, _ = cuda_matching.gated_nn_call(*words, level_slack=1)
    device_ms = device_ms_per_launch(launch)
    route_ms = _per_call_ms(lambda: cuda_matching.gated_nn(*words, level_slack=1))
    plain_ms = _per_call_ms(lambda: cuda_matching.gated_nn_plain(*args, level_slack=1))
    nbytes = N * (32 + 8 + 4 + 1) + L * (32 + 8 + 4 + 4 + 1) + N * 12
    ops = N * L * GATE_OPS + passing * PAIR_OPS
    bound_ms, bound_by = _bound(nbytes, ops)
    all_ms, all_by = _bound(nbytes, N * L * (GATE_OPS + PAIR_OPS))
    print(f"phase K2: N={N} L={L} (best, second, idx) exact on {len(cases)} "
          f"cases, bits and packed words ({n_ok} ungated rows); {passing} of "
          f"{N * L} pairs pass the gates in the real case; device "
          f"{device_ms:.5f} ms, route (packed words) {route_ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"(max({nbytes} B / 3.35 TB/s, (N L x {GATE_OPS} + {passing} x "
          f"{PAIR_OPS}) op / 67 T/s)), {all_ms:.5f} ms with every pair "
          f"passing; device time at {bound_ms / device_ms:.3f} of the bound")
    return dict(max_abs_err=max_err, device_ms=device_ms, route_ms=route_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_all_pass_ms=all_ms, pairs=N * L, pairs_passing=passing,
                bytes=nbytes, ops=ops, N=N, L=L)


def _k3_bound(q_desc, q_valid, t_desc, t_valid):
    """(bound_ms, bound_by, bytes, ops) of one fused K3 launch: each input
    read once, each output written once, the dense distance work on the
    tensor cores and the compares outside them, from these inputs."""
    B = max(x.shape[0] if x.dim() == 3 else 1 for x in (q_desc, t_desc))
    Q, T = q_desc.shape[-2], t_desc.shape[-2]
    nbytes = (q_desc.numel() + q_valid.numel() + t_desc.numel()
              + t_valid.numel() + B * (Q * K3_ROW_OUT_B + T * K3_COL_OUT_B))
    tc_ops = B * Q * T * K3_TC_OPS_PER_PAIR
    cmp_ops = B * Q * T * K3_CMP_OPS_PER_PAIR
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(tc_ops / PEAK_INT8_OPS_S, cmp_ops / PEAK_OPS_S) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, nbytes, tc_ops + cmp_ops)


def phase_k3(dev, img_a, img_b):
    import torch
    from orb_slam3_study_kr_tpu_torch.utils.profiling import device_ms_per_launch
    from orb_slam3_study_kr_tpu_torch.ops import (cuda_hamming, cuda_matching,
                                                  orb, track_match)
    cfg = orb.OrbConfig()
    fa = orb.extract_orb(torch.as_tensor(img_a, device=dev), cfg)
    fb = orb.extract_orb(torch.as_tensor(img_b, device=dev), cfg)
    N = cfg.total_slots
    W = 11
    g = torch.Generator(device=dev).manual_seed(3)
    # Window: 11 target sets, bit-flipped copies of frame A's descriptors
    # (the loop window's shared query set against up to 11 keyframes).
    flip = torch.rand((W, N, 256), generator=g, device=dev) < 0.04
    t_win = torch.where(flip, 1 - fa.desc, fa.desc).contiguous()
    v_win = (fa.valid[None] & (torch.rand((W, N), generator=g, device=dev)
                               < 0.9)).contiguous()
    proto = (torch.rand((4, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q_tie = proto[torch.randint(0, 4, (N,), generator=g, device=dev)]
    t_tie = proto[torch.randint(0, 4, (W, N), generator=g, device=dev)]
    v_tie = torch.rand((W, N), generator=g, device=dev) >= 0.25
    v_tie[5] = False                        # one all-invalid batch row
    cases = {
        "frames": (fb.desc, fb.valid, fa.desc, fa.valid),
        "window": (fb.desc, fb.valid, t_win, v_win),
        "swapped": (t_win, v_win, fb.desc, fb.valid),
        "ties": (q_tie, fb.valid, t_tie.contiguous(), v_tie.contiguous()),
        "T=1": (fb.desc, fb.valid, fa.desc[:1].contiguous(),
                torch.ones(1, dtype=torch.bool, device=dev)),
        "T=1001": (fb.desc, fb.valid, t_win[:2].reshape(-1, 256)[:1001].contiguous(),
                   v_win[:2].reshape(-1)[:1001].contiguous()),
    }
    pack = cuda_matching.pack_desc
    max_err = 0.0
    n_ok = {}
    for name, a in cases.items():
        ref = cuda_hamming.hamming_nn_match_plain(*a)
        words = (pack(a[0]), a[1], pack(a[2]), a[3])
        for form, x in (("bits", a), ("words", words)):
            for entry, ker, r in (
                    ("hamming_nn", cuda_hamming.hamming_nn(*x), ref[:3]),
                    ("hamming_nn_match", cuda_hamming.hamming_nn_match(*x), ref)):
                for part, k, y in zip(("best", "second", "idx", "back"), ker, r):
                    bad = int((k != y).sum())
                    if bad:
                        raise AssertionError(f"K3 {entry} {name} {form} {part}: "
                                             f"{bad} differ")
                    max_err = max(max_err, float((k.double() - y.double()).abs().max()))
        km = track_match.match_by_descriptor(*a)
        pm = track_match.match_by_descriptor_plain(*a)
        for part, x, y in zip(("idx", "ok", "best"), km, pm):
            if not torch.equal(x, y):
                raise AssertionError(f"match_by_descriptor {name} {part} differs")
        n_ok[name] = int(km[1].sum())
    if n_ok["frames"] < 100 or n_ok["window"] < 100:
        raise AssertionError(f"too few descriptor matches {n_ok}")
    torch.cuda.synchronize()
    r = {}
    for key, a in (("", cases["frames"]), ("win_", cases["window"])):
        launch, _ = cuda_hamming.hamming_nn_call(*a, columns=True)
        r[key + "device_ms"] = device_ms_per_launch(launch)
        r[key + "route_ms"] = _per_call_ms(lambda: cuda_hamming.hamming_nn_match(*a))
        r[key + "plain_ms"] = _per_call_ms(
            lambda: cuda_hamming.hamming_nn_match_plain(*a))
        (r[key + "bound_ms"], r[key + "bound_by"], r[key + "bytes"],
         r[key + "ops"]) = _k3_bound(*a)
    a = cases["frames"]
    r["mbd_ms"] = _per_call_ms(lambda: track_match.match_by_descriptor(*a))
    r["mbd_plain_ms"] = _per_call_ms(lambda: track_match.match_by_descriptor_plain(*a))
    print(f"phase K3: Q=T={N} and window {W}x{N}: (best, second, idx) and back "
          f"exact, both entry points, on bits and packed words, on "
          f"{len(cases)} cases, match_by_descriptor exact (matches {n_ok}); "
          f"one fused launch (rows and columns), Q=T: device "
          f"{r['device_ms']:.5f} ms, route (bits) {r['route_ms']:.5f} ms, plain "
          f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms by "
          f"{r['bound_by']} (max({r['bytes']} B / 3.35 TB/s, 2 Q T x 256 op / "
          f"1979 T/s, Q T x {K3_CMP_OPS_PER_PAIR} op / 67 T/s)), device time at "
          f"{r['bound_ms'] / r['device_ms']:.3f} of the bound; window: device "
          f"{r['win_device_ms']:.5f} ms, route {r['win_route_ms']:.5f} ms, plain "
          f"{r['win_plain_ms']:.5f} ms, bound {r['win_bound_ms']:.5f} ms by "
          f"{r['win_bound_by']}, at {r['win_bound_ms'] / r['win_device_ms']:.3f}; "
          f"match_by_descriptor {r['mbd_ms']:.5f} ms, dense "
          f"{r['mbd_plain_ms']:.5f} ms")
    return dict(r, max_abs_err=max_err, N=N, W=W, n_ok=n_ok)


class _Launches:
    """Reset every kernel's launch counter on entry, read them on exit."""

    def __enter__(self):
        import torch
        from orb_slam3_study_kr_tpu_torch.ops import (cuda_fast, cuda_hamming,
                                                      cuda_matching)
        self.wrappers = dict(fast_nms_blur=cuda_fast.fast_nms_blur_pyramid,
                             gated_nn=cuda_matching.gated_nn,
                             hamming_nn=cuda_hamming.hamming_nn)
        torch.cuda.synchronize()
        for f in self.wrappers.values():
            f.launches = 0
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.counts = {k: f.launches for k, f in self.wrappers.items()}
        return False


def _lateral_session(dev, n, x_span, loop_closing):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=x_span, z_span=0.0,
                                              y_amp=0.0)
    imgs = [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            for i in range(n)]
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   enable_loop_closing=loop_closing,
                                   device=str(dev)))
    with _Launches() as counter:
        t0 = time.perf_counter()
        for i in range(n):
            slam.track_monocular(imgs[i], i * 0.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = slam.trajectory()
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1,
                           centers, True)
    stats = slam.stats()
    if slam.state != TrackState.OK:
        raise AssertionError(f"final state {slam.state}")
    if not np.isfinite(rows[:, 1:]).all():
        raise AssertionError("non-finite trajectory")
    k1, k2 = counter.counts["fast_nms_blur"], counter.counts["gated_nn"]
    fused = slam.tracker.stats.get("fused_frames", 0)
    if k1 != n:
        raise AssertionError(f"K1 launched {k1} times, expected one per frame "
                             f"({n})")
    if fused < 1 or k2 < 4 * fused:
        raise AssertionError(f"K2 launched {k2} times over {fused} fused frames")
    warm = np.asarray(slam.timings[5:]) * 1e3
    stages = {k: round(v["median_ms"], 3) for k, v in stats["stages"].items()}
    return slam, world, R_gt, t_gt, dict(
        ate=rmse, nm=nm, n_kf=stats["n_kf"], n_lm=stats["n_lm"],
        frame_ms_median_warm=float(np.median(warm)),
        frame_ms=[float(x) for x in np.asarray(slam.timings) * 1e3],
        stages=stats["stages"], stage_medians=stages, loops=stats["loops"],
        launches=counter.counts, fused_frames=fused, wall_s=wall)


def phase_loop_off(dev):
    n = 18
    *_, r = _lateral_session(dev, n, 0.5, loop_closing=False)
    if not (r["n_kf"] >= 3 and r["nm"] > 10 and r["ate"] < 0.05):
        raise AssertionError(f"n_kf {r['n_kf']} nm {r['nm']} ATE {r['ate']}")
    print(f"phase loop-off path: {n} frames state OK, n_kf {r['n_kf']}, ATE "
          f"{r['ate']:.5f} over {r['nm']} frames; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms; launches {r['launches']} over "
          f"{r['fused_frames']} fused frames")
    return r


def phase_default(dev):
    n = 40
    slam, world, R_gt, t_gt, r = _lateral_session(dev, n, 1.0, loop_closing=True)
    if not (r["n_kf"] >= 3 and r["nm"] > 25 and r["ate"] < 0.06):
        raise AssertionError(f"n_kf {r['n_kf']} nm {r['nm']} ATE {r['ate']}")
    if slam.voc is None or slam.db is None or len(slam.db.vectors) < 5:
        raise AssertionError("vocabulary / database not built")
    if r["loops"].get("n_queries", 0) < 1:
        raise AssertionError(f"loop closer not queried: {r['loops']}")
    if "loop/detect_correct" not in r["stage_medians"]:
        raise AssertionError("no loop/detect_correct stage")
    print(f"phase default-config path: {n} frames, loop closing on, state OK, "
          f"n_kf {r['n_kf']}, n_lm {r['n_lm']}, ATE {r['ate']:.5f} over "
          f"{r['nm']} frames; vocabulary {slam.voc.n_words} words, database "
          f"{len(slam.db.vectors)} keyframes, loop stats {json.dumps(r['loops'])}; "
          f"warm per-frame median {r['frame_ms_median_warm']:.2f} ms, wall "
          f"{r['wall_s']:.2f} s; stage medians (ms) {json.dumps(r['stage_medians'])}; "
          f"launches {r['launches']} over {r['fused_frames']} fused frames")
    return slam, world, R_gt, t_gt, r


def phase_reloc(dev, slam, world, R_gt, t_gt):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.ops import orb
    from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
    cfg = slam.cfg.tracker.orb_config
    out = {}
    slam.sys_stats.clear()
    with _Launches() as counter:
        for fid, seed in ((14, 321), (26, 322)):
            img = synthetic.render_textured(world, R_gt[fid], t_gt[fid],
                                            rng=np.random.default_rng(seed))
            feats = orb.extract_orb(torch.as_tensor(img, device=dev), cfg)
            frame = Frame(frame_id=10_000 + fid, timestamp=99.0 + fid,
                          device=dev, **{k: getattr(feats, k).cpu().numpy().copy()
                                         for k in ("uv", "level", "angle",
                                                   "response", "desc", "valid")})
            t0 = time.perf_counter()
            ok = slam._relocalize(frame)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if not ok:
                raise AssertionError(f"relocalization of frame {fid} failed")
            c_fr = -(frame.R_cw.T @ frame.t_cw)
            out[fid] = dict(ms=ms, n_good=int((frame.kp_lm != NO_LM).sum()),
                            center=c_fr.tolist())
    stats = dict(slam.sys_stats)
    k3 = counter.counts["hamming_nn"]
    searched = stats.get("n_reloc_searched", 0)
    if stats.get("n_reloc", 0) < 1:
        raise AssertionError(f"no relocalization at full acceptance: {stats}")
    if searched < 2 or k3 < searched:
        raise AssertionError(f"K3 launched {k3} times over {searched} candidates")
    print(f"phase relocalization: frames 14 and 26 recovered {out}; stats "
          f"{stats}; launches {counter.counts} over {searched} candidates searched")
    return dict(frames=out, stats=stats, launches=counter.counts)


# The ring world of tests/test_loop_cascade.py: cameras on a circle of
# radius 3 looking out at a landmark cylinder of radius 9; a first pass of
# N_FIRST keyframes binds the true landmarks, three drifted revisits bind
# duplicates carrying an accumulated Sim3 drift.
N_FIRST, R_CAM, R_LM, N_LM = 18, 3.0, 9.0, 1200


def _ring_pose(theta):
    import numpy as np
    u = np.array([np.cos(theta), 0.0, np.sin(theta)])
    xh = np.array([-np.sin(theta), 0.0, np.cos(theta)])
    R_cw = np.stack([xh, [0.0, 1.0, 0.0], u]).astype(np.float32)
    return R_cw, (-R_cw @ (R_CAM * u).astype(np.float32)).astype(np.float32)


def _build_ring(cfg, seed=11):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.lie.sim3 import exp_sim3
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState

    def project(R, t, X):
        p = X @ R.T + t
        z = p[:, 2]
        uv = np.stack([cfg.fx * p[:, 0] / z + cfg.cx,
                       cfg.fy * p[:, 1] / z + cfg.cy], -1)
        vis = ((z > 0.2) & (uv[:, 0] > 10) & (uv[:, 0] < cfg.width - 10)
               & (uv[:, 1] > 10) & (uv[:, 1] < cfg.height - 10))
        return uv.astype(np.float32), vis

    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N_LM)
    y = rng.uniform(-1.5, 1.5, N_LM)
    X = np.stack([R_LM * np.cos(phi), y, R_LM * np.sin(phi)], -1).astype(np.float32)
    desc = rng.integers(0, 2, (N_LM, 256)).astype(np.uint8)
    m = MapState(max_kf=32, max_kp=512, max_lm=4096)
    lm_ids = m.add_landmarks(X, desc, first_kf=0)
    gt = []

    def add_kf(R, t, R_gt=None, t_gt=None, bind_ids=None):
        Rg = R if R_gt is None else R_gt
        tg = t if t_gt is None else t_gt
        uv, vis = project(Rg, tg, X)
        sel = np.nonzero(vis)[0][: m.max_kp]
        d = desc[sel].copy()
        for i in range(sel.size):
            d[i, rng.integers(0, 256, 6)] ^= 1
        tgt = lm_ids[sel] if bind_ids is None else bind_ids[sel]
        m.add_keyframe(
            R, t, uv[sel] + rng.normal(0, 0.3, (sel.size, 2)).astype(np.float32),
            np.zeros(sel.size, np.int32), np.zeros(sel.size, np.float32),
            np.ones(sel.size, bool), d, frame_id=m.next_kf,
            timestamp=float(m.next_kf), kp_lm=tgt)
        gt.append((Rg, tg))

    for k in range(N_FIRST):
        add_kf(*_ring_pose(2 * np.pi * k / N_FIRST))
    Rd, td, sd = (a.numpy() for a in exp_sim3(torch.tensor(
        [0.0, 0.05, 0.0, 0.15, 0.05, -0.1, np.log(1.06)], dtype=torch.float32)))
    sd = float(sd)
    thetas = [0.0, 2 * np.pi / N_FIRST, 4 * np.pi / N_FIRST]
    X_est = (sd * X @ Rd.T + td).astype(np.float32)
    bind_ids = lm_ids.copy()
    vis_any = np.zeros(N_LM, bool)
    for th in thetas:
        vis_any |= project(*_ring_pose(th), X)[1]
    need = np.nonzero(vis_any)[0]
    dups = m.add_landmarks(X_est[need], desc[need], first_kf=N_FIRST)
    bind_ids[need] = dups
    for th in thetas:
        Rg, tg = _ring_pose(th)
        R_est = (Rg @ Rd.T).astype(np.float32)
        add_kf(R_est, (sd * tg - R_est @ td).astype(np.float32), R_gt=Rg,
               t_gt=tg, bind_ids=bind_ids)
    m.update_landmark_stats(np.nonzero(m.lm_valid)[0])
    return m, dups, gt


def phase_loop_correction(dev):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase, train_vocabulary
    from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    cfg = TrackerConfig(fps=10, device=str(dev))
    m, dups, gt = _build_ring(cfg)
    valid = np.nonzero(m.kf_valid)[0]
    descs = m.kf_desc[valid][m.kf_kp_valid[valid]][:4000]
    voc = train_vocabulary(descs, k=8, L=3, seed=0, device=dev)
    lc = LoopCloser(cfg=cfg, map=m, db=KeyframeDatabase(voc=voc), run_gba=True)
    with _Launches() as counter:
        t0 = time.perf_counter()
        at = [kf for kf in range(m.next_kf) if lc.process_keyframe(kf)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if at != [N_FIRST + 2]:
        raise AssertionError(f"corrected at {at}, expected [{N_FIRST + 2}]; "
                             f"{lc.stats}")
    errs = [float(np.linalg.norm(m.kf_center(kf) + gt[kf][0].T @ gt[kf][1]))
            for kf in range(N_FIRST, N_FIRST + 3)]
    alive = float(m.lm_valid[dups].mean())
    st = lc.stats
    if max(errs) >= 0.25:
        raise AssertionError(f"revisit centre errors {errs}")
    if not (alive < 0.5 and st["n_fused_loop"] > 50 and st["n_gba"] == 1):
        raise AssertionError(f"duplicates alive {alive}, stats {st}")
    if counter.counts["gated_nn"] < 1 or counter.counts["hamming_nn"] < 1:
        raise AssertionError(f"launches {counter.counts}")
    print(f"phase loop correction: ring world {m.next_kf} keyframes corrected "
          f"once at {at[0]}; revisit centre errors {[round(e, 5) for e in errs]}; "
          f"live share of duplicates {alive:.4f}; stats {json.dumps(st)}; "
          f"{wall:.2f} s; launches {counter.counts}")
    return dict(corrected_at=at, centre_err=errs, dup_alive=alive, stats=st,
                wall_s=wall, launches=counter.counts)


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU "
              "machine only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: package {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    out = {"card": phase_card()}
    out["build"] = phase_build()
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(2, x_span=0.05, z_span=0.0,
                                              y_amp=0.0)
    img_a, img_b = (synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
                    for i in range(2))
    out["k1"] = phase_k1(dev, img_a)
    out["k2"] = phase_k2(dev, img_a, img_b)
    out["k3"] = phase_k3(dev, img_a, img_b)
    out["loop_off"] = phase_loop_off(dev)
    slam, world, R_gt, t_gt, out["default"] = phase_default(dev)
    out["reloc"] = phase_reloc(dev, slam, world, R_gt, t_gt)
    out["loop"] = phase_loop_correction(dev)
    paths = ("loop_off", "default", "reloc", "loop")
    launches = {k: sum(out[p]["launches"][k] for p in paths)
                for k in ("fast_nms_blur", "gated_nn", "hamming_nn")}
    kernels = []
    for name, key, src, replaces in (
            ("fast_nms_blur", "k1", "fast_nms_blur.cu", "pallas_fast.py:122"),
            ("gated_nn", "k2", "gated_nn.cu", "pallas_matching.py:144"),
            ("hamming_nn", "k3", "hamming_nn.cu", "pallas_matching.py:210")):
        r = out[key]
        kernels.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{src}",
            replaces=f"orb_slam3_study_kr_tpu/ops/{replaces}",
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["route_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel never launched on the main paths: {launches}")
    out["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, kernels=kernels), f, indent=1, default=str)
    print(f"chip_smoke: {out['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
