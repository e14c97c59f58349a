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
     three drifted revisits) with LoopCloser(run_gba=True);
 10. rectified stereo: the 30-frame lateral stereo session (seed 3,
     baseline 0.11, loop closing on) through SlamSystem.track_stereo, after
     match_stereo on the first pair on the card against the same call on
     the CPU;
 11. RGB-D: the first 12 frames of the 20-frame lateral session (seed 7)
     through track_rgbd;
 12. the background mapping worker: the first 26 frames of the 40-frame
     monocular session of seed 5 with SystemConfig(async_mapping=True),
     flushed at the end;
 13. the Atlas, run right after phase 8 on the default session: 14 frames
     of featureless noise (a sustained loss stores the map and spawns a
     second one), a replay of the first 26 frames of the path (the new map
     is recognised against the stored one, verified, one K3 launch per
     verification, and welded back into one map by the welding BA), then
     save_atlas, load_atlas into a fresh SlamSystem and a relocalization
     against the loaded map;
 14. mono-inertial: test_mono_inertial_pipeline's 60 frames (seed 11, IMU
     init schedule 2.5 / 4.0 / 5.0 s) through track_monocular(imu=): fused
     frames until the IMU is initialized, then the split rounds with the
     pose-inertial solves (K2 on every match), local inertial BA;
 15. RGB-D-inertial: test_rgbd_inertial_pipeline's 50 frames (seed 13,
     fixed-scale IMU init) through track_rgbd(imu=);
 16. the fisheye lens (Kannala-Brandt KB8, TUM-VI 512x512, 1000 features
     over 8 levels), monocular: test_mono_fisheye_slam's 30 frames through
     track_monocular with loop closing on, then a relocalization of a
     fresh view against that map (PnP on the KB8 bearings, K3 on the
     descriptor match);
 17. the non-rectified fisheye stereo rig: test_stereo_fisheye_slam's 25
     pairs (t_rl = (-0.10, 0, 0)) through track_stereo, after
     match_stereo_fisheye on the first pair on the card against the same
     call on the CPU; two K1 launches per frame;
 18. the TUM-VI stereo-inertial rig: 40 frames of the inertial tests' path
     (seed 13) over a KB8 world through track_stereo(imu=);
 19. the dataset drivers, from files written into a temporary directory
     (PNGs and a calibration YAML):
     a. a rectified EuRoC stereo-inertial rig (752x480, baseline 0.11,
        Camera.bf = fx x 0.11, 200 Hz imu0, ground truth CSV; PNG rows
        with libpng's default filter choice, mostly Average and Paeth) on
        the inertial tests' path (seed 13, 40 frames) through run_euroc's
        command line (parse_args, build_system, run); the TUM file it
        writes is read back against the ground truth CSV, and seq.image,
        the decode of a pair, is timed apart;
     b. test_multisequence_session's two EuRoC mono sequences (seed 6, 18 +
        18 frames, 100 s apart, PNGs from the port's filter-0 encoder)
        through run_euroc.run_sequence with the upload_image lookahead:
        the timestamp jump spawns a map; the uploaded image's keypoints
        equal the host array's; the four trajectory writers,
        print_time_stats and a FrameDrawer overlay;
 20. the landmark-sharded global BA (parallel/):
     a. phase 9 again with the loop closer's GBA over
        make_ba_mesh([cuda:0, cuda:0]): phase 9's walls, and every keyframe
        centre within 1e-3 of phase 9's one-device result;
     b. distributed_bundle_adjust at bench_scaling's size (K = 64, M =
        32768, O = 131072, 10 LM iterations) on 1 and 2 in-process shards
        of the card, dense_chunked and pcg: warm ms per LM iteration, peak
        memory, the reductions counted per iteration beside
        collectives_per_iter, the 2-shard poses within 1e-4 of the 1-shard;
     c. multihost_worker at its default problem as 2 spawned ranks on the
        card over gloo (one shard each) and as 1 rank over nccl with 2
        local shards: both converge (test_multihost's walls) and agree with
        an in-process 2-shard solve within 1e-4;
 21. the tracker knobs: the loop-off scenario's first 12 frames with
     klt_refine=False, with refkf_anchor=True and ambig_obs_weight=0.5,
     and with patch_zncc_min=0.3 (split frames), each held to the
     reference's CPU run of the same frames (final state, scaled ATE
     under 1.6x its);
 22. the routes no earlier phase drives:
     a. phase 9 on an inertial map (LoopCloser(inertial=True)): a drift at
        scale 1, the fixed-scale Sim3, the 4-DoF essential graph, the GBA;
        corrected once where the reference corrects on the CPU, at scale
        exactly 1 (tests/test_torch_loop_closing.py);
     b. phase 9 on a stereo map (every observation with its virtual right
        coordinate, TrackerConfig.bf = fx x 0.11): a Sim3, the GBA with the
        stereo row;
     c. an asynchronous mono-inertial session: 16 frames of the seed-11
        path with SystemConfig(async_mapping=True), the IMU init and the
        local inertial BA on the worker (tests/test_torch_async_inertial.py's
        walls);
     d. phase 13's scenario with the worker on, in a session of its own
        (the default path's 40 frames, the noise, the replay): the merge
        comes as the worker's "merge" event and is applied on the
        tracker's thread;
 23. fixed-order sums (ops/segment.py): (a) the last call of each
     converted site, recorded on its main path (the local BA of phase 6,
     a BoW vector of phase 7, the pose graph's normal equations and the
     GBA of phase 9, the local inertial BA of phase 14, the sharded BA of
     20a), replayed 20 times: the same bytes as the main path's call
     every time; two replays before them and two after with index_add_ /
     index_put_ on the card give that order's spread and time beside the
     fixed order's; (b) the loop-off session again, under
     torch.use_deterministic_algorithms(True, warn_only=True): camera
     centres, keyframe poses and landmarks equal to phase 6's bit for bit;
     (c) that mode's warnings over (b) and a replay of each site, by call
     site, after a control (torch.histc on the card) that must warn.
Phase 8 also relocalizes a view of frame 20 with 96 % of its descriptors
randomized: it fails the first pass's 50-inlier acceptance, so the
widening re-search runs (one K2 launch per pass).
Phase 7 also counts the synchronizing calls of its last (warm, fused) frame
under torch.cuda.set_sync_debug_mode("warn"), by call site.
Phases 6-19, 20a, 21 and 22 are the main paths: each resets the kernels' launch
counters just before it and reads them just after; the kernels line sums
them (20b and 20c run the BA alone, which launches no kernel of K1-K3;
23 reruns phase 6 and replays solvers, and is no main path).
Their frames are rendered by worker processes, one per path, while the
kernels build (render_scenario), with the seeds and in the order each
session uses them.  Any
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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "orb_slam3_study_kr_tpu_torch"

# Tolerances.  K1's score/NMS maps are min/max/compare of exact float
# differences: bit-exact.  The blur sums 7 taps in a fixed order with
# round-to-nearest products in both versions; 1e-4 absolute (gray levels
# 0..255) allows for a different multiply-add contraction in the plain
# version's elementwise kernels.  K2's and K3's distances are integer
# popcounts: (best, second, idx) must be identical, and so must
# match_by_descriptor's (idx, ok, best).  match_stereo on the card against
# the CPU: the bar of tests/test_torch_stereo.py (ok on >= 99.5 % of the
# keypoints; where both accept, u_r within 1e-3 px, depth within 1e-4
# relative), since the SAD sums may add in another order.
BLUR_TOL = 1e-4
STEREO_OK_AGREE, STEREO_UR_TOL, STEREO_DEPTH_RTOL = 0.995, 1e-3, 1e-4
# match_stereo_fisheye on the card against the CPU: ok on >= 99.5 % of the
# keypoints, the same right keypoint where both accept, X within 1e-3
# relative there (a ray DLT through cuSOLVER's SVD against LAPACK's).
FE_OK_AGREE, FE_X_RTOL = 0.995, 1e-3
# The fisheye stereo-inertial init's scale on this session as the reference
# reaches it (tests/test_torch_session_records.py, jax 0.9.0 on the CPU),
# and the bound the port is held to around it: the port read 1.10604 on the
# CPU (2.7e-5 relative) and 1.10602 on the card (9e-6); 1e-3 leaves room
# for float-sum order on another card or toolkit, and fails a scale fixed
# at 1 (9.6 % off).
FE_REF_SCALE, FE_SCALE_RTOL = 1.1060104, 1e-3
BASELINE = 0.11

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


def _k1_check(dev, img, cfg):
    """K1 over one frame's pyramid (`cfg`'s level table) against its plain
    version: the score and NMS maps exact on the interior, the blur within
    BLUR_TOL.  Returns (levels, thresholds, max blur err, border pixels
    that differ)."""
    import torch
    from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, orb
    th = (float(cfg.fast_min_threshold), float(cfg.fast_threshold))
    levels = orb.build_pyramid(torch.as_tensor(img, device=dev), cfg)
    ker = cuda_fast.fast_nms_blur_pyramid(levels, *th)
    ref = cuda_fast.fast_nms_blur_pyramid_plain(levels, *th)
    torch.cuda.synchronize()
    max_err = 0.0
    border_diff = 0
    for lvl, (k, r) in enumerate(zip(ker, ref)):
        for name, a, b in zip(("s_raw", "s20", "s7"), k[:3], r[:3]):
            bad = int((a[8:-8, 8:-8] != b[8:-8, 8:-8]).sum())
            if bad:
                raise AssertionError(
                    f"K1 {tuple(levels[0].shape)} level {lvl} {name}: {bad} "
                    "interior pixels differ")
            border_diff += int((a != b).sum())
        err = float((k[3] - r[3]).abs().max())
        if err > BLUR_TOL:
            raise AssertionError(f"K1 {tuple(levels[0].shape)} level {lvl} "
                                 f"blur err {err} > {BLUR_TOL}")
        max_err = max(max_err, err)
    return levels, th, max_err, border_diff


def phase_k1(dev, frame_img, fisheye_img):
    """K1 against its plain version on the two level tables the main paths
    give it: the 752x480 pyramid (timed, the kernels line's row) and the
    fisheye paths' 512x512 one (a frame of the fisheye mono path)."""
    from orb_slam3_study_kr_tpu_torch.utils.profiling import device_ms_per_launch
    from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, orb
    levels, th, max_err, border_diff = _k1_check(dev, frame_img,
                                                 orb.OrbConfig())
    fe_levels, fe_th, fe_err, fe_border = _k1_check(
        dev, fisheye_img, _kb8_tracker(dev).orb_config)
    launch, _ = cuda_fast.fast_nms_blur_pyramid_call(levels, *th)
    device_ms = device_ms_per_launch(launch)
    fe_launch, _ = cuda_fast.fast_nms_blur_pyramid_call(fe_levels, *fe_th)
    fe_device_ms = device_ms_per_launch(fe_launch)
    route_ms = _per_call_ms(lambda: cuda_fast.fast_nms_blur_pyramid(levels, *th))
    plain_ms = _per_call_ms(
        lambda: cuda_fast.fast_nms_blur_pyramid_plain(levels, *th), n=10)
    px = sum(img.numel() for img in levels)
    nbytes, ops = px * (4 + 16), px * K1_OPS_PER_PX
    bound_ms, bound_by = _bound(nbytes, ops)
    fe_px = sum(img.numel() for img in fe_levels)
    fe_bound_ms, fe_bound_by = _bound(fe_px * (4 + 16), fe_px * K1_OPS_PER_PX)
    print(f"phase K1: one launch over 8 levels 480x752..{tuple(levels[-1].shape)}"
          f" ({px} px), maps exact on the interior ({border_diff} border pixels"
          f" differ), blur max_abs_err {max_err:.3g}; device {device_ms:.5f} ms"
          f" per frame, route {route_ms:.5f} ms, plain {plain_ms:.5f} ms; bound"
          f" {bound_ms:.5f} ms by {bound_by} (max({nbytes} B / 3.35 TB/s, "
          f"{ops} op / 67 T/s); {K1_OPS_PER_PX} op/px), device time at "
          f"{bound_ms / device_ms:.3f} of the bound; 512x512 fisheye pyramid "
          f"({len(fe_levels)} levels ..{tuple(fe_levels[-1].shape)}, {fe_px} "
          f"px): maps exact on the interior ({fe_border} border pixels "
          f"differ), blur max_abs_err {fe_err:.3g}; device {fe_device_ms:.5f}"
          f" ms per frame, bound {fe_bound_ms:.5f} ms by {fe_bound_by}")
    return dict(max_abs_err=max(max_err, fe_err), device_ms=device_ms,
                route_ms=route_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, px=px, bytes=nbytes, ops=ops,
                border_diff=border_diff,
                fisheye_512=dict(max_abs_err=fe_err, border_diff=fe_border,
                                 px=fe_px, device_ms=fe_device_ms,
                                 bound_ms=fe_bound_ms, bound_by=fe_bound_by))


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
        torch.cuda.synchronize()       # every stream, the worker's too
        self.counts = {k: f.launches for k, f in self.wrappers.items()}
        return False


N_BLACK, N_REPLAY = 14, 26      # the Atlas phase's noise and replay frames
RELOC_KEEP = 0.04               # descriptors kept in the re-search view
SCENARIOS = ("loop_off", "default", "atlas", "stereo", "rgbd", "async",
             "mono_inertial", "rgbd_inertial", "fisheye_mono",
             "fisheye_stereo", "fisheye_inertial", "driver_si", "driver_mono",
             "async_inertial")
# test_mono_inertial_pipeline (seed 11, 60 frames) and
# test_rgbd_inertial_pipeline (seed 13, 50 frames): one excited trajectory
# with its 200 Hz IMU stream, the init schedule (2.5, 4.0, 5.0) s; phase
# 19a's rectified stereo-inertial rig flies the seed-13 path.
INERTIAL = {"mono_inertial": (11, 60), "rgbd_inertial": (13, 50),
            "fisheye_inertial": (13, 40), "driver_si": (13, 40),
            "async_inertial": (11, 16)}
# Phase 22c, the asynchronous mono-inertial session: the path of seed 11
# cut as tests/test_torch_async_inertial.py cuts it (16 frames, keyframes
# at fps 3, IMU init at 0.9 / 1.5 / 2.1 s, 0.3 s keyframe spacing).
ASYNC_IMU = dict(fps=3, init_times=(0.9, 1.5, 2.1), spacing=0.3)
# Phase 19b: test_multisequence_session's world and path (seed 6), 18 + 18
# frames, the second sequence 100 s after the first.
DRIVER_MONO = (6, 18, (10.0, 110.0))
EUROC_T0_NS = 1403636579763555584      # EuRoC MH_01_easy's first cam0 stamp
IMU_INIT_TIMES = (2.5, 4.0, 5.0)
# TUM-VI's 512x512 Kannala-Brandt lens (tests/test_fisheye_pipeline.py) and
# its stereo rig's extrinsic: p_right = p_left + T_RL.
KB8 = (190.978, 190.973, 254.932, 256.897,
       0.00348238, 0.000715035, -0.00205323, 0.000202936)
T_RL = (-0.10, 0.0, 0.0)
FE_RELOC = (20, 331)    # frame and noise seed of the fisheye relocalization


def _kb8_tracker(dev, **kw):
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    return TrackerConfig(width=512, height=512, fx=KB8[0], fy=KB8[1],
                         cx=KB8[2], cy=KB8[3], dist=KB8[4:],
                         camera_model="kb8", fps=10, device=str(dev), **kw)


def render_scenario(name):
    """The world, ground truth and frames of one main path, rendered from
    its seeds in the order its session uses them, so a worker process gives
    the images rendering in line would.  Returns dict(world, R_gt, t_gt,
    frames), frames as the session's per-frame image arguments."""
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    render = synthetic.render_textured
    if name in ("loop_off", "default", "atlas"):
        n, x_span = (18, 0.5) if name == "loop_off" else (40, 1.0)
        rng = np.random.default_rng(1)
        world = synthetic.make_textured_world(rng, depth=6.0)
        R, t = synthetic.lateral_trajectory(n, x_span=x_span, z_span=0.0,
                                            y_amp=0.0)
        if name == "atlas":
            # Featureless noise (no keypoint passes FAST), then the first
            # N_REPLAY frames of the default path rendered anew.
            rng = np.random.default_rng(13)
            frames = [rng.uniform(0, 8, (480, 752)).astype(np.float32)
                      for _ in range(N_BLACK)]
            frames += [render(world, R[i], t[i], rng=rng)
                       for i in range(N_REPLAY)]
        else:
            frames = [render(world, R[i], t[i], rng=rng) for i in range(n)]
    elif name == "stereo":
        rng = np.random.default_rng(3)
        world = synthetic.make_textured_world(rng, depth=6.0)
        R, t = synthetic.lateral_trajectory(30, x_span=1.0, z_span=0.0,
                                            y_amp=0.0)
        frames = []
        for i in range(30):
            imgL = render(world, R[i], t[i], rng=rng)
            _, t_r = synthetic.stereo_right_pose(R[i], t[i], BASELINE)
            frames.append((imgL, render(world, R[i], t_r, rng=rng)))
    elif name == "rgbd":
        # The first 12 frames of test_rgbd_slam_textured's 20 (cut to hold
        # the script's time).
        rng = np.random.default_rng(7)
        world = synthetic.make_textured_world(rng, depth=6.0)
        R, t = synthetic.lateral_trajectory(20, x_span=0.7, z_span=0.0,
                                            y_amp=0.0)
        R, t = R[:12], t[:12]
        frames = []
        for i in range(12):
            img, depth = render(world, R[i], t[i], rng=rng, return_depth=True)
            frames.append((img, np.where(np.isfinite(depth), depth, 0.0)))
    elif name == "async":
        # The first 26 frames of test_async_mono_pipeline's 40 (cut to hold
        # the script's time).
        rng = np.random.default_rng(5)
        world = synthetic.make_textured_world(rng)
        R, t = synthetic.lateral_trajectory(40, x_span=1.0)
        R, t = R[:26], t[:26]
        frames = [(render(world, R[i], t[i], rng=rng),) for i in range(26)]
    elif name in ("fisheye_mono", "fisheye_stereo"):
        # test_mono_fisheye_slam (noise seed 5, 30 frames) and
        # test_stereo_fisheye_slam (noise seed 9, 25 pairs), world seed 8.
        mono = name == "fisheye_mono"
        n, x_span = (30, 1.0) if mono else (25, 0.9)
        rng = np.random.default_rng(5 if mono else 9)
        world = synthetic.make_textured_world(
            np.random.default_rng(8), width=512, height=512, depth=6.0,
            kb8_params=KB8)
        R, t = synthetic.lateral_trajectory(n, x_span=x_span, z_span=0.0,
                                            y_amp=0.05)
        frames = []
        for i in range(n):
            img = render(world, R[i], t[i], rng=rng)
            t_r = t[i] + np.asarray(T_RL, np.float32)
            frames.append((img,) if mono else
                          (img, render(world, R[i], t_r, rng=rng)))
    elif name in INERTIAL:
        seed, n = INERTIAL[name]
        rng = np.random.default_rng(seed)
        fisheye = name == "fisheye_inertial"
        world = (synthetic.make_textured_world(rng, width=512, height=512,
                                               depth=6.0, kb8_params=KB8)
                 if fisheye else synthetic.make_textured_world(rng, depth=6.0))
        traj = synthetic.inertial_trajectory(
            n, fps=10.0, imu_freq=200.0, rng=rng, amp=(0.45, 0.18, 0.0),
            omega=(1.5, 0.9, 0.0), rot_amp=(0.0, 0.0, 0.0))
        R, t = traj["R_cw"], traj["t_cw"]
        frames = []
        for i in range(n):
            if name in ("mono_inertial", "async_inertial"):
                frames.append((render(world, R[i], t[i], rng=rng),))
            elif fisheye:
                t_r = t[i] + np.asarray(T_RL, np.float32)
                frames.append((render(world, R[i], t[i], rng=rng),
                               render(world, R[i], t_r, rng=rng)))
            elif name == "driver_si":
                _, t_r = synthetic.stereo_right_pose(R[i], t[i], BASELINE)
                frames.append((render(world, R[i], t[i], rng=rng),
                               render(world, R[i], t_r, rng=rng)))
            else:
                img, depth = render(world, R[i], t[i], rng=rng,
                                    return_depth=True)
                frames.append((img, np.where(np.isfinite(depth), depth, 0.0)))
        return dict(world=world, R_gt=R, t_gt=t, frames=frames,
                    imu=traj["imu"], timestamps=traj["timestamps"],
                    bias=traj["bias"])
    elif name == "driver_mono":
        seed, n, _ = DRIVER_MONO
        rng = np.random.default_rng(seed)
        world = synthetic.make_textured_world(rng, depth=6.0)
        R, t = synthetic.lateral_trajectory(2 * n, x_span=1.6, z_span=0.0,
                                            y_amp=0.05)
        frames = [render(world, R[i], t[i], rng=rng) for i in range(2 * n)]
    else:
        raise ValueError(f"unknown scenario {name!r}")
    return dict(world=world, R_gt=R, t_gt=t, frames=frames)


def _lateral_session(dev, scen, loop_closing):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    world, R_gt, t_gt, imgs = (scen[k] for k in ("world", "R_gt", "t_gt",
                                                 "frames"))
    n = len(imgs)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   enable_loop_closing=loop_closing,
                                   device=str(dev)))
    syncs = None
    with _Launches() as counter:
        t0 = time.perf_counter()
        for i in range(n):
            if loop_closing and i == n - 1:
                fused = slam.tracker.stats.get("fused_frames", 0)
                syncs = _count_syncs(lambda: slam.track_monocular(imgs[i],
                                                                  i * 0.1))
                syncs["fused"] = slam.tracker.stats["fused_frames"] > fused
            else:
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
    m = slam.atlas.active_map
    state = dict(centres=rows[:, 1:4].copy(), kf_R=m.kf_R[m.kf_valid].copy(),
                 kf_t=m.kf_t[m.kf_valid].copy(),
                 landmarks=m.lm_pos[m.lm_valid].copy())
    return slam, world, R_gt, t_gt, dict(state=state,
        ate=rmse, nm=nm, n_kf=stats["n_kf"], n_lm=stats["n_lm"],
        frame_ms_median_warm=float(np.median(warm)),
        frame_ms=[float(x) for x in np.asarray(slam.timings) * 1e3],
        stages=stats["stages"], stage_medians=stages, loops=stats["loops"],
        launches=counter.counts, fused_frames=fused, wall_s=wall, syncs=syncs)


def _count_syncs(fn):
    """Run ``fn`` under torch.cuda.set_sync_debug_mode("warn") and count
    the warnings it raises by call site (the port's file and line)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return dict(total=sum(sites.values()),
                sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])))


def phase_loop_off(dev, scen):
    n = len(scen["frames"])
    *_, r = _lateral_session(dev, scen, loop_closing=False)
    if not (r["n_kf"] >= 3 and r["nm"] > 10 and r["ate"] < 0.05):
        raise AssertionError(f"n_kf {r['n_kf']} nm {r['nm']} ATE {r['ate']}")
    print(f"phase loop-off path: {n} frames state OK, n_kf {r['n_kf']}, ATE "
          f"{r['ate']:.5f} over {r['nm']} frames; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms; launches {r['launches']} over "
          f"{r['fused_frames']} fused frames")
    return r


def phase_default(dev, scen):
    n = len(scen["frames"])
    slam, world, R_gt, t_gt, r = _lateral_session(dev, scen, loop_closing=True)
    if not (r["n_kf"] >= 3 and r["nm"] > 25 and r["ate"] < 0.06):
        raise AssertionError(f"n_kf {r['n_kf']} nm {r['nm']} ATE {r['ate']}")
    if slam.voc is None or slam.db is None or len(slam.db.vectors) < 5:
        raise AssertionError("vocabulary / database not built")
    if r["loops"].get("n_queries", 0) < 1:
        raise AssertionError(f"loop closer not queried: {r['loops']}")
    if "loop/detect_correct" not in r["stage_medians"]:
        raise AssertionError("no loop/detect_correct stage")
    sy = r["syncs"]
    if not sy["fused"]:
        raise AssertionError("the sync-counted last frame took no fused rounds")
    print(f"phase default-config path: {n} frames, loop closing on, state OK, "
          f"n_kf {r['n_kf']}, n_lm {r['n_lm']}, ATE {r['ate']:.5f} over "
          f"{r['nm']} frames; vocabulary {slam.voc.n_words} words, database "
          f"{len(slam.db.vectors)} keyframes, loop stats {json.dumps(r['loops'])}; "
          f"warm per-frame median {r['frame_ms_median_warm']:.2f} ms, wall "
          f"{r['wall_s']:.2f} s; stage medians (ms) {json.dumps(r['stage_medians'])}; "
          f"launches {r['launches']} over {r['fused_frames']} fused frames")
    print(f"phase sync count: the default session's last frame ({n}, warm, "
          f"fused) under set_sync_debug_mode('warn'): {sy['total']} "
          f"synchronizing calls at {len(sy['sites'])} call sites "
          f"{json.dumps(sy['sites'])}")
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
    # A view that fails the first pass's 50-inlier acceptance: frame 20 with
    # all but RELOC_KEEP of its descriptors randomized, so the widening
    # re-search (wide, then narrow, each a K2 match) runs after the PnP
    # pose (on the CPU: 35 inliers, both passes, a weak relocalization).
    slam.sys_stats.clear()
    img = synthetic.render_textured(world, R_gt[20], t_gt[20],
                                    rng=np.random.default_rng(324))
    feats = orb.extract_orb(torch.as_tensor(img, device=dev), cfg)
    host = {k: getattr(feats, k).cpu().numpy().copy()
            for k in ("uv", "level", "angle", "response", "desc", "valid")}
    g = np.random.default_rng(325)
    bad = g.random(host["desc"].shape[0]) >= RELOC_KEEP
    host["desc"][bad] = g.integers(0, 2, (int(bad.sum()), 256), dtype=np.uint8)
    frame = Frame(frame_id=10_020, timestamp=119.0, device=dev, **host)
    with _Launches() as research:
        t0 = time.perf_counter()
        ok = slam._relocalize(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    rstats = dict(slam.sys_stats)
    if rstats.get("n_reloc_research", 0) < 1 or research.counts["gated_nn"] < 1:
        raise AssertionError(f"the degraded view did not reach the re-search: "
                             f"{rstats}, launches {research.counts}")
    out["research"] = dict(ms=ms, ok=bool(ok), stats=rstats,
                        n_good=int((frame.kp_lm != NO_LM).sum()),
                        launches=research.counts)
    launches = {k: counter.counts[k] + research.counts[k]
                for k in counter.counts}
    print(f"phase relocalization: frames 14 and 26 recovered {out}; stats "
          f"{stats}; launches {counter.counts} over {searched} candidates "
          f"searched; degraded view of frame 20: re-search {rstats}, "
          f"{'relocalized' if ok else 'not relocalized'}, {ms:.2f} ms, "
          f"launches {research.counts}")
    return dict(frames=out, stats=stats, launches=launches)


def phase_atlas(dev, slam, scen):
    """The default session goes on: a blackout spawns a second map, the
    replayed path welds it back, and the Atlas is saved, loaded into a fresh
    session and relocalized against."""
    import tempfile
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.ops import orb
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.frame import Frame
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    world, R_gt, t_gt = scen["world"], scen["R_gt"], scen["t_gt"]
    n_first, n_black, n_replay = len(slam.timings), N_BLACK, N_REPLAY
    noise, replay = scen["frames"][:n_black], scen["frames"][n_black:]
    ts0 = n_first * 0.1
    m0 = slam.atlas.active_map
    slam.sys_stats.clear()
    merged_at = None
    with _Launches() as counter:
        t0 = time.perf_counter()
        for j, img in enumerate(noise):
            slam.track_monocular(img, ts0 + j * 0.1)
        n_maps_spawned = len(slam.atlas.maps)
        for i, img in enumerate(replay):
            slam.track_monocular(img, ts0 + (n_black + i) * 0.1)
            if merged_at is None and len(slam.atlas.maps) == 1:
                merged_at = i
        torch.cuda.synchronize()
        session_s = time.perf_counter() - t0
        merger = dict(slam.merger.stats)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "atlas.npz")
            t0 = time.perf_counter()
            slam.save_atlas(path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            slam2 = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                            device=str(dev)))
            slam2.load_atlas(path)
            load_s = time.perf_counter() - t0
        img = synthetic.render_textured(world, R_gt[6], t_gt[6],
                                        rng=np.random.default_rng(323))
        feats = orb.extract_orb(torch.as_tensor(img, device=dev),
                                slam.cfg.tracker.orb_config)
        frame = Frame(frame_id=20_000, timestamp=199.0, device=dev,
                      **{k: getattr(feats, k).cpu().numpy().copy()
                         for k in ("uv", "level", "angle", "response", "desc",
                                   "valid")})
        t0 = time.perf_counter()
        reloc_ok = slam2._relocalize(frame)
        torch.cuda.synchronize()
        reloc_ms = (time.perf_counter() - t0) * 1e3
    if n_maps_spawned != 2:
        raise AssertionError(f"the blackout left {n_maps_spawned} maps")
    if merged_at is None or len(slam.atlas.maps) != 1:
        raise AssertionError(f"the maps were never welded: {len(slam.atlas.maps)} "
                             f"maps, merger {merger}")
    m = slam.atlas.active_map
    if m is not m0 or m.n_kf <= 0 or slam.tracker.map is not m:
        raise AssertionError("the session is not on the stored map after the merge")
    for a, b in zip(slam.atlas.maps, slam2.atlas.maps):
        for f in SlamSystem.ATLAS_ARRAY_FIELDS:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"loaded Atlas differs in {f}")
    if slam2.state != TrackState.RECENTLY_LOST or not reloc_ok:
        raise AssertionError(f"the loaded Atlas did not relocalize "
                             f"({slam2.state}, {slam2.sys_stats})")
    k1, k2, k3 = (counter.counts[k] for k in ("fast_nms_blur", "gated_nn",
                                              "hamming_nn"))
    n_ext = n_black + n_replay + 1
    if k1 != n_ext:
        raise AssertionError(f"atlas: K1 launched {k1} times, expected one per "
                             f"extracted frame ({n_ext})")
    fused = slam.tracker.stats.get("fused_frames", 0)
    if fused < 1 or k2 < 4 * fused:
        raise AssertionError(f"atlas: K2 launched {k2} times over {fused} "
                             "fused frames")
    searched = slam2.sys_stats.get("n_reloc_searched", 0)
    if k3 < 1 or k3 < merger["n_attempts"] + searched:
        raise AssertionError(f"atlas: K3 launched {k3} times over "
                             f"{merger['n_attempts']} verifications and "
                             f"{searched} relocalization candidates")
    rows = slam.trajectory()
    if not np.isfinite(rows[:, 1:]).all():
        raise AssertionError("atlas: non-finite trajectory")
    centers = _centers(R_gt, t_gt)
    gt_ts = np.concatenate([np.arange(n_first) * 0.1,
                            ts0 + (n_black + np.arange(n_replay)) * 0.1])
    gt_xyz = np.concatenate([centers[:n_first], centers[:n_replay]])
    ate, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], gt_ts, gt_xyz, True)
    if not (nm > n_first and ate < 0.25):
        raise AssertionError(f"atlas: post-merge scaled ATE {ate} over {nm}")
    stages = slam.tracker.timers.summary()
    times = np.asarray(slam.timings[n_first + n_black:]) * 1e3
    before, after = times[:merged_at], times[merged_at + 1:]
    r = dict(
        merged_at_replay_frame=merged_at, merger=merger,
        merge_ms=stages["atlas/merge"]["max_ms"],
        welding_ba_ms=stages["atlas/welding_ba"]["max_ms"],
        verify_ms_median=stages["atlas/verify"]["median_ms"],
        frame_ms_median_before=float(np.median(before)) if before.size else None,
        frame_ms_median_after=float(np.median(after)) if after.size else None,
        merge_frame_ms=float(times[merged_at]), ate_scaled=ate, nm=nm,
        n_kf=m.n_kf, n_lm=m.n_lm, session_s=session_s, save_s=save_s,
        load_s=load_s, reloc_ms=reloc_ms, reloc_stats=dict(slam2.sys_stats),
        fused_frames=fused, launches=counter.counts)
    print(f"phase Atlas path: {n_black} noise frames spawned map 2; replay "
          f"frame {merged_at} of {n_replay} welded it into the stored map "
          f"(merger {json.dumps(merger)}; merge {r['merge_ms']:.2f} ms with "
          f"welding BA {r['welding_ba_ms']:.2f} ms, verify median "
          f"{r['verify_ms_median']:.2f} ms; the merge frame "
          f"{r['merge_frame_ms']:.2f} ms); frame medians before / after the "
          f"merge {r['frame_ms_median_before']} / {r['frame_ms_median_after']} "
          f"ms; post-merge scaled ATE {ate:.5f} over {nm} frames, n_kf "
          f"{m.n_kf}; save {save_s:.2f} s, load {load_s:.2f} s, tables "
          f"identical, relocalization against the loaded Atlas {reloc_ms:.2f} "
          f"ms {json.dumps(r['reloc_stats'])}; launches {counter.counts} over "
          f"{fused} fused frames")
    return r


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


# The revisits' drift scale per ring (phase 9 and 22a-b): the monocular
# map drifts in scale, an inertial one keeps it, a stereo one drifts a
# little (tests/test_torch_loop_closing.py's DRIFT).
RING_SCALE = {"mono": 1.06, "inertial": 1.0, "stereo": 1.02}


def _build_ring(cfg, seed=11, kind="mono"):
    """The ring map; on the stereo ring (cfg.bf > 0) every observation
    carries its virtual right coordinate u - bf / z."""
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
        return uv.astype(np.float32), vis, z

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
        uv, vis, z = project(Rg, tg, X)
        sel = np.nonzero(vis)[0][: m.max_kp]
        d = desc[sel].copy()
        for i in range(sel.size):
            d[i, rng.integers(0, 256, 6)] ^= 1
        tgt = lm_ids[sel] if bind_ids is None else bind_ids[sel]
        uv_obs = uv[sel] + rng.normal(0, 0.3, (sel.size, 2)).astype(np.float32)
        ur = ((uv_obs[:, 0] - cfg.bf / z[sel]).astype(np.float32)
              if cfg.bf > 0 else None)
        m.add_keyframe(
            R, t, uv_obs,
            np.zeros(sel.size, np.int32), np.zeros(sel.size, np.float32),
            np.ones(sel.size, bool), d, frame_id=m.next_kf,
            timestamp=float(m.next_kf), kp_lm=tgt, ur=ur)
        gt.append((Rg, tg))

    for k in range(N_FIRST):
        add_kf(*_ring_pose(2 * np.pi * k / N_FIRST))
    Rd, td, sd = (a.numpy() for a in exp_sim3(torch.tensor(
        [0.0, 0.05, 0.0, 0.15, 0.05, -0.1, np.log(RING_SCALE[kind])],
        dtype=torch.float32)))
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


def phase_loop_correction(dev, ba_mesh=None, kind="mono"):
    """Phase 9; with ``ba_mesh`` (phase 20a) the GBA runs over its shards;
    ``kind`` "inertial" (22a: the fixed-scale Sim3 and the 4-DoF essential
    graph) or "stereo" (22b: a Sim3, then the GBA with the stereo row) runs
    that ring."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase, train_vocabulary
    from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import LoopCloser
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    cfg = TrackerConfig(fps=10, device=str(dev))
    if kind == "stereo":
        cfg = TrackerConfig(fps=10, bf=cfg.fx * BASELINE, device=str(dev))
    m, dups, gt = _build_ring(cfg, kind=kind)
    valid = np.nonzero(m.kf_valid)[0]
    descs = m.kf_desc[valid][m.kf_kp_valid[valid]][:4000]
    voc = train_vocabulary(descs, k=8, L=3, seed=0, device=dev)
    lc = LoopCloser(cfg=cfg, map=m, db=KeyframeDatabase(voc=voc), run_gba=True,
                    ba_mesh=ba_mesh, inertial=kind == "inertial")
    scales, correct = [], lc._correct
    lc._correct = lambda kf, cand, sim3: (scales.append(float(sim3["s12"])),
                                          correct(kf, cand, sim3))[1]
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
    if st["n_gba"] != 1 or (kind == "mono" and not (
            alive < 0.5 and st["n_fused_loop"] > 50)):
        raise AssertionError(f"duplicates alive {alive}, stats {st}")
    if kind == "inertial" and scales != [1.0]:
        raise AssertionError(f"inertial: correction scales {scales}, not 1")
    if counter.counts["gated_nn"] < 1 or counter.counts["hamming_nn"] < 1:
        raise AssertionError(f"launches {counter.counts}")
    centres = [m.kf_center(kf).tolist() for kf in range(m.next_kf)]
    name = dict(mono="loop correction", inertial="22a inertial loop (9i)",
                stereo="22b stereo loop")[kind]
    if ba_mesh is None:
        print(f"phase {name}: ring world {m.next_kf} keyframes "
              f"corrected once at {at[0]}, scale {scales}; revisit centre "
              f"errors {[round(e, 5) for e in errs]}; live share of "
              f"duplicates {alive:.4f}; stats {json.dumps(st)}; {wall:.2f} s; "
              f"launches {counter.counts}")
    return dict(corrected_at=at, centre_err=errs, dup_alive=alive, stats=st,
                scales=scales, wall_s=wall, launches=counter.counts,
                centres=centres)


def _centers(R_gt, t_gt):
    import numpy as np
    return -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)


def _sensor_session(dev, sensor, frames, R_gt, t_gt, dt, final_ok=True,
                    need_fused=True, **cfg_kw):
    """Drive one session through its public entry point with the launch
    counters reset around it; returns (slam, result dict).  The final state
    must be OK, or with final_ok=False anything but LOST; with need_fused
    the session must take fused frames."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackState
    n = len(frames)
    slam = SlamSystem(SystemConfig(sensor=sensor, device=str(dev), **cfg_kw))
    track = dict(mono=slam.track_monocular, stereo=slam.track_stereo,
                 rgbd=slam.track_rgbd)[sensor]
    with _Launches() as counter:
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            track(*f, i * dt)
        slam.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if slam.state != TrackState.OK and (final_ok
                                        or slam.state == TrackState.LOST):
        raise AssertionError(f"{sensor}: final state {slam.state}")
    rows = slam.trajectory()
    if not np.isfinite(rows[:, 1:]).all():
        raise AssertionError(f"{sensor}: non-finite trajectory")
    ts = np.arange(n) * dt
    metric, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, _centers(R_gt, t_gt),
                             with_scale=False)
    scaled, _, s_fit = ate_rmse(rows[:, 0], rows[:, 1:4], ts,
                                _centers(R_gt, t_gt), with_scale=True)
    stats = slam.stats()
    fused = slam.tracker.stats.get("fused_frames", 0)
    k2 = counter.counts["gated_nn"]
    if (need_fused and fused < 1) or k2 < 4 * fused:
        raise AssertionError(f"{sensor}: K2 launched {k2} times over {fused} "
                             "fused frames")
    warm = np.asarray(slam.timings[5:]) * 1e3
    stages = {k: round(v["median_ms"], 3) for k, v in stats["stages"].items()}
    return slam, dict(
        state=slam.state.name, ate_metric=metric, ate_scaled=scaled,
        scale=s_fit, nm=nm,
        n_kf=stats["n_kf"], n_lm=stats["n_lm"], loops=stats["loops"],
        mapper=stats["mapper"], frame_ms_median_warm=float(np.median(warm)),
        frame_ms=[float(x) for x in np.asarray(slam.timings) * 1e3],
        stage_medians=stages, launches=counter.counts, fused_frames=fused,
        wall_s=wall)


def _stereo_match_check(dev, imgL, imgR):
    """match_stereo on the card against the same call on the CPU, on the
    card's features of one pair."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.ops import orb, stereo
    cfg = orb.OrbConfig()
    fL = orb.extract_orb(torch.as_tensor(imgL, device=dev), cfg)
    fR = orb.extract_orb(torch.as_tensor(imgR, device=dev), cfg)
    args = (fL.uv, fL.level, fL.desc, fL.valid, fR.uv, fR.level, fR.desc,
            fR.valid, torch.as_tensor(imgL, device=dev),
            torch.as_tensor(imgR, device=dev), 458.0, BASELINE)
    gu, gd, gok = [a.cpu().numpy() for a in stereo.match_stereo(*args)]
    cu, cd, cok = [a.numpy() for a in stereo.match_stereo(
        *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])]
    both = gok & cok
    agree = float((gok == cok).mean())
    ur_err = float(np.abs(gu[both] - cu[both]).max())
    d_err = float((np.abs(gd[both] - cd[both]) / cd[both]).max())
    if cok.sum() < 250 or agree < STEREO_OK_AGREE or ur_err >= STEREO_UR_TOL \
            or d_err >= STEREO_DEPTH_RTOL:
        raise AssertionError(f"match_stereo card vs CPU: {int(cok.sum())} "
                             f"accepted, ok agreement {agree}, u_r err "
                             f"{ur_err}, depth rel err {d_err}")
    return dict(n_ok=int(gok.sum()), ok_agree=agree, ur_max_err=ur_err,
                depth_max_rel_err=d_err)


def phase_stereo(dev, scen):
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    R_gt, t_gt, pairs = scen["R_gt"], scen["t_gt"], scen["frames"]
    n = len(pairs)
    check = _stereo_match_check(dev, *pairs[0])
    _, r = _sensor_session(dev, "stereo", pairs, R_gt, t_gt, 0.1,
                           baseline=BASELINE,
                           tracker=TrackerConfig(fps=10, device=str(dev)))
    k1 = r["launches"]["fast_nms_blur"]
    if k1 != 2 * n:
        raise AssertionError(f"stereo: K1 launched {k1} times, expected two "
                             f"per frame ({2 * n})")
    if not (r["nm"] > 20 and r["ate_metric"] < 0.15
            and abs(r["scale"] - 1.0) < 0.10):
        raise AssertionError(f"stereo: nm {r['nm']} metric ATE "
                             f"{r['ate_metric']} scale {r['scale']}")
    if "track/stereo_match" not in r["stage_medians"]:
        raise AssertionError("stereo: no track/stereo_match stage")
    print(f"phase stereo path: match_stereo card vs CPU on the first pair "
          f"{json.dumps(check)}; {n} frames, loop closing on, state OK, n_kf "
          f"{r['n_kf']}, n_lm {r['n_lm']}, metric ATE {r['ate_metric']:.5f} "
          f"over {r['nm']} frames, scale {r['scale']:.5f}; warm per-frame "
          f"median {r['frame_ms_median_warm']:.2f} ms, wall {r['wall_s']:.2f} "
          f"s; stage medians (ms) {json.dumps(r['stage_medians'])}; launches "
          f"{r['launches']} over {r['fused_frames']} fused frames")
    return dict(r, match_check=check)


def phase_rgbd(dev, scen):
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    R_gt, t_gt, frames = scen["R_gt"], scen["t_gt"], scen["frames"]
    n = len(frames)
    # 12 frames of test_rgbd_slam_textured's 20: its nm > 12 of 20 scales
    # to nm > 7 of 12.
    _, r = _sensor_session(dev, "rgbd", frames, R_gt, t_gt, 0.1,
                           baseline=BASELINE,
                           tracker=TrackerConfig(fps=10, device=str(dev)))
    k1 = r["launches"]["fast_nms_blur"]
    if k1 != n:
        raise AssertionError(f"rgbd: K1 launched {k1} times, expected one per "
                             f"frame ({n})")
    if not (r["nm"] > 7 and r["ate_metric"] < 0.15):
        raise AssertionError(f"rgbd: nm {r['nm']} metric ATE {r['ate_metric']}")
    print(f"phase RGB-D path: {n} frames, loop closing on, state OK, n_kf "
          f"{r['n_kf']}, metric ATE {r['ate_metric']:.5f} over {r['nm']} "
          f"frames; warm per-frame median {r['frame_ms_median_warm']:.2f} ms, "
          f"wall {r['wall_s']:.2f} s; stage medians (ms) "
          f"{json.dumps(r['stage_medians'])}; launches {r['launches']} over "
          f"{r['fused_frames']} fused frames")
    return r


def phase_async(dev, scen, sync_warm_ms):
    R_gt, t_gt, frames = scen["R_gt"], scen["t_gt"], scen["frames"]
    n = len(frames)
    # 26 frames of test_async_mono_pipeline's 40: its nm > 25 of 40 scales
    # to nm > 16 of 26.
    # The final state is not held: the pose sanity gate (relative to the
    # recent steps) fires once or twice in this session, synchronous or
    # not, and with the worker the frame it fires at depends on its timing;
    # the reference's asynchronous session ends RECENTLY_LOST too
    # (tests/test_torch_session_records.py, one of three CPU runs).
    slam, r = _sensor_session(dev, "mono", frames, R_gt, t_gt, 0.05,
                              final_ok=False, async_mapping=True)
    worker = dict(slam.async_map.stats)
    slam.shutdown()
    k1 = r["launches"]["fast_nms_blur"]
    if k1 != n:
        raise AssertionError(f"async: K1 launched {k1} times, expected {n}")
    if not (worker["n_processed"] > 0 and worker["n_errors"] == 0
            and r["mapper"]["n_created"] > 0 and r["mapper"]["n_ba"] > 0):
        raise AssertionError(f"async: worker {worker} mapper {r['mapper']}")
    if not (r["nm"] > 16 and r["ate_scaled"] < 0.4):
        raise AssertionError(f"async: nm {r['nm']} scaled ATE {r['ate_scaled']}")
    print(f"phase async mapping path: {n} frames, final state {r['state']}, "
          f"sanity-gate rejections {slam.tracker.stats.get('sanity_fail', 0)}, "
          f"worker {worker}, "
          f"n_kf {r['n_kf']}, mapper n_created {r['mapper']['n_created']} "
          f"n_ba {r['mapper']['n_ba']}, scaled ATE {r['ate_scaled']:.5f} over "
          f"{r['nm']} frames; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms (the synchronous default "
          f"session of this run: {sync_warm_ms:.2f} ms), wall "
          f"{r['wall_s']:.2f} s; stage medians (ms) "
          f"{json.dumps(r['stage_medians'])}; launches {r['launches']} over "
          f"{r['fused_frames']} fused frames")
    return dict(r, worker=worker, sync_frame_ms_median_warm=sync_warm_ms)


def _round_medians(t_ms, stages, rounds):
    """The frame times (ms) of the fused frames after the first five and of
    the split frames, frames whose IMU stage changed left out."""
    import numpy as np
    st, rd = np.asarray(stages), np.asarray(rounds)
    steady = np.r_[False, st[1:] == st[:-1]]
    warm = np.arange(len(st)) >= 5
    return (t_ms[warm & steady & (rd[:, 0] > 0) & (rd[:, 1] == 0)],
            t_ms[steady & (rd[:, 1] > 0) & (rd[:, 0] == 0)])


def _inertial_session(dev, scen, sensor, tracker=None,
                      init_times=IMU_INIT_TIMES, spacing=None, need_split=True,
                      **cfg_kw):
    """One inertial session through its public entry point (imu= rows per
    frame), launch counters reset around it; per-frame times kept apart by
    the rounds each frame took (the tracker's fused and split counters),
    frames whose IMU stage changed left out.  ``tracker`` (default: the
    pinhole TrackerConfig(fps=10)), ``init_times`` and ``cfg_kw`` go to the
    SystemConfig; ``spacing`` sets the tracker's imu_init_spacing; with the
    worker on, the session is flushed before it is read."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    frames, imu, ts = scen["frames"], scen["imu"], scen["timestamps"]
    n = len(frames)
    slam = SlamSystem(SystemConfig(
        sensor=sensor, imu_init_times=init_times, baseline=BASELINE,
        tracker=tracker or TrackerConfig(fps=10, device=str(dev)),
        device=str(dev), **cfg_kw))
    if spacing is not None:
        slam.tracker.imu_init_spacing = spacing
    track = dict(mono=slam.track_monocular, rgbd=slam.track_rgbd,
                 stereo=slam.track_stereo)[sensor.split("-")[0]]
    per_frame = 2 if sensor.startswith("stereo") else 1
    stages, rounds = [], []
    with _Launches() as counter:
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            before = [slam.tracker.stats.get(k, 0)
                      for k in ("fused_frames", "split_frames")]
            track(*f, ts[i], imu=imu[i])
            stages.append(slam.tracker.imu_stage)
            rounds.append([slam.tracker.stats.get(k, 0) - b for k, b in
                           zip(("fused_frames", "split_frames"), before)])
        slam.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = slam.tracker
    if slam.state not in (TrackState.OK, TrackState.RECENTLY_LOST):
        raise AssertionError(f"{sensor}: final state {slam.state}")
    if tr.imu_stage < 1:
        raise AssertionError(f"{sensor}: IMU initialization never accepted")
    rows = slam.trajectory()
    if not np.isfinite(rows[:, 1:]).all():
        raise AssertionError(f"{sensor}: non-finite trajectory")
    cen = _centers(scen["R_gt"], scen["t_gt"])
    metric, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, cen,
                             with_scale=False)
    scaled, _, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, cen, with_scale=True)
    k1, k2 = counter.counts["fast_nms_blur"], counter.counts["gated_nn"]
    fused = tr.stats.get("fused_frames", 0)
    split = tr.stats.get("split_frames", 0)
    if k1 != per_frame * n:
        raise AssertionError(f"{sensor}: K1 launched {k1} times, expected "
                             f"{per_frame} per frame ({per_frame * n})")
    if (need_split and split < 1) or k2 < 4 * fused + 2 * split:
        raise AssertionError(f"{sensor}: K2 launched {k2} times over {fused} "
                             f"fused and {split} split frames")
    t_ms = np.asarray(slam.timings) * 1e3
    st = np.asarray(stages)
    before, after = _round_medians(t_ms, stages, rounds)
    summ = tr.timers.summary()
    imu_init = {k: dict(n=v["n"], median_ms=v["median_ms"], max_ms=v["max_ms"])
                for k, v in summ.items() if k.startswith("imu/init")}
    local_ba = {k: dict(n=summ[k]["n"], median_ms=summ[k]["median_ms"])
                for k in ("mapping/local_ba", "mapping/local_inertial_ba")
                if k in summ}
    init_at = int(np.argmax(st >= 1))
    return slam, dict(
        state=slam.state.name, imu_stage=tr.imu_stage,
        stage_at=[int(np.argmax(st >= s)) if (st >= s).any() else None
                  for s in (1, 2, 3)],
        imu_init_scale=tr.stats.get("imu_init_scale"),
        imu_refine_scale=tr.stats.get("imu_refine_scale"),
        bias=tr.bias.tolist(), bias_true=scen["bias"].tolist(),
        ate_metric=metric, ate_scaled=scaled, nm=nm,
        n_kf=int(slam.atlas.active_map.kf_valid.sum()),
        frame_ms_median_fused=float(np.median(before)) if before.size else None,
        frame_ms_median_split=float(np.median(after)) if after.size else None,
        n_fused_timed=int(before.size), n_split_timed=int(after.size),
        init_frame_ms=float(t_ms[init_at]), imu_init=imu_init,
        local_ba=local_ba, fused_frames=fused, split_frames=split,
        inertial_solves=tr.stats.get("inertial_solves", 0),
        n_inertial_ba=tr.stats.get("n_inertial_ba", 0),
        launches=counter.counts, wall_s=wall,
        frame_ms=[float(x) for x in t_ms], stages=stages)


def _inertial_line(name, r):
    return (f"phase {name} path: {len(r['frame_ms'])} frames, final state "
            f"{r['state']}, IMU stage {r['imu_stage']} (stages reached at "
            f"frames {r['stage_at']}), init scale {r['imu_init_scale']:.5f}"
            f" (latest {r['imu_refine_scale']:.5f}), bias "
            f"{[round(b, 5) for b in r['bias']]} (true "
            f"{[round(b, 5) for b in r['bias_true']]}); metric ATE "
            f"{r['ate_metric']:.5f}, scaled {r['ate_scaled']:.5f} over "
            f"{r['nm']} frames, n_kf {r['n_kf']}; frame medians: fused "
            f"{r['frame_ms_median_fused']} ms ({r['n_fused_timed']} frames), "
            f"split {r['frame_ms_median_split']} ms ({r['n_split_timed']} "
            f"frames), init frame {r['init_frame_ms']:.2f} ms; imu/init "
            f"{json.dumps(r['imu_init'])}; local BA {json.dumps(r['local_ba'])}"
            f"; {r['inertial_solves']} pose-inertial solves, "
            f"{r['n_inertial_ba']} inertial BAs; wall {r['wall_s']:.2f} s; "
            f"launches {r['launches']} over {r['fused_frames']} fused and "
            f"{r['split_frames']} split frames")


def phase_mono_inertial(dev, scen):
    import numpy as np
    _, r = _inertial_session(dev, scen, "mono-inertial")
    s = r["imu_init_scale"]
    bg_err = float(np.abs(np.asarray(r["bias"][:3])
                          - np.asarray(r["bias_true"][:3])).max())
    if not (s is not None and 1.5 < s < 30.0):
        raise AssertionError(f"mono-inertial: init scale {s}")
    if bg_err >= 3e-3:
        raise AssertionError(f"mono-inertial: gyro bias error {bg_err}")
    if not (r["nm"] > 40 and r["ate_scaled"] < 0.35):
        raise AssertionError(f"mono-inertial: nm {r['nm']} scaled ATE "
                             f"{r['ate_scaled']}")
    print(_inertial_line("mono-inertial", r) + f"; gyro bias error {bg_err!r}"
          f", init scale {s!r}")
    return dict(r, gyro_bias_err=bg_err)


def phase_rgbd_inertial(dev, scen):
    _, r = _inertial_session(dev, scen, "rgbd-inertial")
    s = r["imu_init_scale"]
    if not (s is not None and 0.8 < s < 1.25):
        raise AssertionError(f"rgbd-inertial: init scale {s}")
    if not (r["nm"] > 35 and r["ate_metric"] < 0.25):
        raise AssertionError(f"rgbd-inertial: nm {r['nm']} metric ATE "
                             f"{r['ate_metric']}")
    print(_inertial_line("RGB-D-inertial", r))
    return r


def phase_async_inertial(dev, scen):
    """22c: the mono-inertial session with the mapping worker on, cut as
    ASYNC_IMU says; held to walls (the worker's timing makes it
    nondeterministic), as tests/test_torch_async_inertial.py holds both
    packages on the CPU."""
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    n = len(scen["frames"])
    slam, r = _inertial_session(
        dev, scen, "mono-inertial",
        tracker=TrackerConfig(fps=ASYNC_IMU["fps"], device=str(dev)),
        init_times=ASYNC_IMU["init_times"], spacing=ASYNC_IMU["spacing"],
        need_split=False, async_mapping=True, enable_loop_closing=False)
    worker, errors = dict(slam.async_map.stats), slam.async_map.pop_errors()
    slam.shutdown()
    if not (worker["n_processed"] > 0 and worker["n_errors"] == 0
            and not errors):
        raise AssertionError(f"async inertial: worker {worker}, {errors}")
    if r["n_inertial_ba"] < 1:
        raise AssertionError("async inertial: no local inertial BA ran")
    if not (r["nm"] > n // 2 and r["ate_scaled"] < 0.35):
        raise AssertionError(f"async inertial: nm {r['nm']} scaled ATE "
                             f"{r['ate_scaled']}")
    print(f"phase 22c async mono-inertial path: {n} frames, final state "
          f"{r['state']}, IMU stage {r['imu_stage']} (reached at frames "
          f"{r['stage_at']}), init scale {r['imu_init_scale']}; worker "
          f"{worker}; {r['n_inertial_ba']} local inertial BAs; scaled ATE "
          f"{r['ate_scaled']:.5f} over {r['nm']} frames; frame medians fused "
          f"{r['frame_ms_median_fused']} / split {r['frame_ms_median_split']} "
          f"ms; wall {r['wall_s']:.2f} s; launches {r['launches']} over "
          f"{r['fused_frames']} fused and {r['split_frames']} split frames")
    return dict(r, worker=worker)


def phase_async_atlas(dev, scen_default, scen_atlas):
    """22d: phase 13's scenario with the mapping worker on, in a session of
    its own: the default path's 40 frames, the noise (a second map
    spawns), the replay; the worker's loop callback verifies the merge and
    posts a "merge" event, which the tracker applies."""
    import threading
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    n_first = len(scen_default["frames"])
    frames = scen_default["frames"] + scen_atlas["frames"]
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   async_mapping=True, device=str(dev)))
    applied_on, posted = [], []
    apply, post = slam._apply_merge, slam.async_map.post_event
    slam._apply_merge = lambda *a: (
        applied_on.append(threading.current_thread().name), apply(*a))[1]
    slam.async_map.post_event = lambda kind, payload=None: (
        posted.append(kind), post(kind, payload))[1]
    n_maps_max, merged_at = 1, None
    with _Launches() as counter:
        t0 = time.perf_counter()
        for i, img in enumerate(frames):
            slam.track_monocular(img, i * 0.1)
            n_maps_max = max(n_maps_max, len(slam.atlas.maps))
            if (merged_at is None and n_maps_max > 1
                    and len(slam.atlas.maps) == 1):
                merged_at = i
        slam.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    worker, merger = dict(slam.async_map.stats), dict(slam.merger.stats)
    n_maps = len(slam.atlas.maps)
    rows = slam.trajectory()
    slam.shutdown()
    if n_maps_max < 2 or n_maps != 1:
        raise AssertionError(f"async Atlas: {n_maps_max} maps at most, "
                             f"{n_maps} at the end; merger {merger}")
    if "merge" not in posted or not applied_on or set(applied_on) != {
            threading.main_thread().name}:
        raise AssertionError(f"async Atlas: events {posted}, merges applied "
                             f"on {applied_on}")
    if worker["n_errors"] != 0:
        raise AssertionError(f"async Atlas: worker {worker}")
    k1, k3 = counter.counts["fast_nms_blur"], counter.counts["hamming_nn"]
    if k1 != len(frames) or k3 < max(1, merger["n_attempts"]):
        raise AssertionError(f"async Atlas: launches {counter.counts} over "
                             f"{len(frames)} frames, merger {merger}")
    centers = _centers(scen_default["R_gt"], scen_default["t_gt"])
    ts0 = (n_first + N_BLACK) * 0.1
    gt_ts = np.concatenate([np.arange(n_first) * 0.1,
                            ts0 + np.arange(N_REPLAY) * 0.1])
    gt_xyz = np.concatenate([centers[:n_first], centers[:N_REPLAY]])
    ate, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], gt_ts, gt_xyz, True)
    if not (nm > n_first and ate < 0.25):
        raise AssertionError(f"async Atlas: post-merge scaled ATE {ate} over "
                             f"{nm}")
    print(f"phase 22d async Atlas path: {n_first} frames, {N_BLACK} "
          f"noise frames (maps at most {n_maps_max}), replay of {N_REPLAY}: "
          f"one map again (first seen at frame {merged_at}); events "
          f"{posted}; merges applied on {applied_on}; merger "
          f"{json.dumps(merger)}; worker {worker}; post-merge scaled ATE "
          f"{ate:.5f} over {nm} frames; wall {wall:.2f} s; launches "
          f"{counter.counts}")
    return dict(n_maps_max=n_maps_max, merged_at=merged_at, events=posted,
                applied_on=applied_on, merger=merger, worker=worker,
                ate_scaled=ate, nm=nm, wall_s=wall, launches=counter.counts)


def phase_fisheye_mono(dev, scen):
    """test_mono_fisheye_slam's session, then a fresh view relocalized
    against its map (BoW candidates, K3 descriptor match, PnP on the KB8
    bearings)."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import max_bound_theta_deg
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
    R_gt, t_gt, frames = scen["R_gt"], scen["t_gt"], scen["frames"]
    n = len(frames)
    slam, r = _sensor_session(dev, "mono", frames, R_gt, t_gt, 0.1,
                              tracker=_kb8_tracker(dev))
    k1 = r["launches"]["fast_nms_blur"]
    if k1 != n:
        raise AssertionError(f"fisheye mono: K1 launched {k1} times, expected "
                             f"one per frame ({n})")
    theta = max_bound_theta_deg(slam)
    if not (r["nm"] > 20 and r["ate_scaled"] < 0.2 and theta > 75.0):
        raise AssertionError(f"fisheye mono: nm {r['nm']} scaled ATE "
                             f"{r['ate_scaled']} max bound theta {theta}")
    fid, seed = FE_RELOC
    img = synthetic.render_textured(scen["world"], R_gt[fid], t_gt[fid],
                                    rng=np.random.default_rng(seed))
    slam.sys_stats.clear()
    with _Launches() as counter:
        frame = slam.tracker._extract_frame(img, 99.0)
        t0 = time.perf_counter()
        ok = slam._relocalize(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    stats = dict(slam.sys_stats)
    rows = slam.trajectory()
    row = rows[np.argmin(np.abs(rows[:, 0] - fid * 0.1))]
    c_fr = -(frame.R_cw.T @ frame.t_cw)
    reloc = dict(ms=ms, n_good=int((frame.kp_lm != NO_LM).sum()), stats=stats,
                 centre_to_tracked=float(np.linalg.norm(c_fr - row[1:4])),
                 launches=counter.counts)
    # The relocalized centre lands on the session's own estimate of that
    # frame (map units: the median scene depth is 1; 5e-4 on the CPU).
    if (not ok or stats.get("n_reloc", 0) < 1 or counter.counts["hamming_nn"] < 1
            or reloc["centre_to_tracked"] >= 0.05):
        raise AssertionError(f"fisheye relocalization: ok {ok}, {reloc}")
    print(f"phase fisheye mono path: {n} frames 512x512 KB8, loop closing on, "
          f"state OK, n_kf {r['n_kf']}, n_lm {r['n_lm']}, scaled ATE "
          f"{r['ate_scaled']:.5f} over {r['nm']} frames, max bound theta "
          f"{theta:.2f} deg; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms, wall {r['wall_s']:.2f} s; "
          f"stage medians (ms) {json.dumps(r['stage_medians'])}; launches "
          f"{r['launches']} over {r['fused_frames']} fused frames; "
          f"relocalization of a fresh view of frame {fid}: {json.dumps(reloc)}")
    launches = {k: r["launches"][k] + counter.counts[k] for k in counter.counts}
    return dict(r, max_theta_deg=theta, reloc=reloc, launches=launches,
                session_launches=r["launches"])


def _fisheye_match_check(dev, imgL, imgR):
    """match_stereo_fisheye on the card against the same call on the CPU,
    on the card's features of one pair (the left validity ANDed with the
    KB8 round trip, as the tracker does)."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.ops import orb
    from orb_slam3_study_kr_tpu_torch.ops.fisheye_stereo import (
        match_stereo_fisheye)
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import _ray_roundtrip_ok
    cfg = _kb8_tracker(dev)
    fL = orb.extract_orb(torch.as_tensor(imgL, device=dev), cfg.orb_config)
    fR = orb.extract_orb(torch.as_tensor(imgR, device=dev), cfg.orb_config)
    valid_l = fL.valid & _ray_roundtrip_ok(cfg.cam_params, fL.uv)
    out = []
    for d in (dev, torch.device("cpu")):
        c = _kb8_tracker(d)

        def on(x, d=d):
            return x.to(d)

        out.append({k: v.cpu().numpy() for k, v in match_stereo_fisheye(
            c.project_fn, c.project_fn, c.focal, torch.eye(3, device=d),
            torch.tensor(T_RL, device=d), on(fL.uv), c.unproject_fn(on(fL.uv)),
            on(fL.level), on(fL.desc), on(valid_l), on(fL.angle), on(fR.uv),
            c.unproject_fn(on(fR.uv)), on(fR.level), on(fR.desc),
            on(fR.valid), on(fR.angle)).items()})
    g, c = out
    both = g["ok"] & c["ok"]
    agree = float((g["ok"] == c["ok"]).mean())
    idx_same = bool((g["idx_r"][both] == c["idx_r"][both]).all())
    x_err = float((np.linalg.norm(g["X"][both] - c["X"][both], axis=1)
                   / np.linalg.norm(c["X"][both], axis=1)).max())
    if c["ok"].sum() < 200 or agree < FE_OK_AGREE or not idx_same \
            or x_err >= FE_X_RTOL:
        raise AssertionError(f"match_stereo_fisheye card vs CPU: "
                             f"{int(c['ok'].sum())} accepted, ok agreement "
                             f"{agree}, idx_r equal {idx_same}, X rel err "
                             f"{x_err}")
    return dict(n_ok=int(g["ok"].sum()), n_ok_cpu=int(c["ok"].sum()),
                ok_agree=agree, X_max_rel_err=x_err)


def phase_fisheye_stereo(dev, scen):
    R_gt, t_gt, pairs = scen["R_gt"], scen["t_gt"], scen["frames"]
    n = len(pairs)
    check = _fisheye_match_check(dev, *pairs[0])
    _, r = _sensor_session(dev, "stereo", pairs, R_gt, t_gt, 0.1,
                           tracker=_kb8_tracker(dev), stereo_t_rl=T_RL)
    k1 = r["launches"]["fast_nms_blur"]
    if k1 != 2 * n:
        raise AssertionError(f"fisheye stereo: K1 launched {k1} times, "
                             f"expected two per frame ({2 * n})")
    if not (r["nm"] > 15 and r["ate_metric"] < 0.25):
        raise AssertionError(f"fisheye stereo: nm {r['nm']} metric ATE "
                             f"{r['ate_metric']}")
    if "track/stereo_match" not in r["stage_medians"]:
        raise AssertionError("fisheye stereo: no track/stereo_match stage")
    print(f"phase fisheye stereo path: match_stereo_fisheye card vs CPU on "
          f"the first pair {json.dumps(check)}; {n} pairs 512x512 KB8, t_rl "
          f"{T_RL}, loop closing on, state OK, n_kf {r['n_kf']}, n_lm "
          f"{r['n_lm']}, metric ATE {r['ate_metric']:.5f} over {r['nm']} "
          f"frames, scale {r['scale']:.5f}; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms, wall {r['wall_s']:.2f} s; "
          f"stage medians (ms) {json.dumps(r['stage_medians'])}; launches "
          f"{r['launches']} over {r['fused_frames']} fused frames")
    return dict(r, match_check=check)


def phase_fisheye_inertial(dev, scen):
    _, r = _inertial_session(dev, scen, "stereo-inertial",
                             tracker=_kb8_tracker(dev), stereo_t_rl=T_RL)
    s = r["imu_init_scale"]
    # The reference estimates this init's scale instead of fixing it to 1
    # (its fix_scale is bf > 0, and a fisheye rig keeps bf = 0): the port
    # is held to the reference's CPU record of this session.
    if not (s is not None and abs(s / FE_REF_SCALE - 1.0) < FE_SCALE_RTOL):
        raise AssertionError(f"fisheye stereo-inertial: init scale {s}, the "
                             f"reference's {FE_REF_SCALE}")
    if not (r["nm"] > 35 and r["ate_metric"] < 0.25):
        raise AssertionError(f"fisheye stereo-inertial: nm {r['nm']} metric "
                             f"ATE {r['ate_metric']}")
    print(_inertial_line("fisheye stereo-inertial", r))
    return r


def _u8(img):
    import numpy as np
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode_png_adaptive(img):
    """uint8 (H, W) -> PNG bytes with the filter choice libpng makes by
    default (the writer behind the datasets' files): each row takes the
    filter whose residuals, read as signed bytes, have the least absolute
    sum.  On rendered frames that is mostly Average and Paeth, the filters
    whose bytes depend on the reconstructed byte to their left.  Returns
    (bytes, rows per filter)."""
    import struct
    import zlib
    import numpy as np
    x = img.astype(np.int32)
    h = x.shape[0]
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    res = (x[None] - np.stack([0 * x, a, b, (a + b) >> 1, paeth])) % 256
    f = np.minimum(res, 256 - res).sum(-1).argmin(0)
    raw = np.concatenate([f[:, None], res[f, np.arange(h)]],
                         1).astype(np.uint8)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", x.shape[1], h, 8, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
    return data, np.bincount(f, minlength=5)


def _write_mav0(root, t_ns, frames, imu=None, centres=None,
                libpng_rows=True):
    """A EuRoC ``mav0`` folder: cam0 (and cam1 for pairs) PNGs and their
    data.csv, imu0/data.csv from the per-frame rows [dt, acc, gyro]
    covering (t_{i-1}, t_i], and the ground truth's positions at the frame
    stamps.  The PNGs carry libpng's filter choice
    (``_encode_png_adaptive``), or with ``libpng_rows=False`` the port's
    own filter-0 encoder's rows.  Returns the seconds spent encoding and
    the PNG rows per filter."""
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.io import png
    t0 = time.perf_counter()
    filters = np.zeros(5, np.int64)
    cams = ("cam0", "cam1")[:len(frames[0])]
    for c, cam in enumerate(cams):
        os.makedirs(os.path.join(root, cam, "data"))
        with open(os.path.join(root, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, fr in zip(t_ns, frames):
                img = _u8(fr[c])
                if libpng_rows:
                    data, rows = _encode_png_adaptive(img)
                else:
                    data, rows = png.encode_png(img), [len(img), 0, 0, 0, 0]
                path = os.path.join(root, cam, "data", f"{ns}.png")
                with open(path, "wb") as g:
                    g.write(data)
                filters += rows
                f.write(f"{ns},{ns}.png\n")
    secs = time.perf_counter() - t0
    if imu is not None:
        os.makedirs(os.path.join(root, "imu0"))
        with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                    "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                    "a_RS_S_z [m s^-2]\n")
            for i in range(1, len(t_ns)):
                stamps = t_ns[i - 1] + np.rint(
                    np.cumsum(imu[i][:, 0]) * 1e9).astype(np.int64)
                for ns, row in zip(stamps, imu[i]):
                    f.write(f"{ns}," + ",".join(
                        repr(float(x)) for x in (*row[4:7], *row[1:4])) + "\n")
    if centres is not None:
        os.makedirs(os.path.join(root, "state_groundtruth_estimate0"))
        with open(os.path.join(root, "state_groundtruth_estimate0",
                               "data.csv"), "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                    "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
            for ns, p in zip(t_ns, centres):
                f.write(f"{ns}," + ",".join(repr(float(x)) for x in p)
                        + ",1.0,0.0,0.0,0.0\n")
    return secs, filters.tolist()


# Phase 19a's calibration: the synthetic camera (TrackerConfig's defaults),
# a rectified rig of baseline 0.11 (Camera.bf = fx x 0.11: with bf > 0 the
# IMU init fixes the scale), the synthetic IMU's noise densities and an
# identity body <- camera extrinsic (the synthetic body is the camera).
DRIVER_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.0
Camera1.fy: 457.0
Camera1.cx: 376.0
Camera1.cy: 240.0
Camera1.k1: 0.0
Camera1.k2: 0.0
Camera1.p1: 0.0
Camera1.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 10
Camera.bf: {bf!r}
Stereo.ThDepth: 40.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
"""


def phase_driver_stereo_inertial(dev, scen, tmp):
    """19a: the rectified stereo-inertial rig through run_euroc's command
    line (parse_args, build_system from the YAML, run: the IMU windows from
    imu0/data.csv, the TUM file), then the TUM file read back against the
    ground truth CSV."""
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.examples import run_euroc
    from orb_slam3_study_kr_tpu_torch.io.datasets import load_euroc
    frames, n = scen["frames"], len(scen["frames"])
    root = os.path.join(tmp, "si", "mav0")
    t_ns = [EUROC_T0_NS + i * 100_000_000 for i in range(n)]
    write_s, filters = _write_mav0(root, t_ns, frames, imu=scen["imu"],
                                   centres=_centers(scen["R_gt"], scen["t_gt"]))
    yaml = os.path.join(tmp, "euroc_stereo_inertial.yaml")
    with open(yaml, "w") as f:
        f.write(DRIVER_YAML.format(bf=458.0 * BASELINE))
    traj = os.path.join(tmp, "si_tum.txt")
    args = run_euroc.parse_args([root, "--sensor", "stereo-inertial",
                                 "--settings", yaml, "--out", traj,
                                 "--device", str(dev)])
    slam = run_euroc.build_system(args)
    tr = slam.tracker
    if not (slam.cfg.tracker.bf > 0 and slam.cfg.tracker.n_features == 1000
            and slam.cfg.tracker.orb_n_levels == 8):
        raise AssertionError(f"driver config {slam.cfg.tracker}")
    stages, rounds, track = [], [], slam.track_stereo

    def recorded(*a, **kw):
        """track_stereo, noting the IMU stage and the rounds each frame took."""
        keys = ("fused_frames", "split_frames")
        before = [slam.tracker.stats.get(k, 0) for k in keys]
        frame = track(*a, **kw)
        stages.append(slam.tracker.imu_stage)
        rounds.append([slam.tracker.stats.get(k, 0) - b
                       for k, b in zip(keys, before)])
        return frame

    slam.track_stereo = recorded
    with _Launches() as counter:
        t0 = time.perf_counter()
        run_euroc.run(args, slam)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if slam.tracker is not tr:
        raise AssertionError("the session spawned a map")
    rows = np.loadtxt(traj, ndmin=2)
    seq = load_euroc(root)
    # The driver decodes a pair per frame before tracking it: time
    # seq.image (file read, inflate, the filters' reversal) apart.
    decode_ms = []
    for i in range(n):
        t0 = time.perf_counter()
        seq.image(i, 0), seq.image(i, 1)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    metric, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], seq.gt_ts, seq.gt_pos,
                             with_scale=False)
    scale = tr.stats.get("imu_init_scale")
    fused, split = tr.stats.get("fused_frames", 0), tr.stats.get("split_frames", 0)
    k1, k2 = counter.counts["fast_nms_blur"], counter.counts["gated_nn"]
    if tr.imu_stage < 1 or scale != 1.0:
        raise AssertionError(f"driver stereo-inertial: IMU stage {tr.imu_stage},"
                             f" init scale {scale} (bf > 0 fixes it to 1)")
    if not (nm > 35 and metric < 0.25):
        raise AssertionError(f"driver stereo-inertial: nm {nm} metric ATE "
                             f"{metric}")
    if k1 != 2 * n:
        raise AssertionError(f"driver stereo-inertial: K1 launched {k1} times,"
                             f" expected two per frame ({2 * n})")
    if split < 1 or k2 < 4 * fused + 2 * split:
        raise AssertionError(f"driver stereo-inertial: K2 launched {k2} times "
                             f"over {fused} fused and {split} split frames")
    t_ms = np.asarray(slam.timings) * 1e3
    before, after = _round_medians(t_ms, stages, rounds)
    r = dict(
        state=slam.state.name, imu_stage=tr.imu_stage,
        stage_at=int(np.argmax(np.asarray(stages) >= 1)), imu_init_scale=scale,
        ate_metric=metric, nm=nm, n_rows=int(rows.shape[0]),
        frame_ms_median_fused=float(np.median(before)) if before.size else None,
        frame_ms_median_split=float(np.median(after)) if after.size else None,
        n_fused_timed=int(before.size), n_split_timed=int(after.size),
        fused_frames=fused, split_frames=split, launches=counter.counts,
        wall_s=wall, png_write_s=write_s, png_filter_rows=filters,
        png_decode_ms_median_pair=float(np.median(decode_ms)),
        frame_ms=[float(x) for x in t_ms])
    print(f"phase driver stereo-inertial (19a): run_euroc on {n} PNG pairs + "
          f"imu0 + YAML, state {r['state']}, IMU stage {r['imu_stage']} "
          f"(stage 1 at frame {r['stage_at']}), init scale {scale}; metric "
          f"ATE {metric:.5f} over {nm} frames from the TUM file against the "
          f"ground truth CSV; frame medians: fused "
          f"{r['frame_ms_median_fused']} ms ({r['n_fused_timed']} frames), "
          f"split {r['frame_ms_median_split']} ms ({r['n_split_timed']} "
          f"frames); wall {wall:.2f} s (PNG writes {write_s:.2f} s, rows per "
          f"filter None/Sub/Up/Average/Paeth {filters}; seq.image of a pair "
          f"median {r['png_decode_ms_median_pair']:.2f} ms); launches "
          f"{counter.counts} over {fused} fused and {split} split frames")
    return r


def phase_driver_mono(dev, scen, tmp):
    """19b: two EuRoC mono sequences 100 s apart through one session by
    run_euroc.run_sequence (the upload_image lookahead); the timestamp jump
    stores the first map and spawns a second."""
    import argparse
    import contextlib
    import io
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.examples import run_euroc
    from orb_slam3_study_kr_tpu_torch.io.datasets import load_euroc
    from orb_slam3_study_kr_tpu_torch.ops import orb
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    from orb_slam3_study_kr_tpu_torch.viz import FrameDrawer
    _, n, ts0 = DRIVER_MONO
    frames = [(f,) for f in scen["frames"]]
    roots = [os.path.join(tmp, f"seq{k + 1}", "mav0") for k in range(2)]
    write_s = sum(_write_mav0(root, [int((t0 + i * 0.1) * 1e9) for i in range(n)],
                              frames[k * n:(k + 1) * n], libpng_rows=False)[0]
                  for k, (root, t0) in enumerate(zip(roots, ts0)))
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10), min_kf_spawn=3,
                                   device=str(dev)))
    seqs = [load_euroc(root) for root in roots]
    # upload_image: a tensor on the card whose extraction equals the host
    # array's, key for key (outside the counted run).
    img0 = seqs[0].image(0)
    up = slam.upload_image(img0)
    if not (up.device.type == dev.type and up.dtype == torch.float32):
        raise AssertionError(f"upload_image gave {up.device} {up.dtype}")
    ocfg = slam.cfg.tracker.orb_config
    fa, fb = orb.extract_orb(up, ocfg), orb.extract_orb(
        torch.as_tensor(img0, device=dev), ocfg)
    same = {k: bool(torch.equal(getattr(fa, k), getattr(fb, k)))
            for k in ("uv", "level", "angle", "desc", "valid")}
    if not all(same.values()):
        raise AssertionError(f"uploaded image's keypoints differ: {same}")
    args = argparse.Namespace(sensor="mono", pace=False, max_frames=-1)
    fused_per_frame, track = [], slam.track_monocular

    def recorded(*a, **kw):
        """track_monocular, noting whether the frame took the fused rounds
        (the timestamp jump replaces the tracker and its counters)."""
        tr = slam.tracker
        before = tr.stats.get("fused_frames", 0)
        frame = track(*a, **kw)
        after = slam.tracker.stats.get("fused_frames", 0)
        fused_per_frame.append(after - before if slam.tracker is tr else after)
        return frame

    slam.track_monocular = recorded
    with _Launches() as counter:
        t0 = time.perf_counter()
        for seq in seqs:
            run_euroc.run_sequence(slam, seq, args, inertial=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resets = slam.sys_stats.get("n_ts_resets", 0)
    if resets != 1 or slam.state != TrackState.OK:
        raise AssertionError(f"driver mono: {resets} timestamp resets, state "
                             f"{slam.state}")
    rows, ids = slam.trajectory(with_map_ids=True)
    if not (len(rows) > n and len(ids) == len(rows)
            and np.isfinite(rows[:, 1:]).all()):
        raise AssertionError(f"driver mono: {len(rows)} trajectory rows")
    k1, k2 = counter.counts["fast_nms_blur"], counter.counts["gated_nn"]
    fused = int(sum(fused_per_frame))
    if k1 != 2 * n:
        raise AssertionError(f"driver mono: K1 launched {k1} times, expected "
                             f"one per frame ({2 * n})")
    if fused < 1 or k2 < 4 * fused:
        raise AssertionError(f"driver mono: K2 launched {k2} times over "
                             f"{fused} fused frames")
    lines = {}
    for name in ("save_trajectory_tum", "save_trajectory_euroc",
                 "save_trajectory_kitti", "save_keyframe_trajectory_tum"):
        path = os.path.join(tmp, f"{name}.txt")
        getattr(slam, name)(path)
        with open(path) as f:
            lines[name] = len(f.read().splitlines())
    n_kf = int(slam.atlas.active_map.kf_valid.sum())
    want = dict.fromkeys(lines, len(rows))
    want["save_keyframe_trajectory_tum"] = n_kf
    if lines != want:
        raise AssertionError(f"driver mono: writer rows {lines}, expected {want}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        slam.print_time_stats()
    if "track/extract" not in buf.getvalue():
        raise AssertionError("print_time_stats printed no stage table")
    last = seqs[1].image(n - 1)
    overlay = FrameDrawer(slam).draw(last, slam.tracker.last_frame,
                                     stats=slam.stats())
    if not (overlay.dtype == np.uint8 and overlay.shape[1:] == (last.shape[1], 3)
            and overlay.shape[0] > last.shape[0]):
        raise AssertionError(f"FrameDrawer overlay {overlay.dtype} "
                             f"{overlay.shape}")
    warm = np.asarray(slam.timings[5:]) * 1e3
    r = dict(state=slam.state.name, n_ts_resets=resets,
             n_maps=len(slam.atlas.maps), map_ids=sorted(set(ids.tolist())),
             n_rows=int(len(rows)), writer_rows=lines,
             upload_equal=same, frame_ms_median_warm=float(np.median(warm)),
             launches=counter.counts, fused_frames=fused, wall_s=wall,
             png_write_s=write_s, overlay_shape=list(overlay.shape),
             frame_ms=[float(x) for x in np.asarray(slam.timings) * 1e3])
    print(f"phase driver mono (19b): two {n}-frame EuRoC sequences 100 s "
          f"apart through run_sequence (upload_image lookahead), "
          f"{resets} timestamp reset, {r['n_maps']} maps, state OK, "
          f"{len(rows)} trajectory rows (map ids {r['map_ids']}); uploaded "
          f"image's keypoints equal the host array's; writer rows {lines}; "
          f"overlay {overlay.shape}; warm per-frame median "
          f"{r['frame_ms_median_warm']:.2f} ms, wall {wall:.2f} s (PNG writes "
          f"{write_s:.2f} s, the port's filter-0 encoder); launches "
          f"{counter.counts} over {fused} fused frames")
    return r



# Phase 20: the landmark-sharded global BA.  The ring world's keyframe
# centres through two shards of one card against phase 9's one-device
# solve: 1e-3 (map units), the bar ROADMAP holds BA poses to, since the
# shards add their partial systems in another order.  bench_scaling's
# problem and the worker's at 1 and 2 shards: poses within 1e-4 (float32
# sums of the same terms in another order, over 10 LM iterations).
MESH_TOL, SHARD_TOL = 1e-3, 1e-4
# tests/test_multihost.py's convergence walls.
WORKER_POSE_ERR, WORKER_ROT_ERR = 0.05, 0.01


def phase_mesh_loop(dev, single):
    """20a: phase 9 again with the GBA over make_ba_mesh([dev, dev])."""
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.parallel import make_ba_mesh
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import collectives_per_iter
    mesh = make_ba_mesh([dev, dev])
    r = phase_loop_correction(dev, ba_mesh=mesh)
    diff = float(np.abs(np.asarray(r["centres"])
                        - np.asarray(single["centres"])).max())
    if diff >= MESH_TOL:
        raise AssertionError(f"2-shard centres {diff} from the 1-shard solve")
    want = 1 + 10 * collectives_per_iter("dense_chunked")
    if mesh.n_psum != want:
        raise AssertionError(f"{mesh.n_psum} reductions, expected {want}")
    r.update(centre_diff=diff, n_psum=mesh.n_psum)
    print(f"phase 20a mesh GBA: ring world over 2 shards of {dev}: corrected "
          f"once at {r['corrected_at'][0]}; revisit centre errors "
          f"{[round(e, 5) for e in r['centre_err']]}; duplicates alive "
          f"{r['dup_alive']:.4f}; max keyframe-centre difference from phase 9 "
          f"{diff!r}; {mesh.n_psum} reductions; {r['wall_s']:.2f} s; "
          f"launches {r['launches']}")
    return r


def phase_ba_scaling(dev, size=(64, 32768, 131072), n_iters=10):
    """20b: bench_scaling's problem at 1 and 2 in-process shards of dev,
    dense_chunked and pcg: warm ms per LM iteration, peak memory and the
    reductions counted per iteration beside collectives_per_iter."""
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.parallel import bench_scaling
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import collectives_per_iter
    problem = bench_scaling.build_problem(*size)
    out = {}
    for assembly in ("dense_chunked", "pcg"):
        runs = {n: bench_scaling.run(n, n_iters=n_iters, assembly=assembly,
                                     device=str(dev), problem=problem)
                for n in (1, 2)}
        want = collectives_per_iter(assembly)
        for n, r in runs.items():
            if r["psum_per_iter"] != want:
                raise AssertionError(f"{assembly} x{n}: {r['psum_per_iter']} "
                                     f"reductions per iteration, expected {want}")
            if not np.isfinite(r["R"]).all() or not np.isfinite(r["X"]).all():
                raise AssertionError(f"{assembly} x{n}: non-finite solve")
        diff = max(float(np.abs(runs[2][k] - runs[1][k]).max())
                   for k in ("R", "t"))
        if diff >= SHARD_TOL:
            raise AssertionError(f"{assembly}: 2-shard poses {diff} from 1-shard")
        out[assembly] = {n: dict(ms_per_iter=r["ms_per_iter"],
                                 peak_bytes=r["peak_bytes"],
                                 psum_per_iter=r["psum_per_iter"])
                         for n, r in runs.items()}
        out[assembly]["pose_diff"] = diff
        print(f"phase 20b BA scaling ({assembly}, K, M, O = {size}, {n_iters} "
              f"LM iterations): ms per iteration 1 shard "
              f"{runs[1]['ms_per_iter']:.3f}, 2 shards {runs[2]['ms_per_iter']:.3f};"
              f" peak memory above the inputs {runs[1]['peak_bytes']} / "
              f"{runs[2]['peak_bytes']} bytes; reductions per iteration "
              f"{runs[2]['psum_per_iter']} "
              f"(collectives_per_iter {want}); 2-shard poses within {diff:.3e}")
    return out


def _run_workers(dev, tmp, backend, n_procs, shards, size=None, n_iters=10):
    """The multi-process worker as n_procs processes; returns (rank 0's JSON
    line, rank 0's poses)."""
    import numpy as np
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=HERE)
    extra = [] if size is None else ["--size", *map(str, size)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.parallel.multihost_worker", str(r),
         str(n_procs), str(port), str(n_iters), "pcg", "--backend", backend,
         "--device", str(dev), "--shards-per-process", str(shards),
         "--out-dir", tmp, *extra], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n_procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (so, se, rc) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"{backend} worker rank {r} exited {rc}: "
                                 f"{se[-2000:]}")
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    return res, dict(np.load(os.path.join(tmp, "rank0.npz")))


def phase_workers(dev, backends=("gloo", "nccl"), size=None, n_iters=10):
    """20c: the worker as 2 ranks of one card over gloo (one shard each) and
    as 1 rank over nccl with 2 local shards, both at once, each against an
    in-process 2-shard solve of the same problem."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.parallel import (distributed_bundle_adjust,
                                                       make_ba_mesh)
    from orb_slam3_study_kr_tpu_torch.parallel import multihost_worker as mw
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import shard_ba_problem
    pr = mw.build_problem(*(size or (12, 4096, 16384)))
    M = pr["X0"].shape[0]
    parts = shard_ba_problem(2, pr["X0"], np.ones(M, np.float32), pr["op"],
                             pr["ol"], pr["ouv"], pr["olev"], pr["omask"])
    put = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    R, t, _, _ = distributed_bundle_adjust(
        make_ba_mesh([dev, dev]), *mw.camera_fns(dev), put(pr["R0"]),
        put(pr["t0"]), put(pr["fixed"]), *map(put, parts[:7]),
        n_iters=n_iters, assembly="pcg")
    ref = dict(R=R.cpu().numpy(), t=t.cpu().numpy())
    out = {}
    layouts = dict(gloo=(2, 1), nccl=(1, 2))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as tmp, \
            ThreadPoolExecutor(len(backends)) as pool:
        futures = {b: pool.submit(_run_workers, dev, os.path.join(tmp, b), b,
                                  *layouts[b], size, n_iters)
                   for b in backends}
        runs = {b: f.result() for b, f in futures.items()}
    for backend, (res, poses) in runs.items():
        n_procs, shards = layouts[backend]
        diff = max(float(np.abs(poses[k] - ref[k]).max()) for k in ("R", "t"))
        if not (res["pose_err"] < WORKER_POSE_ERR
                and res["rot_err"] < WORKER_ROT_ERR):
            raise AssertionError(f"{backend} worker did not converge: {res}")
        if diff >= SHARD_TOL:
            raise AssertionError(f"{backend} worker poses {diff} from the "
                                 "in-process 2-shard solve")
        res["pose_diff"] = diff
        out[backend] = res
        print(f"phase 20c worker ({backend}, {n_procs} process(es) x {shards} "
              f"shard(s) of {dev}): {json.dumps(res)}")
    return out


# Phase 21: the first KNOB_FRAMES frames of the loop-off session with each
# tracker knob of ROADMAP item 12a (cut from 18 to hold the script's time).
# The reference's own runs of these frames on the CPU
# (tests/test_torch_session_records.py::test_tracker_knob_session_record,
# jax 0.9.0): its final state and scaled ATE; the card is held to the same
# final state and a scaled ATE under KNOB_ATE_MARGIN times the reference's,
# the margin the repo's ATE walls keep over the reference's worst seed.
KNOB_SESSIONS = {"klt_off": dict(klt_refine=False),
                 "anchor_ambig": dict(refkf_anchor=True, ambig_obs_weight=0.5),
                 "patch_zncc": dict(patch_zncc_min=0.3)}
KNOB_REFERENCE = {"klt_off": ("OK", 0.0029646782),
                  "anchor_ambig": ("OK", 0.0032941059),
                  "patch_zncc": ("OK", 0.0034956729)}
KNOB_ATE_MARGIN = 1.6
KNOB_FRAMES = 12


def phase_knobs(dev, scen):
    """21: the loop-off scenario's frames with each knob; each session
    launches K1 and K2 at least once."""
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    n = KNOB_FRAMES
    frames = [(f,) for f in scen["frames"][:n]]
    out = {}
    for name, kw in KNOB_SESSIONS.items():
        ref_state, ref_ate = KNOB_REFERENCE[name]
        slam, r = _sensor_session(
            dev, "mono", frames, scen["R_gt"][:n], scen["t_gt"][:n], 0.1,
            final_ok=False, enable_loop_closing=False,
            tracker=TrackerConfig(fps=10, device=str(dev), **kw),
            need_fused=False)
        if r["state"] != ref_state:
            raise AssertionError(f"{name}: final state {r['state']}, the "
                                 f"reference's {ref_state}")
        if not r["ate_scaled"] < KNOB_ATE_MARGIN * ref_ate:
            raise AssertionError(f"{name}: scaled ATE {r['ate_scaled']} over "
                                 f"{KNOB_ATE_MARGIN} x {ref_ate}")
        c = r["launches"]
        if c["fast_nms_blur"] < 1 or c["gated_nn"] < 1:
            raise AssertionError(f"{name}: launches {c}")
        st = slam.tracker.stats
        r["split_frames"] = st.get("split_frames", 0)
        out[name] = r
        print(f"phase 21 tracker knobs ({name}: {kw}): state {r['state']}, "
              f"scaled ATE {r['ate_scaled']:.5f} over {r['nm']} frames (the "
              f"reference's {ref_ate:.5f}), n_kf {r['n_kf']}, "
              f"{r['fused_frames']} fused / {r['split_frames']} split frames; "
              f"warm per-frame median {r['frame_ms_median_warm']:.2f} ms; "
              f"launches {c}")
    out["launches"] = {k: sum(out[n]["launches"][k] for n in KNOB_SESSIONS)
                       for k in ("fast_nms_blur", "gated_nn", "hamming_nn")}
    return out


# Phase 23: the scatter-adds of these solvers go through ops/segment.py.
# Each site's solver records its last call on the main path named here
# (the arguments cloned before the call, the output after), and phase 23
# replays it on the same card.  The pose graph's solve takes seconds (the
# forward-mode Jacobians), so its site is the normal equations of its
# last iteration.  The keyframe database sums its sparse BoW vectors on
# the host, so the dense vector (bow_vector_any, which sums on the card)
# is replayed on the arguments of the database's last words_and_weights
# call.
FIXED_SITES = {
    "local_ba": (f"{PKG}.pipeline.local_mapping", "bundle_adjust", "loop_off"),
    "bow": (f"{PKG}.bow.database", "words_and_weights", "default",
            (f"{PKG}.bow.vocabulary", "bow_vector_any")),
    "pose_graph": (f"{PKG}.solvers.pose_graph", "_normal_equations", "loop"),
    "gba": (f"{PKG}.pipeline.global_ba", "bundle_adjust", "loop"),
    "inertial_ba": (f"{PKG}.pipeline.inertial_tracking",
                    "inertial_bundle_adjust", "mono_inertial"),
    "sharded_ba": (f"{PKG}.parallel.dist_ba", "distributed_bundle_adjust",
                   "mesh_loop"),
}
# Replays in the fixed order, and with index_add_ before and after them.
N_FIXED, N_UNORDERED = 20, 2


def _each_tensor(x, fn):
    """x with fn applied to every tensor in it (through tuples, lists,
    dicts and the port's Preintegrated)."""
    import torch
    from orb_slam3_study_kr_tpu_torch.imu.preintegration import Preintegrated
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Preintegrated):
        return x.map(fn)
    if isinstance(x, (tuple, list)):
        return type(x)(_each_tensor(a, fn) for a in x)
    if isinstance(x, dict):
        return {k: _each_tensor(v, fn) for k, v in x.items()}
    return x


def _tensors(x):
    out = []
    _each_tensor(x, out.append)
    return out


def _same_bits(a, b):
    """Every tensor of a has the bytes of b's (NaN payloads included)."""
    import torch
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.detach().reshape(-1).contiguous().view(torch.uint8),
            y.detach().reshape(-1).contiguous().view(torch.uint8))
        for x, y in zip(ta, tb))


def _max_diff(a, b):
    """Largest |a - b| / (1 + |b|) over the floating tensors (absolute for
    poses and unit vectors, relative for costs and chi2; NaN at the same
    place in both counts as equal, elsewhere as inf)."""
    import torch
    d = 0.0
    for x, y in zip(_tensors(a), _tensors(b)):
        if x.is_floating_point():
            x, y = x.double(), y.double()
            e = torch.where(torch.isnan(x) & torch.isnan(y),
                            torch.zeros_like(x), (x - y).abs() / (1 + y.abs()))
            d = max(d, float(torch.nan_to_num(e, nan=float("inf")).max())
                    if e.numel() else 0.0)
    return d


class _Recorder:
    """Records each FIXED_SITES solver's last call while ``recording``."""

    def __init__(self):
        self.calls = {}

    def recording(self, *sites):
        import contextlib
        import importlib

        @contextlib.contextmanager
        def patched():
            saved = []
            for site in sites:
                module, attr, _, *replay = FIXED_SITES[site]
                mod = importlib.import_module(module)
                orig = getattr(mod, attr)
                fn = (getattr(importlib.import_module(replay[0][0]),
                              replay[0][1]) if replay else orig)

                def rec(*a, _site=site, _orig=orig, _fn=fn, **kw):
                    args = _each_tensor((a, kw), lambda t: t.clone())
                    out = _orig(*a, **kw)
                    self.calls[_site] = dict(fn=_fn, args=args, out=(
                        _each_tensor(out, lambda t: t.clone())
                        if _fn is _orig else None))
                    return out

                setattr(mod, attr, rec)
                saved.append((mod, attr, orig))
            try:
                yield
            finally:
                for mod, attr, orig in saved:
                    setattr(mod, attr, orig)

        return patched()


def _replay(call, n):
    """n calls of a recorded site on its recorded arguments: (outputs, ms
    per call, host clock over synchronized calls)."""
    import torch
    fn, (a, kw) = call["fn"], call["args"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(*a, **kw) for _ in range(n)]
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) / n * 1e3


def phase_fixed_order(dev, recorder, loop_off, scen):
    """23: (a) each recorded site replayed N_FIXED times: the same bytes as
    its main-path call every time; N_UNORDERED replays before them and as
    many after with index_add_ / index_put_ on the card (the order before
    ops/segment.py) give that order's spread and time.  (b) the loop-off session again, under
    torch.use_deterministic_algorithms(True, warn_only=True): camera
    centres, keyframe poses and landmarks equal to phase 6's bit for bit.
    (c) the warnings of that mode over (b) and one more replay of each
    site, by call site."""
    import warnings
    from unittest import mock
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.ops import segment
    sites = {}
    for site, (_, _, phase, *_) in FIXED_SITES.items():
        call = recorder.calls.get(site)
        if call is None:
            raise AssertionError(f"23: {site} made no call in phase {phase}")
        unordered = mock.patch.object(segment, "_fixed_order", lambda t: False)
        with unordered:
            before, ms_b = _replay(call, N_UNORDERED)
        outs, ms = _replay(call, N_FIXED)
        with unordered:
            after, ms_a = _replay(call, N_UNORDERED)
        unordered, ms_u = before + after, (ms_b + ms_a) / 2
        if call["out"] is None:     # a replayed function of the recorded call
            call["out"] = outs[0]
        bad = [i for i, o in enumerate(outs) if not _same_bits(o, call["out"])]
        if bad:
            raise AssertionError(
                f"23: {site} replays {bad} differ from its {phase} call by "
                f"{max(_max_diff(outs[i], call['out']) for i in bad):.3e} "
                f"(relative)")
        sites[site] = dict(
            phase=phase, identical=N_FIXED, ms=ms, index_add_ms=ms_u,
            index_add_spread=max(_max_diff(o, unordered[0])
                                 for o in unordered),
            index_add_from_fixed=max(_max_diff(o, call["out"])
                                     for o in unordered))
        print(f"phase 23a fixed order, {site} (from {phase}): {N_FIXED} "
              f"replays identical to the main path's call (bow: to the "
              f"first replay), {ms:.3f} ms per "
              f"call; index_add_ {ms_u:.3f} ms, its {2 * N_UNORDERED} replays "
              f"spread {sites[site]['index_add_spread']:.3e}, "
              f"{sites[site]['index_add_from_fixed']:.3e} from the fixed "
              f"order (|a - b| / (1 + |b|) over the outputs)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            # The scan's control: histc has no deterministic CUDA version,
            # so the mode must warn here.
            torch.histc(torch.zeros(8, device=dev), bins=4)
            for call in recorder.calls.values():
                _replay(call, 1)
            *_, again = _lateral_session(dev, scen, loop_closing=False)
        finally:
            torch.use_deterministic_algorithms(False)
    for k, a in loop_off["state"].items():
        b = again["state"][k]
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(
                f"23b: the loop-off rerun's {k} differ from phase 6's "
                f"(shapes {a.shape} / {b.shape}, max "
                f"{np.nanmax(np.abs(a - b)) if a.shape == b.shape else None})")
    scan, control = {}, 0
    for w in caught:
        if os.path.abspath(w.filename) == os.path.abspath(__file__):
            control += "histc" in str(w.message)
            continue
        key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
        what = str(w.message).split(".")[0][:100]
        scan.setdefault(key, {}).setdefault(what, 0)
        scan[key][what] += 1
    if control < 1:
        raise AssertionError("23c: deterministic mode raised no warning at "
                             "torch.histc: the scan sees nothing")
    n_state = {k: v.shape[0] for k, v in again["state"].items()}
    print(f"phase 23b fixed order: the loop-off session rerun under "
          f"use_deterministic_algorithms(warn_only=True) equals phase 6 bit "
          f"for bit ({json.dumps(n_state)} rows); ATE {again['ate']:.5f}")
    print(f"phase 23c deterministic-mode warnings by call site: "
          f"{sum(sum(v.values()) for v in scan.values())} at {len(scan)} "
          f"sites {json.dumps(scan)} (the control, torch.histc on the "
          f"card, warned {control} time(s))")
    return dict(sites=sites, scan=scan, rerun_ate=again["ate"])


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
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    out = {"card": phase_card()}
    # The host renders a 752x480 frame in about half a second: every main
    # path's frames are rendered by worker processes, one per path, while
    # the kernels build; the pool is closed before anything is measured.
    with ProcessPoolExecutor(max_workers=len(SCENARIOS), mp_context=
                             multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(render_scenario, k) for k in SCENARIOS}
        out["build"] = phase_build()
        t0 = time.perf_counter()
        scen = {k: f.result() for k, f in futures.items()}
        out["render_wait_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(2, x_span=0.05, z_span=0.0,
                                              y_amp=0.0)
    img_a, img_b = (synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
                    for i in range(2))
    phase_s = out["phase_s"] = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 3)
        return r

    out["k1"] = run("k1", phase_k1, dev, img_a,
                    scen["fisheye_mono"]["frames"][0][0])
    out["k2"] = run("k2", phase_k2, dev, img_a, img_b)
    out["k3"] = run("k3", phase_k3, dev, img_a, img_b)
    recorder = _Recorder()
    with recorder.recording("local_ba"):
        loop_off = run("loop_off", phase_loop_off, dev, scen["loop_off"])
    with recorder.recording("bow"):
        slam, world, R_gt, t_gt, out["default"] = run(
            "default", phase_default, dev, scen["default"])
    del out["default"]["state"]
    out["reloc"] = run("reloc", phase_reloc, dev, slam, world, R_gt, t_gt)
    out["atlas"] = run("atlas", phase_atlas, dev, slam, scen["atlas"])
    del slam
    with recorder.recording("pose_graph", "gba"):
        out["loop"] = run("loop", phase_loop_correction, dev)
    out["stereo"] = run("stereo", phase_stereo, dev, scen["stereo"])
    out["rgbd"] = run("rgbd", phase_rgbd, dev, scen["rgbd"])
    out["async"] = run("async", phase_async, dev, scen["async"],
                       out["default"]["frame_ms_median_warm"])
    with recorder.recording("inertial_ba"):
        out["mono_inertial"] = run("mono_inertial", phase_mono_inertial, dev,
                                   scen["mono_inertial"])
    out["rgbd_inertial"] = run("rgbd_inertial", phase_rgbd_inertial, dev,
                               scen["rgbd_inertial"])
    out["fisheye_mono"] = run("fisheye_mono", phase_fisheye_mono, dev,
                              scen["fisheye_mono"])
    out["fisheye_stereo"] = run("fisheye_stereo", phase_fisheye_stereo, dev,
                                scen["fisheye_stereo"])
    out["fisheye_inertial"] = run("fisheye_inertial", phase_fisheye_inertial,
                                  dev, scen["fisheye_inertial"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_") as tmp:
        out["driver_si"] = run("driver_si", phase_driver_stereo_inertial, dev,
                               scen["driver_si"], tmp)
        out["driver_mono"] = run("driver_mono", phase_driver_mono, dev,
                                 scen["driver_mono"], tmp)
    with recorder.recording("sharded_ba"):
        out["mesh_loop"] = run("mesh_loop", phase_mesh_loop, dev, out["loop"])
    out["ba_scaling"] = run("ba_scaling", phase_ba_scaling, dev)
    out["workers"] = run("workers", phase_workers, dev)
    out["knobs"] = run("knobs", phase_knobs, dev, scen["loop_off"])
    out["loop_inertial"] = run("loop_inertial", phase_loop_correction, dev,
                               None, "inertial")
    out["loop_stereo"] = run("loop_stereo", phase_loop_correction, dev, None,
                             "stereo")
    out["async_inertial"] = run("async_inertial", phase_async_inertial, dev,
                                scen["async_inertial"])
    out["async_atlas"] = run("async_atlas", phase_async_atlas, dev,
                             scen["default"], scen["atlas"])
    out["fixed_order"] = run("fixed_order", phase_fixed_order, dev, recorder,
                             loop_off, scen["loop_off"])
    out["loop_off"] = {k: v for k, v in loop_off.items() if k != "state"}
    paths = ("loop_off", "default", "reloc", "atlas", "loop", "stereo", "rgbd",
             "async", "mono_inertial", "rgbd_inertial", "fisheye_mono",
             "fisheye_stereo", "fisheye_inertial", "driver_si", "driver_mono",
             "mesh_loop", "knobs", "loop_inertial", "loop_stereo",
             "async_inertial", "async_atlas")
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
    print(f"chip_smoke: {out['seconds']:.1f} s; per phase (s) {json.dumps(phase_s)}; "
          f"waited {out['render_wait_s']:.1f} s for the frames after the build")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
