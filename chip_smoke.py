#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (orb_slam3_study_kr_tpu_torch).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card and nvcc.  Phases, one printed line each:
  1. the card (nvidia-smi name and power limit);
  2. build of the hand-written kernels from csrc/ (seconds);
  3. K1 (fast_nms_blur) against its plain PyTorch version at the 8 pyramid
     level sizes of a rendered 752x480 frame;
  4. K2 (gated_nn) against its plain version at N = total_slots, L = 4096
     with gates built from two rendered frames;
  5. the main path: a 40-frame monocular session on the lateral textured
     world through SlamSystem.track_monocular, with the kernels' launch
     counters reset just before it.
Any failure raises (non-zero exit).  The line before the last is the
kernels JSON; the last line is {"ok": true, "device": {...}}.
Imports only the port, torch and numpy.
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
# version's elementwise kernels.  K2's distances are integer popcounts:
# (best, second, idx) must be identical.
BLUR_TOL = 1e-4


def _median_ms(fn, n=30, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, orb
    cfg = orb.OrbConfig()
    levels = orb.build_pyramid(torch.as_tensor(frame_img, device=dev), cfg)
    max_err = 0.0
    border_diff = 0
    level_ms, level_plain_ms = [], []
    for lvl, img in enumerate(levels):
        img = img.contiguous()
        ker = cuda_fast.fast_nms_blur(img, 7.0, 20.0)
        ref = cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
        torch.cuda.synchronize()
        for name, a, b in zip(("s_raw", "s20", "s7"), ker[:3], ref[:3]):
            bad = int((a[8:-8, 8:-8] != b[8:-8, 8:-8]).sum())
            if bad:
                raise AssertionError(f"K1 level {lvl} {name}: {bad} interior "
                                     "pixels differ")
            border_diff += int((a != b).sum())
        err = float((ker[3] - ref[3]).abs().max())
        if err > BLUR_TOL:
            raise AssertionError(f"K1 level {lvl} blur err {err} > {BLUR_TOL}")
        max_err = max(max_err, err)
        level_ms.append(_median_ms(lambda: cuda_fast.fast_nms_blur(img, 7.0, 20.0)))
        level_plain_ms.append(
            _median_ms(lambda: cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)))
    ms, plain_ms = sum(level_ms), sum(level_plain_ms)
    print(f"phase K1: 8 levels 480x752..{tuple(levels[-1].shape)} maps exact "
          f"on the interior ({border_diff} border pixels differ), blur "
          f"max_abs_err {max_err:.3g}; kernel {ms:.4f} ms/frame, plain "
          f"{plain_ms:.4f} ms/frame; per level kernel "
          f"{[round(x, 4) for x in level_ms]}, plain "
          f"{[round(x, 4) for x in level_plain_ms]}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                level_ms=level_ms, level_plain_ms=level_plain_ms,
                border_diff=border_diff)


def phase_k2(dev, img_a, img_b):
    import numpy as np
    import torch
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
        kb, ks, ki = cuda_matching.gated_nn(*a, level_slack=1)
        pb, ps, pi = cuda_matching.gated_nn_plain(*a, level_slack=1)
        torch.cuda.synchronize()
        for what, x, y in (("best", kb, pb), ("second", ks, ps), ("idx", ki, pi)):
            bad = int((x != y).sum())
            if bad:
                raise AssertionError(f"K2 {name} {what}: {bad} of {N} differ")
            max_err = max(max_err, float((x.double() - y.double()).abs().max()))
        n_ok += int((kb < 1e9).sum())
    ms = _median_ms(lambda: cuda_matching.gated_nn(*args, level_slack=1))
    plain_ms = _median_ms(lambda: cuda_matching.gated_nn_plain(*args, level_slack=1))
    print(f"phase K2: N={N} L={L} (best, second, idx) exact on {len(cases)} "
          f"cases ({n_ok} ungated rows); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, N=N, L=L)


def phase_main_path(dev):
    import numpy as np
    import torch
    from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu_torch.io import synthetic
    from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, cuda_matching
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (TrackerConfig,
                                                                TrackState)
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    n = 40
    R_gt, t_gt = synthetic.lateral_trajectory(n, x_span=1.0, z_span=0.0, y_amp=0.0)
    imgs = [synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
            for i in range(n)]
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   enable_loop_closing=False, device=str(dev)))
    torch.cuda.synchronize()
    cuda_fast.fast_nms_blur.launches = 0
    cuda_matching.gated_nn.launches = 0
    t0 = time.perf_counter()
    for i in range(n):
        slam.track_monocular(imgs[i], i * 0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cuda_fast.fast_nms_blur.launches
    k2 = cuda_matching.gated_nn.launches
    rows = slam.trajectory()
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], np.arange(n) * 0.1,
                           centers, True)
    stats = slam.stats()
    fused = slam.tracker.stats.get("fused_frames", 0)
    if slam.state != TrackState.OK:
        raise AssertionError(f"final state {slam.state}")
    if not (stats["n_kf"] >= 3 and nm > 25 and rmse < 0.06):
        raise AssertionError(f"n_kf {stats['n_kf']} nm {nm} ATE {rmse}")
    if not np.isfinite(rows[:, 1:]).all():
        raise AssertionError("non-finite trajectory")
    if k1 != 8 * n:
        raise AssertionError(f"K1 launched {k1} times, expected {8 * n}")
    if fused < 1 or k2 < 4 * fused:
        raise AssertionError(f"K2 launched {k2} times over {fused} fused frames")
    warm = np.asarray(slam.timings[5:]) * 1e3
    stages = {k: round(v["median_ms"], 3) for k, v in stats["stages"].items()}
    print(f"phase main path: {n} frames state OK, n_kf {stats['n_kf']}, "
          f"n_lm {stats['n_lm']}, ATE {rmse:.5f} over {nm} frames; "
          f"warm per-frame median {float(np.median(warm)):.2f} ms, "
          f"wall {wall:.2f} s; stage medians (ms) {json.dumps(stages)}; "
          f"K1 launches {k1}, K2 launches {k2} over {fused} fused frames")
    return dict(ate=rmse, nm=nm, n_kf=stats["n_kf"], n_lm=stats["n_lm"],
                frame_ms_median_warm=float(np.median(warm)),
                frame_ms=[float(x) for x in np.asarray(slam.timings) * 1e3],
                stages=stats["stages"], k1_launches=k1, k2_launches=k2,
                fused_frames=fused, wall_s=wall)


def main(argv=None):
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
    out["main"] = phase_main_path(dev)
    kernels = [
        dict(name="fast_nms_blur", route="cuda",
             source=f"{PKG}/csrc/fast_nms_blur.cu",
             replaces="orb_slam3_study_kr_tpu/ops/pallas_fast.py:122",
             launches=out["main"]["k1_launches"],
             max_abs_err=out["k1"]["max_abs_err"], ms=out["k1"]["ms"],
             plain_ms=out["k1"]["plain_ms"]),
        dict(name="gated_nn", route="cuda", source=f"{PKG}/csrc/gated_nn.cu",
             replaces="orb_slam3_study_kr_tpu/ops/pallas_matching.py:144",
             launches=out["main"]["k2_launches"],
             max_abs_err=out["k2"]["max_abs_err"], ms=out["k2"]["ms"],
             plain_ms=out["k2"]["plain_ms"]),
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, kernels=kernels), f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
