"""Device time per launch of K1-K3 over problem sizes, on one CUDA card.

    python3 -m orb_slam3_study_kr_tpu_torch.utils.kernel_sweep [--out sweep.json]

Each case times the bare launcher on inputs prepared once
(``profiling.device_ms_per_launch``).  The time at the smallest size is the
cost of a launch that does not scale with the work; the slope is the cost
per unit of work.  Inputs are random, made on the card from fixed seeds:
K1 takes uniform gray levels, K2 uniform projections over a 752x480 frame
with radii 4 * 1.2^level (the count of pairs that pass its gates is
printed), K3 all-valid descriptors as bits, timed as the fused launch
(rows and columns) that ``match_by_descriptor`` makes and as the rows
alone (``hamming_nn``: no column keys, no memset).  Prints the card's
nvidia-smi name and power limit, one line per kernel, then the whole
result as JSON.
"""

import argparse
import json
import subprocess

import torch

from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_matching
from orb_slam3_study_kr_tpu_torch.ops.orb import OrbConfig
from orb_slam3_study_kr_tpu_torch.utils.profiling import device_ms_per_launch

K2_SIZES = ((1000, 1), (1000, 512), (1000, 4096), (1000, 16384), (1000, 65536),
            (32, 4096), (256, 4096), (4000, 4096))
# K3: (W, Q, T), one shared query set against W target sets: the main
# path's Q = T = 1000 (relocalization, reference-keyframe tracking), the
# loop window's 11 x 1000 targets, and the ring world's 512 keypoints a
# keyframe, alone and in an 11-keyframe window.
K3_SIZES = ((1, 1000, 1), (1, 1000, 256), (1, 512, 512), (11, 512, 512),
            (1, 1000, 1000), (11, 1000, 1000), (1, 1000, 4000), (1, 4000, 1000))


def _bits(g, dev, *shape):
    return (torch.rand((*shape, 256), generator=g, device=dev) < 0.5).to(torch.uint8)


def _words(g, dev, *shape):
    return cuda_matching.pack_desc(_bits(g, dev, *shape))


def k2_inputs(dev, N, L, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    frame = torch.tensor([752.0, 480.0], device=dev)
    q, t = _words(g, dev, N), _words(g, dev, L)
    t_uv = torch.rand((L, 2), generator=g, device=dev) * frame
    q_uv = torch.rand((N, 2), generator=g, device=dev) * frame
    t_level = torch.randint(0, 8, (L,), generator=g, device=dev, dtype=torch.int32)
    q_level = torch.randint(0, 8, (N,), generator=g, device=dev, dtype=torch.int32)
    t_radius = 4.0 * torch.pow(torch.tensor(1.2, device=dev), t_level.float())
    q_valid = torch.rand(N, generator=g, device=dev) < 0.95
    t_valid = torch.rand(L, generator=g, device=dev) < 0.9
    return (q, q_uv, q_level, q_valid, t, t_uv, t_radius, t_level, t_valid)


def _passing(q, q_uv, q_level, q_valid, t, t_uv, t_radius, t_level, t_valid):
    d = (t_uv[:, None, :] - q_uv[None, :, :]).abs()
    r = t_radius[:, None]
    return int(((d[..., 0] <= r) & (d[..., 1] <= r)
                & ((q_level[None, :] - t_level[:, None]).abs() <= 1)
                & t_valid[:, None] & q_valid[None, :]).sum())


def sweep_k1(dev):
    sizes = OrbConfig().level_sizes
    cases = [("pyramid", sizes), ("7x7", ((7, 7),))]
    cases += [(f"level {h}x{w}", ((h, w),)) for h, w in sizes]
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, s in cases:
        levels = [torch.rand(hw, generator=g, device=dev) * 255.0 for hw in s]
        launch, _ = cuda_fast.fast_nms_blur_pyramid_call(levels, 7.0, 20.0)
        rows.append(dict(case=name, px=sum(h * w for h, w in s),
                         device_ms=device_ms_per_launch(launch)))
    return rows


def sweep_k2(dev):
    rows = []
    for N, L in K2_SIZES:
        args = k2_inputs(dev, N, L)
        launch, _ = cuda_matching.gated_nn_call(*args)
        rows.append(dict(N=N, L=L, passing=_passing(*args),
                         device_ms=device_ms_per_launch(launch)))
    return rows


def sweep_k3(dev):
    rows = []
    for W, Q, T in K3_SIZES:
        g = torch.Generator(device=dev).manual_seed(W + Q + T)
        tb = (W,) if W > 1 else ()
        args = (_bits(g, dev, Q), torch.ones(Q, dtype=torch.bool, device=dev),
                _bits(g, dev, *tb, T),
                torch.ones((*tb, T), dtype=torch.bool, device=dev))
        fused, _ = cuda_hamming.hamming_nn_call(*args, columns=True)
        rows_only, _ = cuda_hamming.hamming_nn_call(*args)
        rows.append(dict(W=W, Q=Q, T=T, device_ms=device_ms_per_launch(fused),
                         rows_only_ms=device_ms_per_launch(rows_only)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out = dict(card=card, k1=sweep_k1(dev), k2=sweep_k2(dev), k3=sweep_k3(dev))
    print("K1 (ms): " + ", ".join(
        f"{r['case']} {r['device_ms']:.5f}" for r in out["k1"]))
    print("K2 (ms): " + ", ".join(
        f"N={r['N']} L={r['L']} ({r['passing']} passing) {r['device_ms']:.5f}"
        for r in out["k2"]))
    print("K3 (ms): " + ", ".join(
        f"W={r['W']} Q={r['Q']} T={r['T']} {r['device_ms']:.5f} (rows only "
        f"{r['rows_only_ms']:.5f})" for r in out["k3"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
