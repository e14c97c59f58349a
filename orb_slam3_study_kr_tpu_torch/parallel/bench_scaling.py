"""BA scaling micro-bench: LM iterations per second of the landmark-sharded
Schur BA against the shard count, at the reference's size (K = 64 poses,
M = 32768 landmarks, O = 131072 observations, 10 LM iterations).

    python -m orb_slam3_study_kr_tpu_torch.parallel.bench_scaling \\
        [n_shards] [--assembly pcg|dense|dense_chunked] [--device cuda|cpu]

Prints one JSON line.  The shards are in-process shards; with
``--device cuda`` they are spread over the visible cards in turn (shard i
on card i mod the count) and the run raises without a card.  On one card
every shard shares it, so the numbers measure what sharding costs (more,
smaller launches and the reductions), not a speedup.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_problem(K=64, M=32768, O=131072, seed=0):
    """The bench's seeded problem as numpy arrays (the reference's draws
    from ``np.random.default_rng(seed)`` in the reference's order)."""
    from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3
    from orb_slam3_study_kr_tpu_torch.parallel.multihost_worker import camera_fns

    project, _ = camera_fns("cpu")
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-5, 5, M), rng.uniform(-4, 4, M),
                  rng.uniform(5, 15, M)], -1).astype(np.float32)
    xi = np.array([[0.01 * k, -0.005 * k, 0, 0.2 * k, 0, 0]
                   for k in range(K)], np.float32)
    R0, t0 = (a.numpy() for a in exp_se3(torch.as_tensor(xi)))
    op = rng.integers(0, K, O).astype(np.int32)
    ol = rng.integers(0, M, O).astype(np.int32)
    p = np.einsum("oij,oj->oi", R0[op], X[ol]) + t0[op]
    ouv = (project(torch.as_tensor(p.astype(np.float32))).numpy()
           + rng.normal(0, 0.5, (O, 2)).astype(np.float32))
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    return dict(R0=R0, t0=t0, fixed=fixed, X=X, op=op, ol=ol,
                ouv=ouv.astype(np.float32), olev=np.zeros(O, np.int32),
                om=np.ones(O, np.float32))


def shard_devices(n_shards, device):
    """In-process shards on ``device``: CUDA shards go to the visible cards
    in turn (raises without a card)."""
    from orb_slam3_study_kr_tpu_torch.utils import resolve_device
    dev = resolve_device(device, "bench_scaling --device")
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * n_shards
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n_shards)]


def run(n_shards, K=64, M=32768, O=131072, n_iters=10, assembly="pcg",
        device="cuda", repeats=3, problem=None):
    """One warm-up solve, then the best of ``repeats`` timed solves.
    Returns dict(ba_iters_per_s, ms_per_iter, psum_per_iter, peak_bytes (the
    solves' peak device memory above what was allocated before them, CUDA
    only, else None), R, t, X) with X in the caller's landmark order."""
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjust, make_ba_mesh, shard_ba_problem)
    from orb_slam3_study_kr_tpu_torch.parallel.multihost_worker import camera_fns

    mesh = make_ba_mesh(shard_devices(n_shards, device))
    dev0 = mesh.devices[0]
    cuda = dev0.type == "cuda"
    pr = problem if problem is not None else build_problem(K, M, O)
    M = pr["X"].shape[0]
    (X_sh, lmm_sh, op_sh, ol_sh, ouv_sh, olev_sh, om_sh, dev_of_lm,
     local_of_lm, Mb, _) = shard_ba_problem(
        n_shards, pr["X"], np.ones(M, np.float32), pr["op"], pr["ol"],
        pr["ouv"], pr["olev"], pr["om"])
    project_fn, project_jac_fn = camera_fns(dev0)
    put = lambda a: torch.as_tensor(a, device=dev0)   # noqa: E731
    args = (mesh, project_fn, project_jac_fn, put(pr["R0"]), put(pr["t0"]),
            put(pr["fixed"]), put(X_sh), put(lmm_sh), put(op_sh), put(ol_sh),
            put(ouv_sh), put(olev_sh), put(om_sh))

    def solve():
        out = distributed_bundle_adjust(*args, n_iters=n_iters,
                                        assembly=assembly)
        if cuda:
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
        return out

    if cuda:
        torch.cuda.synchronize(dev0)
        torch.cuda.reset_peak_memory_stats(dev0)
        base = torch.cuda.memory_allocated(dev0)
    out = solve()
    best = np.inf
    for _ in range(repeats):
        n0 = mesh.n_psum
        t0 = time.perf_counter()
        out = solve()
        best = min(best, time.perf_counter() - t0)
    X = out[2].cpu().numpy()[dev_of_lm * Mb + local_of_lm]
    return dict(ba_iters_per_s=n_iters / best, ms_per_iter=best * 1e3 / n_iters,
                psum_per_iter=(mesh.n_psum - n0 - 1) / n_iters,
                peak_bytes=(torch.cuda.max_memory_allocated(dev0) - base
                            if cuda else None),
                R=out[0].cpu().numpy(), t=out[1].cpu().numpy(), X=X)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=1)
    ap.add_argument("--assembly", default="pcg",
                    choices=("dense", "dense_chunked", "pcg"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.n_shards, assembly=args.assembly, device=args.device)
    print(json.dumps({"n_devices": args.n_shards, "assembly": args.assembly,
                      "ba_iters_per_s": round(r["ba_iters_per_s"], 2),
                      "ms_per_iter": r["ms_per_iter"],
                      "psum_per_iter": r["psum_per_iter"],
                      "peak_bytes": r["peak_bytes"],
                      "device": (torch.cuda.get_device_name(0)
                                 if torch.device(args.device).type == "cuda"
                                 else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
