"""Multi-process BA worker: one process of a torch.distributed group.

Counterpart of ``orb_slam3_study_kr_tpu/parallel/multihost_worker.py``.
Launched N times with one coordinator port, every process builds the SAME
seeded bundle-adjustment problem, joins the group, shards the problem by
landmark over the global mesh (``--shards-per-process`` local shards in
each process), runs ``distributed_bundle_adjust`` (its reductions cross the
process boundaries), checks convergence against the ground truth, and
process 0 prints one JSON line with the timings.

Usage:
  python -m orb_slam3_study_kr_tpu_torch.parallel.multihost_worker \\
      <process_id> <num_processes> <coordinator_port> [n_iters] [assembly] \\
      [--backend gloo|nccl] [--device cuda|cuda:N|cpu]
      [--shards-per-process S] [--size K M O] [--out-dir DIR]

``--backend`` is required with more than one process; with one process
and no backend the shards run in-process with no process group.  NCCL
needs one card per rank; gloo serves the CPU and several ranks on one
card.  The worker never picks a backend itself.  ``--device cuda`` (the
default) puts rank r on card r mod the visible count and raises without a
card; ``--device cpu`` runs on the CPU.  ``--out-dir`` makes every rank
write ``rank<r>.npz`` (the poses and the gathered landmark table).
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

CAM = (458.0, 457.0, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def camera_fns(device):
    """The problem's pinhole camera on ``device``: (project_fn,
    project_jac_fn)."""
    from orb_slam3_study_kr_tpu_torch.cameras import pinhole
    cam = torch.tensor(CAM, dtype=torch.float32, device=device)
    return (functools.partial(pinhole.project, cam),
            functools.partial(pinhole.project_jac, cam))


def build_problem(K=12, M=4096, O=16384, noise=0.3, seed=0):
    """Synthetic GBA problem with known ground truth (the same on every
    process), as numpy arrays: the reference's draws from
    ``np.random.default_rng(seed)`` in the reference's order."""
    from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3

    def exp(xi):
        R, t = exp_se3(torch.as_tensor(np.asarray(xi, np.float32)))
        return R.numpy(), t.numpy()

    project, _ = camera_fns("cpu")
    rng = np.random.default_rng(seed)
    X_gt = np.stack([rng.uniform(-5, 5, M), rng.uniform(-4, 4, M),
                     rng.uniform(6, 14, M)], -1).astype(np.float32)
    Rs, ts = zip(*(exp([0.01 * k, -0.004 * k, 0.002 * k, 0.25 * k, 0.01 * k,
                        0]) for k in range(K)))
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    op = rng.integers(0, K, O).astype(np.int32)
    ol = rng.integers(0, M, O).astype(np.int32)
    p = np.einsum("oij,oj->oi", R_gt[op], X_gt[ol]) + t_gt[op]
    ouv = project(torch.as_tensor(p.astype(np.float32))).numpy()
    ouv = ouv + rng.normal(0, 0.5, ouv.shape).astype(np.float32)
    # Perturb the initial state; BA must pull it back.
    R0, t0 = [], []
    for k in range(K):
        d = np.zeros(6, np.float32)
        if k > 0:
            d[:3] = rng.normal(0, noise * 0.02, 3)
            d[3:] = rng.normal(0, noise * 0.2, 3)
        dR, dt = exp(d)
        R0.append(dR @ R_gt[k])
        t0.append(dR @ t_gt[k] + dt)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    X0 = X_gt + rng.normal(0, noise * 0.05, X_gt.shape).astype(np.float32)
    return dict(R_gt=R_gt, t_gt=t_gt, R0=np.stack(R0).astype(np.float32),
                t0=np.stack(t0).astype(np.float32), fixed=fixed,
                X0=X0.astype(np.float32), op=op, ol=ol,
                ouv=ouv.astype(np.float32), olev=np.zeros(O, np.int32),
                omask=np.ones(O, np.float32))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("n_iters", type=int, nargs="?", default=10)
    ap.add_argument("assembly", nargs="?", default="pcg",
                    choices=("dense", "dense_chunked", "pcg"))
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards-per-process", type=int, default=1)
    ap.add_argument("--size", type=int, nargs=3, metavar=("K", "M", "O"),
                    default=(12, 4096, 16384))
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    if args.num_processes > 1 and args.backend is None:
        ap.error("--backend is required with more than one process")
    return args


def rank_device(name, process_id):
    """The rank's device: a CUDA name without an index means card
    process_id mod the visible count; raises without a card."""
    from orb_slam3_study_kr_tpu_torch.utils import resolve_device
    dev = resolve_device(name, "multihost_worker --device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def main(argv):
    args = parse_args(argv)
    from orb_slam3_study_kr_tpu_torch.parallel import multihost
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjust, shard_ba_problem)

    dev = rank_device(args.device, args.process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if args.backend is not None:
        multihost.initialize(f"localhost:{args.port}", args.num_processes,
                             args.process_id, args.backend)
    try:
        mesh = multihost.global_mesh([dev] * args.shards_per_process)
        n_dev = mesh.size
        K, M, O = args.size
        prob = build_problem(K, M, O)
        (X_sh, lmm_sh, op_sh, ol_sh, ouv_sh, olev_sh, om_sh,
         _, _, _, _) = shard_ba_problem(
            n_dev, prob["X0"], np.ones(M, np.float32), prob["op"], prob["ol"],
            prob["ouv"], prob["olev"], prob["omask"])
        project_fn, project_jac_fn = camera_fns(dev)
        g = functools.partial(multihost.put_global, mesh=mesh)
        solve_args = (mesh, project_fn, project_jac_fn,
                      g(prob["R0"], sharded=False), g(prob["t0"], sharded=False),
                      g(prob["fixed"], sharded=False), g(X_sh, sharded=True),
                      g(lmm_sh, sharded=True), g(op_sh, sharded=True),
                      g(ol_sh, sharded=True), g(ouv_sh, sharded=True),
                      g(olev_sh, sharded=True), g(om_sh, sharded=True))

        def solve():
            out = distributed_bundle_adjust(*solve_args, n_iters=args.n_iters,
                                            assembly=args.assembly)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        solve()
        n0 = mesh.n_psum
        t0 = time.perf_counter()
        out = solve()
        dt = time.perf_counter() - t0
        psum_per_iter = (mesh.n_psum - n0 - 1) / args.n_iters
        R_f = multihost.fetch_replicated(out[0])
        t_f = multihost.fetch_replicated(out[1])
        X_f = multihost.gather_sharded(out[2], mesh)
    finally:
        if args.backend is not None:
            torch.distributed.destroy_process_group()

    # Convergence against the ground truth (the first pose fixes the gauge).
    pose_err = float(np.max(np.linalg.norm(t_f - prob["t_gt"], axis=1)))
    rot_err = float(np.max(np.linalg.norm(R_f - prob["R_gt"], axis=(1, 2))))
    if args.out_dir is not None:
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez(os.path.join(args.out_dir, f"rank{args.process_id}.npz"),
                 R=R_f, t=t_f, X=X_f)
    if args.process_id == 0:
        print(json.dumps({
            "ba_iters_per_s": round(args.n_iters / dt, 3),
            "wall_s": round(dt, 4),
            "pose_err": round(pose_err, 5),
            "rot_err": round(rot_err, 5),
            "n_processes": args.num_processes,
            "n_devices_global": n_dev,
            "assembly": args.assembly,
            "X_shape": list(X_f.shape),
            "backend": args.backend,
            "device": str(dev),
            "psum_per_iter": psum_per_iter,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
