"""End-to-end monocular SLAM on the synthetic textured world.

Counterpart of the reference package's ``examples/run_synthetic.py``:
renders the lateral sequence, runs the full pipeline (ORB, tracking,
mapping, loop machinery), saves a TUM trajectory, scores RMS ATE against
the ground truth and prints the stage timings and the session's stats.

    python -m orb_slam3_study_kr_tpu_torch.examples.run_synthetic \\
        [n_frames] [out.txt] [--viz DIR] [--device cuda|cpu]
"""

import argparse

import numpy as np

from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=40)
    ap.add_argument("out", nargs="?", default="trajectory_tum.txt")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="write a dashboard PNG every 5 frames (matplotlib)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (cuda raises without a "
                         "card; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    n_frames = args.n_frames

    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R_gt, t_gt = synthetic.lateral_trajectory(n_frames, x_span=1.0,
                                              z_span=0.0, y_amp=0.0)
    slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=10),
                                   device=args.device))
    viewer = None
    if args.viz:
        from orb_slam3_study_kr_tpu_torch.viz import SessionViewer
        viewer = SessionViewer(slam, args.viz, stride=5)
    for i in range(n_frames):
        img = synthetic.render_textured(world, R_gt[i], t_gt[i], rng=rng)
        f = slam.track_monocular(img, i * 0.1)
        if viewer is not None:
            viewer.update(img, f)
        st = slam.stats()
        print(f"frame {i:3d}  {slam.state.name:15s} matches={f.n_matches:4d} "
              f"kf={st['n_kf']:3d} lm={st['n_lm']:5d}")

    slam.save_trajectory_tum(args.out)
    rows = slam.trajectory()
    centers = -np.einsum("nij,nj->ni", R_gt.transpose(0, 2, 1), t_gt)
    rmse, n, s = ate_rmse(rows[:, 0], rows[:, 1:4],
                          np.arange(n_frames) * 0.1, centers, with_scale=True)
    print(f"\ntrajectory: {args.out} ({rows.shape[0]} poses)")
    print(f"RMS ATE: {rmse:.4f} m over {n} frames (scale {s:.3f})")
    print()
    slam.print_time_stats()
    print()
    print("stats:", slam.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
