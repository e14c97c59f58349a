"""KITTI odometry sequence driver.

Counterpart of the reference package's ``examples/run_kitti.py`` (the
reference's mono_kitti.cc and stereo_kitti.cc): loads a
``sequences/<NN>`` directory (times.txt + image_0 [+ image_1]), takes the
camera intrinsics and the stereo baseline from calib.txt's P0 / P1 rows
(or from a calibration YAML), plays the frames through a SlamSystem
session and saves the trajectory in KITTI format.

    python -m orb_slam3_study_kr_tpu_torch.examples.run_kitti \\
        [--sensor mono|stereo] SEQ_DIR [--out traj_kitti.txt] \\
        [--settings KITTI.yaml] [--max-frames N] [--pace] [--device cuda|cpu]
"""

import argparse
import time

from orb_slam3_study_kr_tpu_torch.io.datasets import load_kitti
from orb_slam3_study_kr_tpu_torch.io.settings import Settings
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.utils import resolve_device


def build_system(seq, args):
    device = str(resolve_device(args.device, "--device"))
    if args.settings:
        tracker = Settings(args.settings).tracker_config(device=device)
    else:
        if seq.calib is None or "P0" not in seq.calib:
            raise SystemExit("no calib.txt P0 and no --settings YAML")
        P0 = seq.calib["P0"]
        h, w = seq.image(0).shape[:2]
        kw = dict(fx=float(P0[0, 0]), fy=float(P0[1, 1]),
                  cx=float(P0[0, 2]), cy=float(P0[1, 2]),
                  width=int(w), height=int(h),
                  n_features=2000,           # KITTIxx.yaml uses 2000
                  fps=10.0,                  # the KITTI camera rate
                  device=device)
        if args.sensor == "stereo" and "P1" in seq.calib:
            # P1[0, 3] = -fx * baseline for the right camera.
            kw["bf"] = float(-seq.calib["P1"][0, 3])
        tracker = TrackerConfig(**kw)
    return SlamSystem(SystemConfig(tracker=tracker, sensor=args.sensor,
                                   device=device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq", help="path to sequences/<NN>")
    ap.add_argument("--sensor", default="mono", choices=["mono", "stereo"])
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="traj_kitti.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pace", action="store_true",
                    help="deliver frames no faster than the camera rate")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (cuda raises without a "
                         "card; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    seq = load_kitti(args.seq)
    slam = build_system(seq, args)
    n = len(seq) if args.max_frames is None else min(len(seq),
                                                     args.max_frames)
    t_wall0 = time.perf_counter()
    # Mono: one-image lookahead, so that the upload of frame i+1 overlaps
    # the decode instead of running ahead of its extraction.
    pending = None
    for i in range(n):
        if args.pace and i > 0:
            lag = seq.ts[i] - (time.perf_counter() - t_wall0)
            if lag > 0:
                time.sleep(lag)
        if args.sensor == "stereo":
            slam.track_stereo(seq.image(i, 0), seq.image(i, 1), seq.ts[i])
        else:
            img = pending if pending is not None \
                else slam.upload_image(seq.image(i, 0))
            pending = (slam.upload_image(seq.image(i + 1, 0))
                       if i + 1 < n else None)
            slam.track_monocular(img, seq.ts[i])
    slam.flush()
    slam.save_trajectory_kitti(args.out)
    st = slam.stats()
    print(f"{n} frames  kf={st['n_kf']}  maps={st['n_maps']}  "
          f"-> {args.out}")
    slam.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
