"""EuRoC / TUM-VI sequence driver (the reference's example executables).

Counterpart of the reference package's ``examples/run_euroc.py``: loads one
or more sequences, plays them through one SlamSystem session (the next
sequence's first timestamp trips the timestamp-jump guard, which stores the
map and spawns a new one, as the reference's multi-sequence ChangeDataset
runs do), saves the TUM-format trajectory, and reports ATE against the
ground truth when the sequence ships it, aligned per map.

    python -m orb_slam3_study_kr_tpu_torch.examples.run_euroc \\
        --sensor stereo-inertial --settings EuRoC.yaml SEQ1/mav0 [SEQ2/mav0 ...] \\
        [--out traj.txt] [--pace] [--max-frames N] [--device cuda|cpu]

With --pace, frames are delivered no faster than the camera rate;
without it the sequence plays as fast as the session tracks.  The session
runs on --device (default cuda, which raises without a card).
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from orb_slam3_study_kr_tpu_torch.evaluation import ate_rmse
from orb_slam3_study_kr_tpu_torch.io.datasets import load_euroc
from orb_slam3_study_kr_tpu_torch.io.rectify import stereo_rectify
from orb_slam3_study_kr_tpu_torch.io.settings import Settings
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

SENSORS = ["mono", "mono-inertial", "stereo", "stereo-inertial"]


def _stereo_rig(st, tracker, settings_path):
    """The SystemConfig fields of the stereo rig, and the rectifier of a raw
    distorted pinhole rig (None for a rectified or a fisheye rig)."""
    rig = st.stereo()
    if rig is None:
        raise SystemExit(f"{settings_path}: no stereo calibration "
                         "(Camera.bf / Stereo.T_c1_c2) for a stereo sensor")
    raw_rig = (tracker.camera_model == "pinhole"
               and rig.get("R_rl") is not None
               and rig.get("cam2") is not None
               and any(abs(d) > 1e-12 for d in tracker.dist))
    if raw_rig:
        # A non-rectified distorted pinhole rig (raw EuRoC pairs): rectify
        # the images on the host and give the session the rectified
        # geometry.
        params_l = (tracker.fx, tracker.fy, tracker.cx, tracker.cy,
                    *(tuple(tracker.dist) + (0.0,) * 5)[:5])
        fx2, fy2, cx2, cy2, *dist2 = rig["cam2"]
        params_r = (fx2, fy2, cx2, cy2, *(tuple(dist2) + (0.0,) * 5)[:5])
        rectifier = stereo_rectify(params_l, params_r, rig["R_rl"],
                                   rig["t_rl"], tracker.width, tracker.height)
        f = float(rectifier.K_new[0, 0])
        tracker = dataclasses.replace(
            tracker, fx=f, fy=f, cx=tracker.width / 2.0,
            cy=tracker.height / 2.0, dist=(0.0,) * 5, bf=float(rectifier.bf))
        return dict(tracker=tracker, baseline=float(rectifier.baseline)), rectifier
    kw = dict(tracker=tracker,
              stereo_R_rl=tuple(map(tuple, np.asarray(rig["R_rl"]))),
              stereo_t_rl=tuple(np.asarray(rig["t_rl"])),
              baseline=float(rig["baseline"]))
    if rig.get("cam2") is not None:
        fx2, fy2, cx2, cy2, *dist2 = rig["cam2"]
        kw["tracker_right"] = dataclasses.replace(
            tracker, fx=fx2, fy=fy2, cx=cx2, cy=cy2, dist=tuple(dist2))
    return kw, None


def _imu_fields(st, rectifier, settings_path):
    """The SystemConfig fields of the IMU block.  The noise densities are the
    file's, per sqrt(Hz) (SystemConfig scales them to per-sample); R_bc is
    read in float32, as the session's ImuCalib holds it."""
    imu = st.imu_params()
    if imu is None:
        raise SystemExit(f"{settings_path}: no IMU block (IMU.NoiseGyro ...) "
                         "for an inertial sensor")
    R_bc = (np.eye(3) if imu["R_bc"] is None
            else np.asarray(imu["R_bc"], np.float32).astype(np.float64))
    t_bc = (np.zeros(3) if imu["t_bc"] is None
            else np.asarray(imu["t_bc"], np.float32).astype(np.float64))
    if rectifier is not None:
        # The tracker lives in the RECTIFIED left camera, so the body <-
        # camera rotation absorbs the rectifying rotation (Settings.cc:
        # Tbc_ = Tbc_ * T_r1_u1.inverse()): p_b = R_bc R_rect_l^T p_rect.
        # The translation stays: rectification rotates about the centre.
        R_bc = R_bc @ rectifier.R_rect_l.T
    return dict(imu_noise_gyro=imu["noise_gyro"], imu_noise_acc=imu["noise_acc"],
                imu_walk_gyro=imu["walk_gyro"], imu_walk_acc=imu["walk_acc"],
                imu_freq=imu["freq"], imu_R_bc=tuple(map(tuple, R_bc)),
                imu_t_bc=tuple(t_bc))


def build_system(args):
    """The session of args.sensor from args.settings (a calibration YAML;
    None = the EuRoC cam0 defaults) on args.device; ``slam.rectifier`` is the
    rectifier of a raw stereo rig, else None."""
    device = str(resolve_device(args.device, "--device"))
    rectifier = None
    if args.settings:
        st = Settings(args.settings)
        sys_kw = dict(tracker=st.tracker_config(device=device),
                      sensor=args.sensor)
        if args.sensor.startswith("stereo"):
            rig_kw, rectifier = _stereo_rig(st, sys_kw["tracker"],
                                            args.settings)
            sys_kw.update(rig_kw)
        if args.sensor.endswith("-inertial"):
            sys_kw.update(_imu_fields(st, rectifier, args.settings))
        cfg = SystemConfig(device=device, **sys_kw)
    else:
        # EuRoC cam0 defaults (EuRoC.yaml).
        cfg = SystemConfig(
            sensor=args.sensor, device=device,
            tracker=TrackerConfig(
                width=752, height=480, fx=458.654, fy=457.296,
                cx=367.215, cy=248.375,
                dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05,
                      0.0),
                fps=20.0, device=device))
    if args.vocabulary:
        cfg.vocabulary_path = args.vocabulary
    slam = SlamSystem(cfg)
    slam.rectifier = rectifier
    return slam


def run_sequence(slam, seq, args, inertial):
    """Play one sequence; returns the number of frames delivered."""
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    t_prev = None
    imu_dt = 1.0 / float(slam.cfg.imu_freq or 200.0)
    # One-image lookahead (mono): decode frame i+1 and start its upload
    # before tracking frame i, so the copy overlaps the decode instead of
    # running ahead of the frame's extraction.  Stereo reads each pair on
    # the host: the rectifier remaps there after the read.
    stereo = args.sensor.startswith("stereo")
    pending = None
    for i in range(n):
        ts = float(seq.cam0_ts[i])
        if pending is not None:
            img = pending
        else:
            img = seq.image(i)
            if not stereo:
                img = slam.upload_image(img)
        pending = None
        if not stereo and i + 1 < n:
            pending = slam.upload_image(seq.image(i + 1))
        imu = None
        if inertial and seq.imu_ts is not None:
            t0 = t_prev if t_prev is not None else ts - imu_dt
            its, gyro, acc = seq.imu_between(t0, ts)
            dts = np.diff(np.concatenate([[t0], its]))
            imu = np.concatenate(
                [dts[:, None], acc, gyro], axis=1).astype(np.float32)
        wall0 = time.perf_counter()
        if stereo and seq.cam1_files:
            img_r = seq.image(i, cam=1)
            rect = getattr(slam, "rectifier", None)
            if rect is not None:
                img = rect.remap_left(img)
                img_r = rect.remap_right(img_r)
            slam.track_stereo(img, img_r, ts, imu=imu)
        else:
            slam.track_monocular(img, ts, imu=imu)
        if args.pace and i + 1 < n:
            sleep = float(seq.cam0_ts[i + 1]) - ts - (time.perf_counter() - wall0)
            if sleep > 0:
                time.sleep(sleep)
        t_prev = ts
    return n


EUROC_MH = ["MH_01_easy", "MH_02_easy", "MH_03_medium",
            "MH_04_difficult", "MH_05_difficult"]
# The reference's published RMS ATE on EuRoC MH [m] (ORB-SLAM3, arXiv
# 2007.11898, monocular and stereo tables).
PARITY_BOUNDS = {
    "mono": {"MH_01_easy": 0.016, "MH_02_easy": 0.027,
             "MH_03_medium": 0.028, "MH_04_difficult": 0.138,
             "MH_05_difficult": 0.072},
    "stereo": {"MH_01_easy": 0.029, "MH_02_easy": 0.019,
               "MH_03_medium": 0.024, "MH_04_difficult": 0.085,
               "MH_05_difficult": 0.052},
}


def run_parity(args):
    """Run every EuRoC MH sequence found under args.parity, each as its own
    session, align with evaluate_ate_scale semantics, and print the table
    against the published bounds (parity: within 20 %).  Returns 1 when a
    sequence that ran misses its bound."""
    bounds = PARITY_BOUNDS.get(args.sensor, {})
    rows = []
    for seq_name in EUROC_MH:
        seq_root = os.path.join(args.parity, seq_name, "mav0")
        if not os.path.isdir(seq_root):
            rows.append((seq_name, None, bounds.get(seq_name), "missing"))
            continue
        slam = build_system(args)
        seq = load_euroc(seq_root)
        t0 = time.perf_counter()
        n = run_sequence(slam, seq, args, args.sensor.endswith("-inertial"))
        wall = time.perf_counter() - t0
        slam.flush()
        rmse = None
        if seq.gt_ts is not None:
            traj = slam.trajectory()
            rmse, _, _ = ate_rmse(traj[:, 0], traj[:, 1:4], seq.gt_ts,
                                  seq.gt_pos, with_scale=args.sensor == "mono")
        rows.append((seq_name, rmse, bounds.get(seq_name),
                     f"{n / max(wall, 1e-9):.1f} f/s"))
    print(f"\nEuRoC {args.sensor} parity (RMS ATE, m - "
          f"evaluate_ate_scale semantics):")
    print(f"{'sequence':18s} {'ours':>8s} {'reference':>10s}  status")
    n_pass = n_run = 0
    for name, rmse, bound, note in rows:
        ours = "-" if rmse is None else f"{rmse:.3f}"
        ref = "-" if bound is None else f"{bound:.3f}"
        status = note
        if rmse is not None and bound is not None:
            n_run += 1
            ok = rmse <= bound * 1.2
            n_pass += ok
            status = "PASS" if ok else "FAIL"
        print(f"{name:18s} {ours:>8s} {ref:>10s}  {status}")
    if n_run:
        print(f"{n_pass}/{n_run} sequences at parity")
    return 0 if n_run == 0 or n_pass == n_run else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequences", nargs="*",
                    help="one or more <sequence>/mav0 directories; several "
                         "sequences run through ONE session (ChangeDataset)")
    ap.add_argument("--sensor", default="mono", choices=SENSORS)
    ap.add_argument("--settings", default=None, help="calibration YAML")
    ap.add_argument("--vocabulary", default=None,
                    help="ORBvoc text file or cached .npz")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--pace", action="store_true",
                    help="deliver frames at dataset rate")
    ap.add_argument("--max-frames", type=int, default=-1)
    ap.add_argument("--parity", default=None, metavar="EUROC_ROOT",
                    help="run every MH sequence under this root (each its own "
                         "session) and print the ATE table against the "
                         "reference's published bounds")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (cuda raises without a "
                         "card; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    if not args.parity and not args.sequences:
        ap.error("sequences required (or --parity EUROC_ROOT)")
    return args


def run(args, slam=None):
    """Play args.sequences through one session (``slam``, default
    ``build_system(args)``), save the TUM trajectory to args.out, print the
    per-map ATE where ground truth exists; returns the SlamSystem."""
    if slam is None:
        slam = build_system(args)
    inertial = args.sensor.endswith("-inertial")
    total, wall = 0, 0.0
    gt_all = []
    for si, root in enumerate(args.sequences):
        seq = load_euroc(root)
        print(f"[{si + 1}/{len(args.sequences)}] {root}: "
              f"{len(seq)} frames", flush=True)
        t0 = time.perf_counter()
        total += run_sequence(slam, seq, args, inertial)
        wall += time.perf_counter() - t0
        if seq.gt_ts is not None:
            gt_all.append((seq.gt_ts, seq.gt_pos))

    slam.save_trajectory_tum(args.out)
    print(f"tracked {total} frames in {wall:.1f}s "
          f"({total / max(wall, 1e-9):.1f} f/s), "
          f"maps={len(slam.atlas.maps)}, state={slam.state.name}")
    print(f"trajectory -> {args.out}")

    if gt_all:
        # Each map has its own gauge (and, for mono, its own scale) after a
        # timestamp-jump spawn: align and report per map, then pool the
        # residuals into one RMSE.
        rows, map_ids = slam.trajectory(with_map_ids=True)
        gt_ts = np.concatenate([g[0] for g in gt_all])
        gt_pos = np.concatenate([g[1] for g in gt_all])
        with_scale = args.sensor == "mono"
        sq_sum, n_sum = 0.0, 0
        for mid in np.unique(map_ids):
            sel = map_ids == mid
            if sel.sum() < 3:
                continue
            rmse, nm, _ = ate_rmse(rows[sel, 0], rows[sel, 1:4],
                                   gt_ts, gt_pos, with_scale=with_scale)
            if nm == 0:
                continue
            print(f"  map {mid}: ATE RMSE {rmse:.4f} m over {nm} frames"
                  f"{' (scale-aligned)' if with_scale else ''}")
            sq_sum += rmse * rmse * nm
            n_sum += nm
        if n_sum:
            print(f"ATE RMSE {np.sqrt(sq_sum / n_sum):.4f} m over {n_sum} "
                  f"matched frames (per-map alignment)")
    return slam


def main(argv=None):
    args = parse_args(argv)
    if args.parity:
        return run_parity(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
