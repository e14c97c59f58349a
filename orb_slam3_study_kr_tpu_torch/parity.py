"""Constants-parity audit versus the reference implementation.

Counterpart of ``orb_slam3_study_kr_tpu/parity.py``, reading the port's live
values: the two tables agree row for row (tests/test_torch_io.py).

ATE parity on real data depends on the behavioral thresholds of the
2k-line ORBmatcher + the tracking/mapping heuristics more than on solver
precision (SURVEY.md section 7, "hard parts" #1).  This table pins every
load-bearing constant to its reference citation, pulling OUR value live
from the code (so the audit can never silently drift from the
implementation), and explicitly records each deliberate deviation with
its rationale.

Printed by `python -m orb_slam3_study_kr_tpu_torch.parity`.
"""

from dataclasses import dataclass


@dataclass
class Row:
    name: str
    ours: object
    reference: object
    citation: str                # file:line in the reference's sources
    deviation: str = ""          # non-empty = deliberate difference + why


def audit_rows():
    """Build the table from LIVE values (imports resolve at call time)."""
    import inspect

    from orb_slam3_study_kr_tpu_torch.bow import database as _db_mod
    from orb_slam3_study_kr_tpu_torch.ops import (matching, stereo,
                                                  triangulation_match)
    from orb_slam3_study_kr_tpu_torch.pipeline import (inertial_tracking,
                                                       local_mapping,
                                                       loop_closing)
    from orb_slam3_study_kr_tpu_torch.pipeline.local_mapping import LocalMapper
    from orb_slam3_study_kr_tpu_torch.pipeline.system import SystemConfig
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    from orb_slam3_study_kr_tpu_torch.solvers import pnp, pose_opt, robust

    tc = TrackerConfig()
    sc = SystemConfig()
    # Field defaults only: no session is built, so no device is touched.
    lm = LocalMapper(cfg=TrackerConfig(device="cpu"), map=None)
    lc_sig = {k: v.default for k, v in inspect.signature(
        loop_closing.LoopCloser).parameters.items()}
    db_sig = {k: v.default for k, v in inspect.signature(
        _db_mod.KeyframeDatabase.detect_candidates).parameters.items()}
    pnp_sig = {k: v.default for k, v in inspect.signature(
        pnp.ransac_pnp).parameters.items()}
    tri_sig = {k: v.default for k, v in inspect.signature(
        triangulation_match.match_and_triangulate_batch).parameters.items()}

    R = Row
    return [
        # --- ORBmatcher constants (ORBmatcher.cc:35-37) ---
        R("matcher.TH_HIGH", matching.TH_HIGH, 100,
          "ORBmatcher.cc:35"),
        R("matcher.TH_LOW", matching.TH_LOW, 50, "ORBmatcher.cc:36"),
        R("matcher.HISTO_LENGTH", matching.HISTO_LENGTH, 30,
          "ORBmatcher.cc:37"),
        R("matcher.stereo_gate", stereo.DESC_GATE, 75.0,
          "Frame.cc:821 (TH_HIGH+TH_LOW)/2"),
        # --- robust kernels / chi2 gates (Optimizer.cc:870-874) ---
        R("chi2.mono", robust.CHI2_MONO, 5.991, "Optimizer.cc:871"),
        R("chi2.stereo", robust.CHI2_STEREO, 7.815, "Optimizer.cc:873"),
        R("chi2.inertial_huber_sq", 16.92, 16.92,
          "Optimizer.cc:543 (sqrt(16.92) Huber on 9-D inertial edges)"),
        # --- pose optimization (Optimizer.cc:815 PoseOptimization) ---
        R("pose_opt.rounds", pose_opt.N_ROUNDS, 4, "Optimizer.cc:1013"),
        R("pose_opt.iters_per_round", pose_opt.ITERS_PER_ROUND, 10,
          "Optimizer.cc:1014 its[4]={10,10,10,10}"),
        # --- ORB extraction (Examples/Monocular/EuRoC.yaml:50-63) ---
        R("orb.n_features", tc.n_features, 1000, "EuRoC.yaml:53"),
        R("orb.scale_factor", tc.orb_scale_factor, 1.2, "EuRoC.yaml:56"),
        R("orb.n_levels", tc.orb_n_levels, 8, "EuRoC.yaml:59"),
        R("orb.fast_ini", tc.orb_ini_th_fast, 20, "EuRoC.yaml:62"),
        R("orb.fast_min", tc.orb_min_th_fast, 7, "EuRoC.yaml:63"),
        # --- tracking heuristics (Tracking.cc) ---
        R("track.kf_ref_ratio", tc.kf_ref_ratio, 0.9,
          "Tracking.cc:3173-3177 thRefRatio=0.9f monocular"),
        R("track.max_frames_is_fps", tc.fps, 20.0,
          "Tracking.cc:676 mMaxFrames = fps"),
        R("track.min_init_matches", tc.min_init_matches, 100,
          "Tracking.cc:2487 (<100 restarts mono init)"),
        R("track.init_min_parallax", tc.init_min_parallax, 1.0,
          "TwoViewReconstruction.cc:116 minParallax=1.0",
          deviation="1.5 deg: batched RANSAC accepts slightly noisier "
                    "two-view solutions than the reference's sequential "
                    "refinement; the extra 0.5 deg of required baseline "
                    "compensates (tuned on synthetic worlds, NOTES.md)"),
        R("track.reloc_pnp_min_inliers", pnp_sig["min_inliers"], 15,
          "Tracking.cc:3714 (RANSAC SetParameters minInliers=15; our "
          "ransac_pnp min_inliers default, solvers/pnp.py:56)"),
        R("track.motion_model_widen", (3.0, 6.0), (7.0, 14.0),
          "ORBmatcher SearchByProjection th=7 then 2*th "
          "(Tracking.cc:2912-2928)",
          deviation="3 px base window (x2 on retry): the KLT-verified "
                    "matcher tolerates tighter gates; 7 px re-admits "
                    "aliased matches on self-similar texture (NOTES.md "
                    "pose-gated feedback)"),
        # --- local mapping (LocalMapping.cc) ---
        R("mapping.cull_found_ratio", local_mapping.CULL_FOUND_RATIO, 0.25,
          "LocalMapping.cc:375 GetFoundRatio<0.25f"),
        R("mapping.cull_min_obs", 2, 2,
          "LocalMapping.cc:370 nObs<=cnThObs (mono, 2 after 2 KFs)"),
        R("mapping.triangulation_neighbors", lm.n_neighbors, 30,
          "LocalMapping.cc:403 nn=30 monocular (10 stereo)",
          deviation="20: batched all-neighbor triangulation saturates "
                    "association earlier; >20 adds only baseline-gated "
                    "skips on EuRoC-like motion"),
        R("mapping.kf_cull_redundancy", lm.kf_redundancy_th, 0.9,
          "LocalMapping.cc:1030 (90% threshold)"),
        R("mapping.local_ba_window", lm.ba_window, None,
          "Optimizer.cc:1118-1132 (ALL covisible KFs optimized; "
          "observers fixed)",
          deviation="20-KF covisibility window: fixed-shape jit wants a "
                    "bounded window; 20 keeps longer-baseline anchors in "
                    "the solve (13% mono-ATE win over 12, NOTES round 4) "
                    "at one bucket of recompilation"),
        R("mapping.inertial_ba_window", 10, 10,
          "Optimizer.cc:2391 Nd=10 (25 if bLarge)"),
        # --- triangulation gates (LocalMapping.cc:398 CreateNewMapPoints)
        R("triangulation.epi_chi2", tri_sig["epi_chi2"], 3.84,
          "Pinhole.cpp:128 (dsqr < 3.84*unc epipolarConstrain)"),
        R("triangulation.reproj_chi2", triangulation_match.CHI2_MONO,
          5.991, "LocalMapping.cc:596,605"),
        R("triangulation.scale_ratio_slack", 1.5, 1.5,
          "LocalMapping.cc:439,719 ratioFactor=1.5f*scaleFactor"),
        R("triangulation.min_parallax_cos",
          triangulation_match.MIN_PARALLAX_COS, 0.9998,
          "LocalMapping.cc:608 cosParallaxRays<0.9998 (visual)"),
        # --- place recognition (KeyFrameDatabase.cc, LoopClosing.cc) ---
        R("bow.common_word_ratio", db_sig["min_common_ratio"], 0.8,
          "KeyFrameDatabase.cc:505-517 minCommonWords=0.8f*maxCommonWords"),
        R("bow.retain_ratio", db_sig["retain_ratio"], 0.75,
          "KeyFrameDatabase.cc:432-449 0.75f*bestAccScore"),
        R("loop.n_candidates", db_sig["n_best"], 3,
          "LoopClosing.cc:493 DetectNBestCandidates(3)"),
        R("loop.min_bow_matches", lc_sig["min_bow_matches"], 20,
          "LoopClosing.cc:583 nBoWMatches=20"),
        R("loop.min_ransac_inliers", lc_sig["min_ransac_inliers"], 15,
          "LoopClosing.cc:584 nBoWInliers=15"),
        R("loop.min_proj_matches", lc_sig["min_proj_matches"], 50,
          "LoopClosing.cc:586 nProjMatches=50"),
        R("loop.min_proj_opt_matches", lc_sig["min_proj_opt_matches"], 80,
          "LoopClosing.cc:587 nProjOptMatches=80"),
        R("loop.temporal_consistency", lc_sig["consistency_required"], 3,
          "LoopClosing.cc:398,446 (3 consecutive verified KFs)"),
        R("loop.min_map_kfs", loop_closing.MIN_MAP_KFS, 12,
          "LoopClosing.cc:364 (<12 KFs skips detection)"),
        R("loop.essential_graph_min_weight", 100, 100,
          "Optimizer.cc:1530 minFeat=100"),
        # --- IMU (LocalMapping.cc:187-249, ImuTypes.cc) ---
        R("imu.init_times", sc.imu_init_times, (2.0, 5.0, 15.0),
          "LocalMapping.cc:187-249 (IMU init @2s, VIBA1 @5s, VIBA2 @15s)"),
        R("imu.prior_schedule",
          tuple(inertial_tracking.IMU_PRIOR_SCHEDULE[k] for k in (1, 2, 3)),
          ((1e2, 1e10), (1.0, 1e5), (0.0, 0.0)),
          "LocalMapping.cc:1302-1343 priorG/priorA per stage"),
        R("imu.recently_lost_window_s", 5.0, 5.0,
          "Tracking.cc:2000-2012 time_recently_lost"),
        # --- stereo front end ---
        R("stereo.close_depth_factor", sc.depth_factor, 40.0,
          "Tracking.cc:673 mThDepth = bf * ThDepth / fx, ThDepth=40"),
    ]


def audit():
    """Returns (mismatches, deviations): rows whose live value differs
    from the reference without a documented deviation, and the documented
    deviations."""
    mism, devs = [], []
    for row in audit_rows():
        if row.deviation:
            devs.append(row)
        elif row.reference is not None and row.ours != row.reference:
            mism.append(row)
    return mism, devs


def main():
    rows = audit_rows()
    w = max(len(r.name) for r in rows)
    print(f"{'constant':{w}s}  ours          reference     citation")
    for r in rows:
        flag = " DEVIATION" if r.deviation else (
            "" if r.reference is None or r.ours == r.reference
            else " MISMATCH!")
        print(f"{r.name:{w}s}  {str(r.ours):12s}  "
              f"{str(r.reference):12s}  {r.citation}{flag}")
        if r.deviation:
            print(f"{'':{w}s}    -> {r.deviation}")
    mism, devs = audit()
    print(f"\n{len(rows)} constants: {len(mism)} undocumented mismatches, "
          f"{len(devs)} documented deviations")
    return 1 if mism else 0


if __name__ == "__main__":
    raise SystemExit(main())
