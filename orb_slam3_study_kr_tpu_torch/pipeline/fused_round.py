"""The whole per-frame tracking slice as one torch function.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/fused_round.py``
(``fused_track_frame``): a flow-anchor prologue with KLT verification and
a pose pre-solve, a motion-model round with wide gates, the gated wide
retry, then the local-map rounds.  Each round is match (K2) -> KLT verify
-> bind -> pose GN; with ``use_klt=False`` (``TrackerConfig.klt_refine``
off) a match binds unverified and no observation moves.  With ``ambig_w``
< 1 a new binding whose KLT alignment is not distinctive enters the pose
solve at that weight.  For stereo and RGB-D frames the right
coordinate ``ur`` rides along: every pose solve gets the stereo row, and a
KLT move of a keypoint with ur >= 0 shifts ur by the same du.  Every step
runs on the device of its inputs with no host synchronisation; the gated
retry is always computed and its effects masked, as in the reference
program.  The frame's descriptors are packed into K2's words once per call
and shared by every round; the landmark block's descriptors may come
packed already (the tracker caches them with the block).
"""

import torch

from orb_slam3_study_kr_tpu_torch.ops import matching, track_match
from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import as_words
from orb_slam3_study_kr_tpu_torch.ops.klt import klt_refine
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
from orb_slam3_study_kr_tpu_torch.solvers.pose_opt import optimize_pose

_BIG = 1 << 30


def _flow_prologue(flow, blk_pos, blk_patch, kp_lm, kp_lm_pos, lm_mask,
                   f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
                   pyr, level_wh, use_klt, klt_zncc_min, klt_max_shift,
                   flow_radius):
    """Pose-free windowed descriptor match of the LAST frame's bound
    features against the current frame, first-wins on contested keypoints,
    KLT photometric verification (with ``use_klt``), then bind.  Positions
    and templates are gathered from the candidate block by each feature's
    block row."""
    (lf_uv, lf_desc, lf_angle, lf_bound, lf_gid, lf_row) = flow
    dev = f_uv.device
    lf_bound = lf_bound & (lf_row >= 0)
    row_cl = torch.clamp(lf_row.long(), 0, blk_pos.shape[0] - 1)
    lf_pos = blk_pos[row_cl]
    lf_tmpl = blk_patch[row_cl]
    idx, ok, _ = matching.search_for_initialization(
        lf_uv, lf_desc, lf_angle, lf_bound,
        f_uv, f_desc, f_angle, f_valid,
        window_radius=flow_radius, nn_ratio=0.8)
    n1 = lf_uv.shape[0]
    n2 = f_uv.shape[0]
    j_of = torch.where(ok & lf_bound, torch.arange(n1, device=dev),
                       torch.full((n1,), _BIG, device=dev))
    minj = torch.full((n2,), _BIG, dtype=torch.int64, device=dev).scatter_reduce(
        0, idx, j_of, reduce="amin", include_self=True)
    has = minj < _BIG
    src = torch.clamp(minj, 0, n1 - 1)
    cand_gid = torch.where(has, lf_gid[src], torch.full_like(lf_gid[src], NO_LM))
    cand_pos = lf_pos[src]
    cand_tmpl = lf_tmpl[src]
    mask = (cand_gid != NO_LM) & (kp_lm == NO_LM)
    uv_ref, distinct, good = _verify(use_klt, pyr, level_wh, f_uv_raw,
                                     f_level, f_angle, cand_tmpl, mask,
                                     klt_zncc_min, klt_max_shift)
    kp_lm = torch.where(good, cand_gid, kp_lm)
    kp_lm_pos = torch.where(good[:, None], cand_pos, kp_lm_pos)
    # Flow-bound landmarks leave the candidate block (row L = overflow).
    L = lm_mask.shape[0]
    row = torch.where(good, lf_row[src].long(), torch.full_like(src, L))
    row = torch.where(row < 0, torch.full_like(row, L), row)
    taken = torch.zeros(L + 1, dtype=lm_mask.dtype, device=dev).scatter_reduce(
        0, row, good.to(lm_mask.dtype), reduce="amax", include_self=True)[:L]
    lm_mask = lm_mask * (1.0 - taken)
    return kp_lm, kp_lm_pos, lm_mask, (uv_ref, distinct, good), good


def _verify(use_klt, pyr, level_wh, f_uv_raw, f_level, f_angle, tmpl, mask,
            klt_zncc_min, klt_max_shift):
    """(uv_ref, distinct, good) of the candidate matches in ``mask``: KLT
    alignment against their templates with ``use_klt``, else every
    candidate unmoved, with distinctiveness -1."""
    if not use_klt:
        return f_uv_raw, torch.full(mask.shape, -1.0, device=mask.device), mask
    uv_ref, zncc, shift, _win, distinct = klt_refine(
        pyr, level_wh, f_uv_raw, f_level, f_angle, tmpl, mask,
        max_shift=klt_max_shift)
    return uv_ref, distinct, mask & (zncc >= klt_zncc_min) & (
        shift < klt_max_shift)


def _round(project_fn, project_jac_fn, undistort_fn, R, t,
           lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
           lm_gid, lm_patch, kp_lm, kp_lm_pos,
           f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
           pyr, level_wh, width, height, th, nn_ratio, scale_factor,
           n_levels, level_slack, klt_zncc_min, klt_max_shift,
           klt_distinct_min, move_obs, ur=None, bf=None, apply_gate=None,
           max_theta_deg=None, wide_fov=False, use_klt=True, kp_w=None,
           ambig_w=None):
    """One match -> KLT verify -> bind -> pose-GN round.  With
    ``apply_gate`` (a bool tensor) the round's effects apply only where it
    is True.  ``kp_w`` (N,) weighs each observation in the pose solve; with
    ``ambig_w`` a new binding whose KLT alignment is not distinctive gets
    that weight."""
    lm_slot, ok, visible = track_match.match_local_map(
        project_fn, R, t,
        lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
        f_uv, f_level, f_desc, f_valid,
        width, height, th=th, nn_ratio=nn_ratio, scale_factor=scale_factor,
        n_levels=n_levels, level_slack=level_slack,
        max_theta_deg=max_theta_deg)
    gate = (torch.ones((), dtype=torch.bool, device=R.device)
            if apply_gate is None else apply_gate)
    free = kp_lm == NO_LM
    cand_ok = ok & free & gate
    uv_ref, distinct, good = _verify(use_klt, pyr, level_wh, f_uv_raw,
                                     f_level, f_angle, lm_patch[lm_slot],
                                     cand_ok, klt_zncc_min, klt_max_shift)

    kp_lm_new = torch.where(good, lm_gid[lm_slot], kp_lm)
    X = torch.where(good[:, None], lm_pos[lm_slot], kp_lm_pos)
    bound = (kp_lm_new != NO_LM) & f_valid
    if kp_w is None:
        kp_w = torch.ones(f_uv.shape[0], dtype=torch.float32, device=R.device)
    if use_klt and ambig_w is not None:
        w_new = torch.where(distinct >= klt_distinct_min,
                            torch.ones_like(kp_w), torch.full_like(kp_w, ambig_w))
        kp_w = torch.where(good & gate, w_new, kp_w)
    R_new, t_new, inl, _ = optimize_pose(
        project_fn, project_jac_fn, R, t, X, f_uv, f_level,
        bound.to(torch.float32) * kp_w, ur_obs=ur, bf=bf, wide_fov=wide_fov)
    R = torch.where(gate, R_new, R)
    t = torch.where(gate, t_new, t)
    inl = inl & bound
    kp_lm = torch.where(gate, torch.where(inl, kp_lm_new,
                                          torch.full_like(kp_lm, NO_LM)), kp_lm)
    kp_lm_pos = torch.where(gate, X, kp_lm_pos)

    taken = torch.zeros(lm_mask.shape[0], dtype=lm_mask.dtype,
                        device=lm_mask.device).scatter_reduce(
        0, lm_slot, (good & inl).to(lm_mask.dtype), reduce="amax",
        include_self=True)
    lm_mask = lm_mask * (1.0 - taken)

    moved = torch.zeros_like(good)
    if use_klt and move_obs:
        moved = good & inl & (distinct >= klt_distinct_min)
        f_uv, f_uv_raw, ur = _apply_moves(moved, uv_ref, f_uv, f_uv_raw, ur,
                                          undistort_fn)
    return (R, t, kp_lm, kp_lm_pos, inl, lm_mask, visible,
            f_uv, f_uv_raw, ur, moved, taken, kp_w)


def _apply_moves(move, uv_ref, f_uv, f_uv_raw, ur, undistort_fn):
    """Write accepted KLT moves into the frame coordinates; a stereo
    keypoint's right coordinate shifts by the same du."""
    if ur is not None:
        du = uv_ref[:, 0] - f_uv_raw[:, 0]
        ur = torch.where(move & (ur >= 0), ur + du, ur)
    f_uv_raw = torch.where(move[:, None], uv_ref, f_uv_raw)
    f_uv = torch.where(move[:, None], undistort_fn(f_uv_raw), f_uv)
    return f_uv, f_uv_raw, ur


def fused_track_frame(
    project_fn, project_jac_fn, undistort_fn,
    R0, t0,
    lm_pos, lm_desc, lm_gid, lm_patch,               # (L, ...) combined block
    lm_normal, lm_min_dist, lm_max_dist,             # real gates (local)
    mask_all, mask_wide,                             # (L,)
    kp_lm, kp_lm_pos,
    f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
    pyr, level_wh,
    width, height,
    min_track_matches,
    th_wide=3.0, th_wide_retry=6.0, th_local=1.0,
    nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    wide_slack=7, local_slack=1, max_theta_deg=None,
    klt_zncc_min=0.5, klt_max_shift=3.0, klt_distinct_min=0.15,
    wide_fov=False, use_klt=True, n_local_rounds=2, move_obs=True,
    ur_obs=None, bf=None,
    flow=None, flow_radius=40.0,
    R_last=None, t_last=None,
    ambig_w=None,
):
    """The whole per-frame tracking slice (see the module docstring).
    lm_desc is (L, 256) uint8 bits or (L, 8) int32 words; f_desc is the
    frame's (N, 256) uint8 bits; ur_obs (N,) the right coordinates of a
    stereo or RGB-D frame (-1 = mono) with bf = fx * baseline, or None.
    A fisheye frame passes its lens's max_theta_deg (the theta gate of
    every match) and wide_fov (the |p| > 1e-3 cheirality of every solve).

    Returns (R, t, kp_lm, inliers, visible_round1, n_mm,
    (f_uv, f_uv_raw, ur, moved), n_flow), all tensors on the input device
    (ur None for a mono frame)."""
    dev = R0.device
    R, t = R0, t0
    ur = ur_obs
    moved_any = torch.zeros(f_uv.shape[0], dtype=torch.bool, device=dev)
    n_flow = torch.zeros((), dtype=torch.int64, device=dev)
    mask_l = mask_all
    # Wide (frame-to-frame) gates from the PREDICTED camera centre: a
    # normal pointing at the camera and an unbounded distance band.
    center = -R0.T @ t0
    vecw = lm_pos - center
    lm_normal_w = vecw / torch.clamp(torch.linalg.norm(vecw, dim=1, keepdim=True),
                                     min=1e-9)
    lm_min_w = torch.zeros(lm_pos.shape[0], dtype=torch.float32, device=dev)
    lm_max_w = torch.full((lm_pos.shape[0],), 1e6, dtype=torch.float32, device=dev)

    if flow is not None:
        kp_lm, kp_lm_pos, mask_l, (fl_uv_ref, fl_distinct, fl_good), took = \
            _flow_prologue(flow, lm_pos, lm_patch, kp_lm, kp_lm_pos, mask_l,
                           f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
                           pyr, level_wh, use_klt, klt_zncc_min,
                           klt_max_shift, flow_radius)
        n_flow = took.sum()
        if use_klt and move_obs:
            move = fl_good & (fl_distinct >= klt_distinct_min)
            f_uv, f_uv_raw, ur = _apply_moves(move, fl_uv_ref, f_uv, f_uv_raw,
                                              ur, undistort_fn)
            moved_any = moved_any | move
        # Pose pre-solve on the pose-free bindings, started from the LAST
        # pose; applied when the prologue bound >= 20 features.
        if R_last is not None:
            bound0 = (kp_lm != NO_LM) & f_valid
            R_fl, t_fl, _, _ = optimize_pose(
                project_fn, project_jac_fn, R_last, t_last, kp_lm_pos,
                f_uv, f_level, bound0.to(torch.float32), ur_obs=ur, bf=bf,
                wide_fov=wide_fov)
            use_fl = bound0.sum() >= 20
            R = torch.where(use_fl, R_fl, R)
            t = torch.where(use_fl, t_fl, t)

    common = dict(nn_ratio=nn_ratio, scale_factor=scale_factor,
                  n_levels=n_levels, klt_zncc_min=klt_zncc_min,
                  klt_max_shift=klt_max_shift,
                  klt_distinct_min=klt_distinct_min, move_obs=move_obs,
                  max_theta_deg=max_theta_deg, wide_fov=wide_fov,
                  use_klt=use_klt, ambig_w=ambig_w)
    f_words = as_words(f_desc)
    lm_words = as_words(lm_desc)
    kp_w = torch.ones(f_uv.shape[0], dtype=torch.float32, device=dev)
    if flow is not None and use_klt and ambig_w is not None:
        kp_w = torch.where((kp_lm != NO_LM) & (fl_distinct < klt_distinct_min),
                           torch.full_like(kp_w, ambig_w), kp_w)

    def run(Rc, tc, kp_lm, kp_lm_pos, mask, wide, th, slack, f_uv, f_uv_raw,
            ur, kp_w, gate=None):
        gates = ((lm_normal_w, lm_min_w, lm_max_w) if wide
                 else (lm_normal, lm_min_dist, lm_max_dist))
        return _round(project_fn, project_jac_fn, undistort_fn, Rc, tc,
                      lm_pos, *gates, lm_words, mask, lm_gid, lm_patch,
                      kp_lm, kp_lm_pos,
                      f_uv, f_level, f_words, f_valid, f_uv_raw, f_angle,
                      pyr, level_wh, width, height, th, level_slack=slack,
                      ur=ur, bf=bf, apply_gate=gate, kp_w=kp_w, **common)

    # Motion-model round (wide gates over the wide-eligible rows), then the
    # in-program widened retry, which restarts from the base pose and takes
    # effect only when the first pass bound too few.
    R_base, t_base = R, t
    (R, t, kp_lm, kp_lm_pos, inl, _mw, _vis, f_uv, f_uv_raw, ur, mv,
     taken, kp_w) = run(R, t, kp_lm, kp_lm_pos, mask_l * mask_wide, True,
                        th_wide, wide_slack, f_uv, f_uv_raw, ur, kp_w)
    mask_l = mask_l * (1.0 - taken)
    moved_any = moved_any | mv
    need_retry = (kp_lm != NO_LM).sum() < min_track_matches
    R_r = torch.where(need_retry, R_base, R)
    t_r = torch.where(need_retry, t_base, t)
    (R, t, kp_lm, kp_lm_pos, inl, _mw, _vis, f_uv, f_uv_raw, ur, mv,
     taken, kp_w) = run(R_r, t_r, kp_lm, kp_lm_pos, mask_l * mask_wide, True,
                        th_wide_retry, wide_slack, f_uv, f_uv_raw, ur, kp_w,
                        gate=need_retry)
    mask_l = mask_l * (1.0 - taken)
    moved_any = moved_any | mv
    n_mm = (kp_lm != NO_LM).sum()

    visible_r1 = None
    for _ in range(n_local_rounds):
        (R, t, kp_lm, kp_lm_pos, inl, mask_l, vis, f_uv, f_uv_raw, ur, mv,
         _tk, kp_w) = run(R, t, kp_lm, kp_lm_pos, mask_l, False, th_local,
                          local_slack, f_uv, f_uv_raw, ur, kp_w)
        moved_any = moved_any | mv
        if visible_r1 is None:
            visible_r1 = vis

    return (R, t, kp_lm, inl, visible_r1, n_mm,
            (f_uv, f_uv_raw, ur, moved_any), n_flow)


def fused_track_rounds(
    project_fn, project_jac_fn, undistort_fn,
    R0, t0,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask, lm_gid,
    lm_patch,
    kp_lm, kp_lm_pos,
    f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
    pyr, level_wh,
    width, height,
    th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8, level_slack=1,
    max_theta_deg=None,
    klt_zncc_min=0.5, klt_max_shift=3.0, klt_distinct_min=0.15,
    wide_fov=False, use_klt=True, n_rounds=1, move_obs=True,
    ur_obs=None, bf=None,
    flow=None, flow_radius=40.0,
):
    """``n_rounds`` complete rounds over one padded landmark block (the
    split path's motion-model and local-map steps), optionally after the
    flow-anchor prologue.  Descriptors, ur_obs / bf and the fisheye
    max_theta_deg / wide_fov as in ``fused_track_frame``.

    Returns (R, t, kp_lm, inliers, visible_round1,
    (f_uv, f_uv_raw, ur, moved), n_flow)."""
    dev = R0.device
    R, t = R0, t0
    ur = ur_obs
    inl = torch.zeros(f_uv.shape[0], dtype=torch.bool, device=dev)
    moved_any = torch.zeros_like(inl)
    n_flow = torch.zeros((), dtype=torch.int64, device=dev)
    if flow is not None:
        kp_lm, kp_lm_pos, lm_mask, (fl_uv_ref, fl_distinct, fl_good), took = \
            _flow_prologue(flow, lm_pos, lm_patch, kp_lm, kp_lm_pos, lm_mask,
                           f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
                           pyr, level_wh, use_klt, klt_zncc_min,
                           klt_max_shift, flow_radius)
        n_flow = took.sum()
        if use_klt and move_obs:
            move = fl_good & (fl_distinct >= klt_distinct_min)
            f_uv, f_uv_raw, ur = _apply_moves(move, fl_uv_ref, f_uv, f_uv_raw,
                                              ur, undistort_fn)
            moved_any = moved_any | move
    visible_r1 = None
    f_words = as_words(f_desc)
    lm_words = as_words(lm_desc)
    for _ in range(n_rounds):
        (R, t, kp_lm, kp_lm_pos, inl, lm_mask, visible, f_uv, f_uv_raw, ur,
         mv, _tk, _w) = _round(project_fn, project_jac_fn, undistort_fn, R, t,
                           lm_pos, lm_normal, lm_min_dist, lm_max_dist,
                           lm_words, lm_mask, lm_gid, lm_patch, kp_lm,
                           kp_lm_pos, f_uv, f_level, f_words, f_valid,
                           f_uv_raw, f_angle, pyr, level_wh, width, height,
                           th, nn_ratio, scale_factor, n_levels, level_slack,
                           klt_zncc_min, klt_max_shift, klt_distinct_min,
                           move_obs, ur=ur, bf=bf,
                           max_theta_deg=max_theta_deg, wide_fov=wide_fov,
                           use_klt=use_klt)
        moved_any = moved_any | mv
        if visible_r1 is None:
            visible_r1 = visible
    return (R, t, kp_lm, inl, visible_r1, (f_uv, f_uv_raw, ur, moved_any),
            n_flow)
