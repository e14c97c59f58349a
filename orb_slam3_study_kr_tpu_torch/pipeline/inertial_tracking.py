"""Visual-inertial tracking: IMU preintegration between frames, IMU-based
pose prediction, pose-inertial frame solves and the staged IMU
initialization that rescales and gravity-aligns the map.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/inertial_tracking.py``
(Tracking::PreintegrateIMU, PredictStateIMU, PoseInertialOptimization
LastFrame, LocalMapping::InitializeIMU's 3-stage priorG/priorA schedule
with Map::ApplyScaledRotation, LocalInertialBA and FullInertialBA).

The mixin composes with the monocular and the stereo / RGB-D front ends;
stereo and RGB-D fix the scale during IMU init, monocular estimates it.
Once the IMU is initialized every frame solve is pose-inertial, so the
tracker takes the split rounds (``_custom_pose_opt_active``): each match is
a K2 launch and each solve ``_optimize_frame_pose`` below.  The IMU state
(bias, the keyframe chain, the raw log, the carried prior) is host numpy
as in the reference; the solves run on the tracker's device.
"""

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    ImuCalib, predict_state, preintegrate, preintegrate_batch)
from orb_slam3_study_kr_tpu_torch.pipeline.stereo_tracking import (
    FisheyeStereoTracker, StereoTracker)
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import (MonoTracker,
                                                            TrackState, _np)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM
from orb_slam3_study_kr_tpu_torch.solvers.inertial import (
    estimate_gyro_bias, inertial_only_optimization, pose_inertial_optimization,
    pose_inertial_optimization_last_frame)
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import inertial_bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers.robust import CHI2_MONO, CHI2_STEREO

# A frame window keeps its last 1024 samples, a keyframe interval its last
# 4096 (the reference's largest padding buckets).
FRAME_MAX_ROWS = 1024
KF_MAX_ROWS = 4096

# Staged (priorG, priorA) of the 3 IMU-init stages (stage 1 at t1, VIBA1 at
# t2, VIBA2 at t3).
IMU_PRIOR_SCHEDULE = {1: (1e2, 1e10), 2: (1.0, 1e5), 3: (0.0, 0.0)}


def _rows_tensors(rows, device):
    r = torch.as_tensor(np.asarray(rows, np.float32), device=device)
    return r[..., 1:4], r[..., 4:7], r[..., 0]


def _preintegrate_rows(rows, bias, calib: ImuCalib, max_rows):
    """rows: (M, 7) [dt, ax ay az, gx gy gz], the last `max_rows` kept ->
    Preintegrated on the calibration's device."""
    rows = np.asarray(rows, np.float32).reshape(-1, 7)[-max_rows:]
    acc, gyro, dts = _rows_tensors(rows, calib.device)
    return preintegrate(acc, gyro, dts,
                        torch.as_tensor(np.asarray(bias, np.float32),
                                        device=calib.device), calib)


def _preintegrate_intervals(rows_list, biases, calib: ImuCalib,
                            max_rows=KF_MAX_ROWS):
    """Every interval of rows_list (each (M_i, 7), its last max_rows kept)
    in one batched integration with per-interval biases (B, 6)."""
    rows_list = [np.asarray(r, np.float32).reshape(-1, 7)[-max_rows:]
                 for r in rows_list]
    B = len(rows_list)
    M = max([r.shape[0] for r in rows_list] + [1])
    padded = np.zeros((B, M, 7), np.float32)
    mask = np.zeros((B, M), np.float32)
    for i, r in enumerate(rows_list):
        padded[i, :r.shape[0]] = r
        mask[i, :r.shape[0]] = 1.0
    acc, gyro, dts = _rows_tensors(padded, calib.device)
    return preintegrate_batch(
        acc, gyro, dts, torch.as_tensor(mask, device=calib.device),
        torch.as_tensor(np.asarray(biases, np.float32).reshape(B, 6),
                        device=calib.device), calib)


def _body_from_cam(R_cw, t_cw, R_bc, t_bc):
    """Camera pose (world -> cam) -> body pose (R_wb, p_wb) given Tbc."""
    R_bw = R_bc @ R_cw
    t_bw = R_bc @ t_cw + t_bc
    R_wb = R_bw.T
    return R_wb, -R_wb @ t_bw


def _cam_from_body(R_wb, p_wb, R_bc, t_bc):
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    R_cw = R_cb @ R_wb.T
    return R_cw, -R_cw @ p_wb + t_cb


class ImuMixin:
    """IMU state and hooks shared by the inertial trackers."""

    def _init_imu_state(self, calib: ImuCalib, init_times=(2.0, 5.0, 15.0),
                        init_spacing=0.7):
        self.calib = calib
        self.imu_init_times = init_times
        # Minimum keyframe spacing inside the init solve: the scale signal
        # is the dt^2 accelerometer term, drowned by visual pose noise over
        # short intervals.
        self.imu_init_spacing = init_spacing
        # Starvation deadline past t1 before the first init accepts a
        # best-effort solve.
        self.imu_init_starve_patience = 1.5
        self.imu_stage = 0            # 0 = vision only; 1/2/3 = init stages
        self.bias = np.zeros(6, np.float32)
        self._imu_log = []            # (frame_ts, rows): samples ending at ts
        self.kf_imu = {}              # kf_id -> (prev_kf_id, rows (M, 7))
        self._pre_frame = None        # Preintegrated last frame -> current
        self._pred_v = None
        # 15-D marginal prior on the last frame's body state, carried
        # between consecutive frame solves while the map is unchanged.
        self._prior_info = None
        self._prior_change_idx = -1
        self._first_kf_ts = None
        self._last_glitch_ts = -1e9
        self._prev_kf_id = None       # temporal keyframe chain tail
        self._R_bc = _np(calib.R_bc).astype(np.float32)
        self._t_bc = _np(calib.t_bc).astype(np.float32)
        self._R_cb = self._R_bc.T.copy()
        self._t_cb = (-self._R_cb @ self._t_bc).astype(np.float32)

    # -------------------------------------------------------------- IMU I/O
    def _ingest_imu(self, imu_rows, timestamp):
        imu_rows = np.asarray(imu_rows, np.float32).reshape(-1, 7)
        self._imu_log.append((timestamp, imu_rows))
        if self.imu_stage >= 3 and len(self._imu_log) > 4096:
            # Past the final init only recent windows are re-integrated.
            self._imu_log = self._imu_log[-2048:]
        self._pred_v = None
        self._pre_frame = (_preintegrate_rows(imu_rows, self.bias, self.calib,
                                              FRAME_MAX_ROWS)
                           if imu_rows.shape[0] else None)

    def _rows_between(self, t0, t1):
        """All logged samples with frame timestamp in (t0, t1]."""
        chunks = [r for ts, r in self._imu_log if t0 < ts <= t1 and r.size]
        return (np.concatenate(chunks) if chunks
                else np.zeros((0, 7), np.float32))

    # ---------------------------------------------------------- prediction
    def _imu_predict(self, lf):
        """The body state after the frame window, from the last frame's."""
        R_wb, p_wb = _body_from_cam(lf.R_cw, lf.t_cw, self._R_bc, self._t_bc)
        out = predict_state(self._t(R_wb, torch.float32),
                            self._t(p_wb, torch.float32),
                            self._t(lf.v_w, torch.float32), self._pre_frame,
                            self._t(self.bias, torch.float32))
        R_n, p_n, v_n = (_np(a) for a in out)
        R_cw, t_cw = _cam_from_body(R_n, p_n, self._R_bc, self._t_bc)
        return R_cw.astype(np.float32), t_cw.astype(np.float32), v_n

    def _predict_pose(self):
        lf = self.last_frame
        if (self.imu_stage > 0 and self._pre_frame is not None
                and getattr(lf, "v_w", None) is not None and lf.pose_ok):
            R_cw, t_cw, self._pred_v = self._imu_predict(lf)
            return R_cw, t_cw
        return super()._predict_pose()

    # -------------------------------------------------- lost-mode survival
    TIME_RECENTLY_LOST = 5.0  # s

    def _lost_pose_estimate(self, frame):
        """IMU dead-reckoning while RECENTLY_LOST: with an initialized IMU
        the pose keeps integrating forward for up to TIME_RECENTLY_LOST
        seconds, so relocalization and re-tracking start from a sane
        prior."""
        lf = self.last_frame
        if (self.imu_stage > 0 and self.map.imu_initialized
                and self._pre_frame is not None and lf is not None
                and lf.R_cw is not None
                and getattr(lf, "v_w", None) is not None
                and self.last_ok_ts is not None
                and frame.timestamp - self.last_ok_ts
                <= self.TIME_RECENTLY_LOST):
            frame.R_cw, frame.t_cw, v = self._imu_predict(lf)
            frame.v_w = np.asarray(v, np.float32)
            frame.pose_ok = False
            self.stats["imu_only_frames"] = (
                self.stats.get("imu_only_frames", 0) + 1)
            return
        super()._lost_pose_estimate(frame)

    def _lost_deadline_passed(self, frame) -> bool:
        if self.map.imu_initialized and self.last_ok_ts is not None:
            return frame.timestamp - self.last_ok_ts > self.TIME_RECENTLY_LOST
        return super()._lost_deadline_passed(frame)

    # -------------------------------------------------------- optimization
    def _custom_pose_opt_active(self) -> bool:
        lf = self.last_frame
        return (self.imu_stage > 0 and self._pre_frame is not None
                and lf is not None and lf.pose_ok
                and getattr(lf, "v_w", None) is not None)

    def _optimize_frame_pose(self, frame, R0, t0):
        if not self._custom_pose_opt_active():
            return super()._optimize_frame_pose(frame, R0, t0)
        cfg, m, lf = self.cfg, self.map, self.last_frame
        with m.lock:
            stale = (frame.kp_lm != NO_LM) & ~m.lm_valid[
                np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            frame.kp_lm = np.where(stale, NO_LM, frame.kp_lm).astype(np.int32)
            X = m.lm_pos[np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            map_updated = m.change_idx != self._prior_change_idx
        mask = (frame.kp_lm != NO_LM) & frame.valid
        t = self._t
        R_wb0, p_wb0 = _body_from_cam(lf.R_cw, lf.t_cw, self._R_bc, self._t_bc)
        R_wbi, p_wbi = _body_from_cam(np.asarray(R0), np.asarray(t0),
                                      self._R_bc, self._t_bc)
        v_init = self._pred_v if self._pred_v is not None else lf.v_w
        anchor = (t(R_wb0, torch.float32), t(p_wb0, torch.float32),
                  t(lf.v_w, torch.float32), t(self.bias, torch.float32))
        common = (t(R_wbi, torch.float32), t(p_wbi, torch.float32),
                  t(v_init, torch.float32), t(self._R_cb), t(self._t_cb),
                  t(X, torch.float32), frame.dev("uv"), frame.dev("level"),
                  t(mask.astype(np.float32)))
        # After a map update (BA, a new keyframe, a loop) anchor hard on the
        # last frame's re-estimated state; otherwise chain through the last
        # frame as a free state under its 15-D marginal prior and carry the
        # Schur-marginalized information forward.
        if not map_updated and self._prior_info is not None:
            out = pose_inertial_optimization_last_frame(
                cfg.project_fn, *anchor, t(self._prior_info, torch.float32),
                self._pre_frame, *common, wide_fov=cfg.is_kb8)
        else:
            out = pose_inertial_optimization(cfg.project_fn, *anchor,
                                             self._pre_frame, *common,
                                             wide_fov=cfg.is_kb8)
        R, p, v, bias, inl, info = (_np(a) for a in out)
        self._prior_info = info if np.isfinite(info).all() else None
        self._prior_change_idx = m.change_idx
        inl = inl & mask
        R_cw, t_cw = _cam_from_body(R, p, self._R_bc, self._t_bc)
        frame.R_cw = R_cw.astype(np.float32)
        frame.t_cw = t_cw.astype(np.float32)
        frame.v_w = np.asarray(v, np.float32)
        self.bias = np.asarray(bias, np.float32)
        frame.kp_lm = np.where(inl, frame.kp_lm, NO_LM).astype(np.int32)
        self.stats["inertial_solves"] = self.stats.get("inertial_solves", 0) + 1
        return int(inl.sum())

    # ----------------------------------------------------------- keyframes
    def _create_keyframe(self, frame):
        self._note_initial_keyframes()
        prev_kf = self._prev_kf_id
        super()._create_keyframe(frame)
        kf = self.ref_kf
        self._prev_kf_id = kf
        m = self.map
        if prev_kf is not None and prev_kf != kf:
            self.kf_imu[kf] = (prev_kf, self._rows_between(
                float(m.kf_timestamp[prev_kf]), frame.timestamp))
        if self._first_kf_ts is None:
            self._first_kf_ts = frame.timestamp
        if frame.v_w is not None:
            m.kf_v[kf] = frame.v_w
        m.kf_bias[kf] = self.bias
        self._maybe_imu_init(frame)

    def _note_initial_keyframes(self):
        """Link keyframes created by the map initialization (mono two-view
        init, stereo first frame) into the IMU chain."""
        m = self.map
        if self._first_kf_ts is not None:
            return
        kfs = np.nonzero(m.kf_valid)[0]
        if kfs.size == 0:
            return
        self._first_kf_ts = float(m.kf_timestamp[kfs[0]])
        for a, b in zip(kfs[:-1], kfs[1:]):
            if b not in self.kf_imu:
                self.kf_imu[int(b)] = (int(a), self._rows_between(
                    float(m.kf_timestamp[a]), float(m.kf_timestamp[b])))
        self._prev_kf_id = int(kfs[-1])

    # ------------------------------------------------------------ IMU init
    def _kf_chain(self):
        """Valid keyframes in temporal order.  Intervals are rebuilt from
        the raw IMU log, so keyframe culling cannot break the chain."""
        m = self.map
        kfs = np.nonzero(m.kf_valid)[0]
        order = np.argsort(m.kf_timestamp[kfs], kind="stable")
        return [int(k) for k in kfs[order]]

    def _maybe_imu_init(self, frame):
        if self._first_kf_ts is None:
            return
        elapsed = frame.timestamp - self._first_kf_ts
        t1, t2, t3 = self.imu_init_times
        target = 0
        if elapsed >= t1:
            target = 1
        if elapsed >= t2:
            target = 2
        if elapsed >= t3:
            target = 3
        if target <= self.imu_stage:
            return
        # Gravity-observability gate: a stream whose accelerometer never
        # shows ~9.8 m/s^2 cannot constrain gravity or scale.
        recent = self._rows_between(self._first_kf_ts, frame.timestamp)
        if recent.shape[0]:
            acc_mag = float(np.median(np.linalg.norm(recent[:, 1:4], axis=1)))
            if not (2.0 < acc_mag < 30.0):
                self.stats["imu_init_rejected_acc"] = (
                    self.stats.get("imu_init_rejected_acc", 0) + 1)
                return
        chain = self._kf_chain()
        ts = self.map.kf_timestamp
        if self.imu_stage == 0:
            # First init: prefer a recent glitch-free stretch, but 1.5 s of
            # clean keyframes is enough.
            clean = [k for k in chain if ts[k] > self._last_glitch_ts]
            if len(clean) >= 4 and ts[clean[-1]] - ts[clean[0]] >= 1.5:
                chain = clean
            elif ts[chain[-1]] - ts[chain[0]] < self.imu_init_times[0]:
                return
        if len(chain) < 4:
            return
        # Subsample the temporal chain to >= imu_init_spacing intervals.
        sel = [chain[0]]
        for k in chain[1:]:
            if ts[k] - ts[sel[-1]] >= self.imu_init_spacing:
                sel.append(k)
        if sel[-1] != chain[-1]:
            sel.append(chain[-1])  # the newest keyframe is in the solve
        if len(sel) < 4:
            return
        for b in (16, 12, 10, 8, 6, 5, 4):
            if len(sel) >= b:
                sel = sel[-b:]
                break
        priors = IMU_PRIOR_SCHEDULE[target]
        # Starvation deadline: past t1 + patience the first init accepts a
        # best-effort solve (the refinement stages fix a coarse alignment).
        force = (self.imu_stage == 0
                 and elapsed > t1 + self.imu_init_starve_patience)
        with self.timers.stage(f"imu/init{target}"), self.map.lock:
            ok = self._imu_init_attempts(sel, priors, frame, force)
        if ok:
            self.imu_stage = target
            if target >= 3:
                # Final refinement done (Map::SetInertialBA2).
                self.map.imu_ba2 = True

    def _imu_init_attempts(self, sel, priors, frame, force):
        ts = self.map.kf_timestamp
        ok = False
        for _ in range(3):
            rows = [self._rows_between(float(ts[a]), float(ts[b]))
                    for a, b in zip(sel[:-1], sel[1:])]
            ok = self._run_imu_init(sel, rows, priors, frame)
            if ok or self.imu_stage > 0 or len(sel) <= 5:
                break
            # Glitch-keyframe excision: drop the interior chain keyframe
            # touching the worst whitened edge and re-solve.
            norms = self.stats.get("imu_init_edge_norms")
            if norms is None:
                break
            norms = np.asarray(norms)
            if norms.size != len(sel) - 1:
                break
            e = int(np.argmax(norms))
            cand_j = [j for j in (e, e + 1) if 0 < j < len(sel) - 1]
            if not cand_j:
                break

            def _adj(j):
                s = norms[j - 1] if j - 1 >= 0 else 0.0
                return s + (norms[j] if j < norms.size else 0.0)

            j = max(cand_j, key=_adj)
            sel = sel[:j] + sel[j + 1:]
            self.stats["imu_init_excised"] = (
                self.stats.get("imu_init_excised", 0) + 1)
        if not ok and force:
            rows = [self._rows_between(float(ts[a]), float(ts[b]))
                    for a, b in zip(sel[:-1], sel[1:])]
            ok = self._run_imu_init(sel, rows, priors, frame, force=True)
        return ok

    def _robust_gyro_bias(self):
        """Seed self.bias[:3] from the robust rotation-only solve over all
        consecutive keyframe pairs (solvers.inertial.estimate_gyro_bias)."""
        m = self.map
        kfs = np.nonzero(m.kf_valid)[0]
        order = np.argsort(m.kf_timestamp[kfs], kind="stable")
        kfs = kfs[order]
        if kfs.size < 4:
            return
        R1, R2, rows = [], [], []
        for a, b in zip(kfs[:-1], kfs[1:]):
            r = self._rows_between(float(m.kf_timestamp[a]),
                                   float(m.kf_timestamp[b]))
            if r.shape[0] == 0:
                continue
            R1.append(_body_from_cam(m.kf_R[a], m.kf_t[a], self._R_bc,
                                     self._t_bc)[0])
            R2.append(_body_from_cam(m.kf_R[b], m.kf_t[b], self._R_bc,
                                     self._t_bc)[0])
            rows.append(r)
        if len(rows) < 3:
            return
        pre_stack = _preintegrate_intervals(
            rows, np.tile(self.bias, (len(rows), 1)), self.calib)
        bg, w = estimate_gyro_bias(self._t(np.stack(R1), torch.float32),
                                   self._t(np.stack(R2), torch.float32),
                                   pre_stack)
        bg, w = _np(bg), _np(w)
        if np.isfinite(bg).all() and np.abs(bg).max() < 1.0:
            self.bias = self.bias.copy()
            self.bias[:3] = bg
            self.stats["gyro_bias_edges_down"] = int((w < 0.99).sum())

    def _run_imu_init(self, chain, rows, priors, frame, force=False):
        """InertialOptimization over the keyframe chain, then
        ApplyScaledRotation (LocalMapping::InitializeIMU).  With `force`
        the consistency gate is skipped; only the finiteness and
        scale-range checks remain."""
        m, cfg = self.map, self.cfg
        self._robust_gyro_bias()
        body = [_body_from_cam(m.kf_R[k], m.kf_t[k], self._R_bc, self._t_bc)
                for k in chain]
        pre_stack = _preintegrate_intervals(
            rows, np.tile(self.bias, (len(rows), 1)), self.calib)
        out = inertial_only_optimization(
            self._t(np.stack([b[0] for b in body]), torch.float32),
            self._t(np.stack([b[1] for b in body]), torch.float32), pre_stack,
            prior_gyro=priors[0], prior_acc=priors[1], fix_scale=cfg.bf > 0)
        out = {k: _np(v) for k, v in out.items()}
        s = float(out["scale"])
        self.stats["imu_init_edge_norms"] = out["edge_norms"]
        self.stats["imu_init_last_s"] = s
        if not np.isfinite(s) or s < 1e-2 or s > 1e2:
            return False
        if not m.imu_initialized:
            # First metric alignment: a window whose visual poses are not
            # mutually consistent leaves the whitened edges high and the
            # fitted scale meaningless; retry at the next keyframe.
            if not force and float(np.median(out["edge_norms"])) > 100.0:
                return False
        else:
            # Refinement stages keep only sanity bounds (a coarse first
            # init can be several x off; refining it is their job).
            ang = np.degrees(np.arccos(np.clip(
                (np.trace(out["R_wg"]) - 1) / 2, -1, 1)))
            if not (0.2 < s < 5.0 and ang < 45.0):
                return False
            bias_jump = np.abs(out["bias"] - self.bias)
            if bias_jump[3:].max() > 0.5 or bias_jump[:3].max() > 0.05:
                return False
        R_wg = out["R_wg"].astype(np.float32)
        bias_new = out["bias"].astype(np.float32)
        v = out["v"].astype(np.float32)

        # Re-express the map in the gravity-aligned, metric frame; the
        # solver's velocities are already metric, only re-oriented.
        R_gw = R_wg.T
        m.apply_scaled_rotation(R_gw, s)
        m.kf_v[chain] = v @ R_gw.T
        # Other keyframes' velocities by central differences of the (now
        # metric) keyframe positions.
        kfs = np.nonzero(m.kf_valid)[0]
        if kfs.size >= 2:
            centers = -np.einsum("kij,kj->ki",
                                 m.kf_R[kfs].transpose(0, 2, 1), m.kf_t[kfs])
            tss = m.kf_timestamp[kfs]
            others = ~np.isin(kfs, chain)
            for j in np.nonzero(others)[0]:
                a, b = max(j - 1, 0), min(j + 1, kfs.size - 1)
                dt = max(float(tss[b] - tss[a]), 1e-3)
                m.kf_v[kfs[j]] = (centers[b] - centers[a]) / dt
        # Every keyframe adopts the recovered bias.
        m.kf_bias[m.kf_valid] = bias_new
        self.bias = bias_new
        m.imu_initialized = True

        # Whole-chain visual-inertial BA right after the alignment (shared
        # bias with the stage's priors on the first metric alignment).
        first_init = "imu_init_scale" not in self.stats
        self.full_inertial_ba(
            shared_bias=first_init,
            prior_gyro=priors[0] if first_init else 0.0,
            prior_acc=priors[1] if first_init else 0.0, n_iters=15)

        # The current frame is the newest chain keyframe: take its state
        # from the transformed map; the last frame is transformed too.
        kf_new = chain[-1]
        frame.R_cw = m.kf_R[kf_new].copy()
        frame.t_cw = m.kf_t[kf_new].copy()
        frame.v_w = m.kf_v[kf_new].copy()
        lf = self.last_frame
        if lf is not None and lf is not frame and lf.R_cw is not None:
            lf.R_cw = (lf.R_cw @ R_gw.T).astype(np.float32)
            lf.t_cw = (s * lf.t_cw).astype(np.float32)
            if lf.v_w is not None:
                lf.v_w = (lf.v_w @ R_gw.T).astype(np.float32)
            else:
                lf.v_w = m.kf_v[kf_new].copy()
        self.velocity = None  # the visual motion model is stale
        self._speed_hist.clear()
        if "imu_init_scale" not in self.stats:
            self.stats["imu_init_scale"] = s   # first metric alignment
        self.stats["imu_refine_scale"] = s     # latest accepted stage
        return True

    # ------------------------------------------------------ inertial BA
    def local_inertial_ba(self, kf: int) -> bool:
        """LocalInertialBA: the last Nd keyframes (poses, velocities,
        biases) with the keyframe before the window as fixed inertial
        anchor, plus fixed visual observers.  Returns False when the
        problem is too small (the mapper then runs the visual local BA)."""
        chain = self._kf_chain()
        if len(chain) < 4 or kf != chain[-1]:
            return False
        nd = min(len(chain) - 2, 10)
        window = chain[-nd:]
        anchor = [chain[-nd - 1]] if len(chain) > nd else []
        if not anchor:
            anchor, window = [window[0]], window[1:]
        return self._vi_ba(opt_kfs=window, anchor_kfs=anchor, n_iters=8,
                           shared_bias=False, prior_gyro=0.0, prior_acc=0.0,
                           max_fixed_observers=24, cull=True)

    def full_inertial_ba(self, shared_bias, prior_gyro=0.0, prior_acc=0.0,
                         n_iters=15) -> bool:
        """FullInertialBA over the whole temporal chain; in shared_bias
        (init) mode one bias serves every inertial edge under the
        priorG/priorA prior."""
        chain = self._kf_chain()
        if len(chain) < 4:
            return False
        return self._vi_ba(opt_kfs=chain[1:], anchor_kfs=[chain[0]],
                           n_iters=n_iters, shared_bias=shared_bias,
                           prior_gyro=prior_gyro, prior_acc=prior_acc,
                           max_fixed_observers=0, cull=False,
                           anchor_vb_free=True)

    def _vi_ba(self, opt_kfs, anchor_kfs, n_iters, shared_bias, prior_gyro,
               prior_acc, max_fixed_observers, cull, anchor_vb_free=False):
        m, cfg, t = self.map, self.cfg, self._t
        chain_kfs = list(anchor_kfs) + list(opt_kfs)   # temporal order

        # Landmarks observed from the optimizable window.
        lms = np.unique(m.kf_kp_lm[np.asarray(opt_kfs)])
        lms = lms[(lms != NO_LM) & m.lm_valid[np.maximum(lms, 0)]]
        if lms.size < 20:
            return False

        # Fixed visual observers.
        seen = np.zeros(m.max_lm, bool)
        seen[lms] = True
        observing = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).any(axis=1)
        observing &= m.kf_valid
        fixed_ids = np.nonzero(observing)[0]
        fixed_ids = fixed_ids[~np.isin(fixed_ids, chain_kfs)]
        fixed_ids = fixed_ids[:max_fixed_observers]

        all_kf = np.asarray(chain_kfs + list(fixed_ids), np.int64)
        n_chain = len(chain_kfs)
        fixed = np.ones(all_kf.size, np.float32)
        fixed[len(anchor_kfs):n_chain] = 0.0
        # Gauge anchor of a whole-chain solve: pose frozen, velocity and
        # bias free.
        fixed_vb = fixed.copy()
        if anchor_vb_free:
            fixed_vb[: len(anchor_kfs)] = 0.0

        R_wb = np.zeros((all_kf.size, 3, 3), np.float32)
        p_wb = np.zeros((all_kf.size, 3), np.float32)
        for i, k in enumerate(all_kf):
            R_wb[i], p_wb[i] = _body_from_cam(m.kf_R[k], m.kf_t[k],
                                              self._R_bc, self._t_bc)
        v_w = m.kf_v[all_kf].astype(np.float32)
        bias = m.kf_bias[all_kf].astype(np.float32)

        # Inertial chain edges, each linearized at its first state's bias.
        ts = m.kf_timestamp
        rows = []
        for a in range(n_chain - 1):
            r = self._rows_between(float(ts[chain_kfs[a]]),
                                   float(ts[chain_kfs[a + 1]]))
            if r.shape[0] == 0:
                return False
            rows.append(r)
        pre_stack = _preintegrate_intervals(rows, bias[: n_chain - 1],
                                            self.calib)
        edge_i = np.arange(n_chain - 1)

        # Visual observations restricted to the selected landmarks.
        okf, okp, olm = m.observations(all_kf)
        keep = seen[olm]
        okf, okp, olm = okf[keep], okp[keep], olm[keep]
        kf_index = np.full(m.max_kf, -1, np.int64)
        kf_index[all_kf] = np.arange(all_kf.size)
        lm_index = np.full(m.max_lm, -1, np.int64)
        lm_index[lms] = np.arange(lms.size)

        stereo_kw = {}
        if cfg.bf > 0:
            stereo_kw = dict(obs_ur=t(m.kf_kp_ur[okf, okp], torch.float32),
                             bf=float(cfg.bf))
        f32 = torch.float32
        out = inertial_bundle_adjust(
            cfg.project_fn, cfg.project_jac_fn,
            t(R_wb), t(p_wb), t(v_w), t(bias), t(fixed),
            t(self._R_cb), t(self._t_cb),
            t(m.lm_pos[lms], f32), torch.ones(lms.size, device=self.device),
            t(kf_index[okf]), t(lm_index[olm]), t(m.kf_kp_uv[okf, okp], f32),
            t(m.kf_kp_level[okf, okp]),
            torch.ones(okf.size, device=self.device),
            t(edge_i), t(edge_i + 1), pre_stack,
            torch.ones(n_chain - 1, device=self.device),
            n_iters=n_iters, shared_bias=shared_bias, bias_src=n_chain - 1,
            prior_gyro=prior_gyro, prior_acc=prior_acc, fixed_vb=t(fixed_vb),
            wide_fov=cfg.is_kb8, **stereo_kw)
        R_f, p_f, v_f, b_f, X_f, chi2, cost = (_np(a) for a in out)
        if not (np.isfinite(float(cost)) and np.isfinite(R_f).all()
                and np.isfinite(p_f).all()):
            return False
        if shared_bias:
            b_f[:n_chain] = b_f[n_chain - 1]
        upd = np.asarray(chain_kfs[len(anchor_kfs):], np.int64)
        sel = kf_index[upd]
        for i, k in zip(sel, upd):
            R_cw, t_cw = _cam_from_body(R_f[i], p_f[i], self._R_bc, self._t_bc)
            m.kf_R[k] = R_cw.astype(np.float32)
            m.kf_t[k] = t_cw.astype(np.float32)
        m.kf_v[upd] = v_f[sel]
        m.kf_bias[upd] = b_f[sel]
        if anchor_vb_free:
            anc = np.asarray(anchor_kfs, np.int64)
            m.kf_v[anc] = v_f[kf_index[anc]]
            m.kf_bias[anc] = b_f[kf_index[anc]]
        m.lm_pos[lms] = X_f
        self.bias = m.kf_bias[chain_kfs[-1]].copy()

        if cull:
            if cfg.bf > 0:
                gate = np.where(m.kf_kp_ur[okf, okp] >= 0, CHI2_STEREO,
                                CHI2_MONO)
            else:
                gate = CHI2_MONO
            bad = chi2 > gate
            m.kf_kp_lm[okf[bad], okp[bad]] = NO_LM
            orphan = np.nonzero(m.lm_valid & (m.landmark_obs_count() < 2))[0]
            if orphan.size:
                m.remove_landmarks(orphan)
        m.change_idx += 1
        self.stats["n_inertial_ba"] = self.stats.get("n_inertial_ba", 0) + 1
        return True

    # ------------------------------------------------------------ frames
    def _after_inertial_frame(self, frame, timestamp):
        self._note_initial_keyframes()
        if self.state != TrackState.OK:
            self._last_glitch_ts = timestamp
        if frame.pose_ok and frame.v_w is None and self.imu_stage > 0:
            frame.v_w = self.map.kf_v[self.ref_kf].copy()
        return frame


def _calib_or_default(calib, cfg):
    return calib if calib is not None else ImuCalib.make(device=cfg.device)


class InertialTracker(ImuMixin, MonoTracker):
    """Monocular-inertial tracking (System::TrackMonocular with IMU)."""

    def __init__(self, cfg, slam_map, calib: ImuCalib = None,
                 imu_init_times=(2.0, 5.0, 15.0), **kw):
        super().__init__(cfg, slam_map, **kw)
        self._init_imu_state(_calib_or_default(calib, cfg), imu_init_times)

    def process_inertial(self, img, timestamp, imu_rows):
        self._ingest_imu(imu_rows, timestamp)
        return self._after_inertial_frame(self.process(img, timestamp),
                                          timestamp)


class StereoInertialTracker(ImuMixin, StereoTracker):
    """Stereo-inertial tracking (fixed-scale IMU init)."""

    def __init__(self, cfg, slam_map, calib: ImuCalib = None,
                 imu_init_times=(2.0, 5.0, 15.0), **kw):
        super().__init__(cfg, slam_map, **kw)
        self._init_imu_state(_calib_or_default(calib, cfg), imu_init_times)

    def process_stereo_inertial(self, img_left, img_right, timestamp,
                                imu_rows):
        self._ingest_imu(imu_rows, timestamp)
        return self._after_inertial_frame(
            self.process_stereo(img_left, img_right, timestamp), timestamp)


class RgbdInertialTracker(ImuMixin, StereoTracker):
    """RGB-D-inertial tracking: the RGB-D front end (depth-sampled virtual
    right coordinates) with the fixed-scale IMU machinery, composed as
    stereo-inertial is."""

    def __init__(self, cfg, slam_map, calib: ImuCalib = None,
                 imu_init_times=(2.0, 5.0, 15.0), **kw):
        super().__init__(cfg, slam_map, **kw)
        self._init_imu_state(_calib_or_default(calib, cfg), imu_init_times)

    def process_rgbd_inertial(self, img, depth_map, timestamp, imu_rows):
        self._ingest_imu(imu_rows, timestamp)
        return self._after_inertial_frame(
            self.process_rgbd(img, depth_map, timestamp), timestamp)


class FisheyeStereoInertialTracker(ImuMixin, FisheyeStereoTracker):
    """KB8 fisheye stereo-inertial tracking, the TUM-VI configuration
    (stereo_inertial_tum_vi): the non-rectified fisheye front end with the
    stereo-inertial IMU machinery, composed as stereo-inertial is.  The IMU
    init estimates the scale here instead of fixing it: the reference fixes
    it only when bf > 0, and a fisheye rig keeps bf = 0 (ROADMAP.md §3
    item 12)."""

    def __init__(self, cfg, slam_map, calib: ImuCalib = None,
                 imu_init_times=(2.0, 5.0, 15.0), **kw):
        super().__init__(cfg, slam_map, **kw)
        self._init_imu_state(_calib_or_default(calib, cfg), imu_init_times)

    process_stereo_inertial = StereoInertialTracker.process_stereo_inertial
