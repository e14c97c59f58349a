"""Loop detection and correction (replaces src/LoopClosing.cc, visual path).

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/loop_closing.py``.  The
reference's verification cascade (LoopClosing.cc:325-820), stage for stage:

  1. BoW candidate retrieval (KeyFrameDatabase::DetectNBestCandidates).
  2. Descriptor matching of landmark-bound keypoints against the candidate
     and its covisible window, >= nBoWMatches=20 (K3, one batched launch
     per pass for the whole window).
  3. Sim3 RANSAC >= nBoWInliers=15.
  4. Guided SearchByProjection of the window's landmarks through the coarse
     Sim3 (K2) >= nProjMatches=50.
  5. OptimizeSim3, then a second guided projection >= nProjOptMatches=80.
  6. Temporal consistency: the region must verify in >= 3 consecutive
     keyframes, propagating the Sim3 through relative odometry.

On acceptance the loop is corrected (CorrectLoop): an essential-graph
Sim3 / 4-DoF pose solve with every earlier loop edge retained, landmark
re-expression through each point's reference keyframe, loop-point
SearchAndFuse duplicate welding, and a global BA.

Small results come back to the host at the reference's fetch points as
explicit ``.cpu()`` copies; the solvers themselves never synchronise.
The Sim3 RANSAC draws come from ``uniforms_fn(iters, n)`` when given (tests
inject the reference's jax.random stream), else from a torch.Generator
seeded 17, the reference's PRNGKey.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch import native
from orb_slam3_study_kr_tpu_torch.bow.database import KeyframeDatabase
from orb_slam3_study_kr_tpu_torch.ops.track_match import (match_by_descriptor,
                                                          match_local_map)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers.pose_graph import (optimize_pose_graph,
                                                             relative_sim3)
from orb_slam3_study_kr_tpu_torch.solvers.sim3_solver import (optimize_sim3,
                                                              ransac_sim3)
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

MIN_MAP_KFS = 12        # reference skips loop detection below 12 KFs
COVIS_EDGE_WEIGHT = 100
MAX_WINDOW_LMS = 4096   # padded landmark count for the guided projections
SIM3_RANSAC_ITERS = 128
SIM3_PAD = 256          # padded match count of the Sim3 solves


def _pad(a, n, fill=0):
    out = np.full((n, *a.shape[1:]), fill, a.dtype)
    out[: min(len(a), n)] = a[:n]
    return out


def _np(t):
    return t.detach().cpu().numpy()


@dataclass
class LoopCloser:
    cfg: "TrackerConfig"
    map: MapState
    db: KeyframeDatabase
    inertial: bool = False
    run_gba: bool = True    # full-map BA after the pose-graph correction
    ba_mesh: object = None  # parallel.dist_ba.BaMesh -> landmark-sharded GBA
    gba_iters: int = 10     # LoopClosing.cc:2289 nIterations=10
    gba_inertial_iters: int = 7   # FullInertialBA(pActiveMap, 7, ...)
    imu: object = None      # global_ba.ImuIntervals of an inertial session
    # Cascade gates (reference values, LoopClosing.cc:583-587).
    min_bow_matches: int = 20       # nBoWMatches
    min_ransac_inliers: int = 15    # nBoWInliers
    min_proj_matches: int = 50      # nProjMatches
    min_proj_opt_matches: int = 80  # nProjOptMatches
    consistency_required: int = 3   # consecutive-KF verifications
    max_not_found: int = 2          # pending dropped after this many misses
    stats: dict = field(default_factory=lambda: {
        "n_queries": 0, "n_candidates": 0, "n_stage_bow": 0,
        "n_stage_ransac": 0, "n_stage_proj": 0, "n_verified": 0,
        "n_pending": 0, "n_rejected_temporal": 0, "n_corrected": 0,
        "n_fused_loop": 0, "n_gba": 0})
    loop_edges: list = field(default_factory=list)  # accepted (kf, cand)
    uniforms_fn: object = None   # (iters, n) -> uniforms of one Sim3 RANSAC
    _pending: dict = None        # candidate awaiting temporal consistency
    _gen: object = None

    def __post_init__(self):
        self.device = resolve_device(self.cfg.device, "TrackerConfig.device")
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(17)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int):
        """Run the detection cascade for one new keyframe; correct the loop
        once temporal consistency is reached.  Returns True on correction."""
        m = self.map
        corrected = False
        with m.lock:
            big_enough = m.n_kf >= MIN_MAP_KFS
        if big_enough:
            self.stats["n_queries"] += 1
            if self._pending is not None:
                corrected = self._advance_pending(kf)
            if not corrected and self._pending is None:
                for cand in self._detect(kf):
                    self.stats["n_candidates"] += 1
                    hit = self._verify_cascade(kf, cand)
                    if hit is not None:
                        self.stats["n_verified"] += 1
                        self._pending = dict(
                            cand=cand, window=hit["window"],
                            Scw=hit["Scw"], last_kf=kf, count=1, not_found=0)
                        self.stats["n_pending"] += 1
                        if self.consistency_required <= 1:
                            corrected = self._accept(kf)
                        break
        with m.lock:
            self.db.add(kf, m.kf_desc[kf, : m.max_kp], m.kf_kp_valid[kf])
        return corrected

    # ------------------------------------------------------------------
    def _detect(self, kf: int):
        m = self.map
        with m.lock:
            covis, _ = m.covisibility(kf, min_shared=5)
            exclude = set(covis.tolist()) | {kf}
            return self.db.detect_candidates(
                m.kf_desc[kf], m.kf_kp_valid[kf], exclude=exclude,
                covisibility=lambda k: m.covisibility(k, min_shared=15)[0][:5],
                n_best=3)

    # ------------------------------------------------------------------
    def _window_landmarks(self, cand: int):
        """Landmarks of the candidate and its 10 best covisible neighbors
        (LoopClosing.cc:613 nNumCovisibles)."""
        m = self.map
        with m.lock:
            nbs, _ = m.covisibility(cand, min_shared=15)
            kfs = [cand] + [int(k) for k in nbs[:10]]
            lms = np.unique(m.kf_kp_lm[kfs])
            lms = lms[lms != NO_LM]
            return lms[m.lm_valid[lms]], kfs

    # ------------------------------------------------------------------
    def _guided_match(self, kf: int, lms: np.ndarray, R_s, t_s, s_s, th=3.0):
        """SearchByProjection(KeyFrame, Scw, points): project window
        landmarks through the world->camera Sim3 normalized to [R | t/s]
        into the keyframe (K2, padded to MAX_WINDOW_LMS).  Returns
        (kp_idx, lm_ids) of accepted pairs."""
        m = self.map
        n = min(lms.size, MAX_WINDOW_LMS)
        lms = lms[:n]
        mask = np.zeros(MAX_WINDOW_LMS, np.float32)
        mask[:n] = 1.0
        t = self._t
        with m.lock:
            out = match_local_map(
                self.cfg.project_fn, t(R_s, torch.float32),
                t(np.asarray(t_s, np.float32) / np.float32(s_s)),
                t(_pad(m.lm_pos[lms], MAX_WINDOW_LMS)),
                t(_pad(m.lm_normal[lms], MAX_WINDOW_LMS)),
                t(_pad(m.lm_min_dist[lms], MAX_WINDOW_LMS)),
                t(_pad(m.lm_max_dist[lms], MAX_WINDOW_LMS)),
                t(_pad(m.lm_desc[lms], MAX_WINDOW_LMS)), t(mask),
                t(m.kf_kp_uv[kf]), t(m.kf_kp_level[kf]), t(m.kf_desc[kf]),
                t(m.kf_kp_valid[kf]),
                self.cfg.width, self.cfg.height, th=th, max_dist=50.0,
                max_theta_deg=self.cfg.max_theta_deg)
        lm_slot, ok = _np(out[0]), _np(out[1])
        ok = ok & (lm_slot < n)
        kp_idx = np.nonzero(ok)[0]
        return kp_idx, lms[lm_slot[kp_idx]]

    # ------------------------------------------------------------------
    def _refine_sim3(self, kf: int, cand: int, kp_idx, lm_ids, R12, t12, s12):
        """OptimizeSim3 on the guided matches over S12 (candidate camera ->
        current camera).  Pairs need the current keypoint's own landmark for
        the inverse edge; unbound keypoints are dropped from the solve."""
        m = self.map
        t = self._t
        with m.lock:
            lm1 = m.kf_kp_lm[kf, kp_idx]
            keep = (lm1 != NO_LM) & m.lm_valid[np.clip(lm1, 0, None)]
            kp_idx, lm_ids, lm1 = kp_idx[keep], lm_ids[keep], lm1[keep]
            if kp_idx.size < 3:
                return None
            P1 = m.lm_pos[lm1] @ m.kf_R[kf].T + m.kf_t[kf]
            P2 = m.lm_pos[lm_ids] @ m.kf_R[cand].T + m.kf_t[cand]
            uv1 = m.kf_kp_uv[kf, kp_idx]
            N = SIM3_PAD
            P2_d = t(_pad(P2.astype(np.float32), N))
            out = optimize_sim3(
                t(_pad(P1.astype(np.float32), N)), P2_d,
                t(_pad(np.ones(kp_idx.size, np.float32), N)),
                t(_pad(uv1.astype(np.float32), N)),
                self.cfg.project_fn(P2_d), self.cfg.K,
                t(R12, torch.float32), t(t12, torch.float32),
                t(s12, torch.float32), fix_scale=self.inertial,
                project_fn=self.cfg.project_fn)
        return (_np(out["R12"]), _np(out["t12"]),
                float(out["s12"].cpu()))

    # ------------------------------------------------------------------
    @staticmethod
    def _compose_scw(R12, t12, s12, R_c, t_c):
        """Scw = S12 . T_cand_w  (world -> current camera, scaled)."""
        return R12 @ R_c, s12 * R12 @ t_c + t12, s12

    @staticmethod
    def _s12_from_scw(R_s, t_s, s_s, R_c, t_c):
        """S12 = Scw . T_w_cand  (candidate camera -> current camera)."""
        R12 = R_s @ R_c.T
        return R12, t_s - s_s * R12 @ t_c, s_s

    # ------------------------------------------------------------------
    def _bow_window_match(self, kf: int, cand: int):
        """Stage-2 descriptor matching of the current keyframe against the
        candidate AND its 10 best covisible neighbors, accumulated per
        current keypoint (DetectCommonRegionsFromBoW, LoopClosing.cc:
        620-692): one batched K3 pass per direction for the whole window;
        per keypoint the lowest-distance window hit wins.

        Returns (kp1, lm2, win_kfs): matched current keypoints, the window
        landmark each matched, and the window keyframes."""
        m = self.map
        t = self._t
        with m.lock:
            nbs, _ = m.covisibility(cand, min_shared=15)
            win_kfs = [cand] + [int(k) for k in nbs[:10]]
            # bAbortByNearKF: a window keyframe covisible with the current
            # keyframe makes the "loop" plain spatial adjacency.
            connected, _ = m.covisibility(kf, min_shared=15)
            if np.isin(win_kfs, connected).any():
                return np.empty(0, np.int64), np.empty(0, np.int32), win_kfs
            W = len(win_kfs)
            b1 = m.kf_kp_lm[kf] != NO_LM
            t_bound = m.kf_kp_lm[win_kfs] != NO_LM
            idx, ok, best = match_by_descriptor(
                t(m.kf_desc[kf]), t(m.kf_kp_valid[kf] & b1),
                t(m.kf_desc[win_kfs]), t(m.kf_kp_valid[win_kfs] & t_bound))
        idx, ok, best = _np(idx), _np(ok), _np(best)
        best = np.where(ok, best, np.inf)           # (W, N)
        wsel = np.argmin(best, axis=0)              # best window KF per kp
        n = idx.shape[1]
        any_ok = np.isfinite(best[wsel, np.arange(n)])
        with m.lock:
            lm2 = np.full(n, NO_LM, np.int32)
            for w in range(W):
                rows = np.nonzero(any_ok & (wsel == w))[0]
                lm2[rows] = m.kf_kp_lm[win_kfs[w], idx[w, rows]]
            good = (lm2 != NO_LM) & m.lm_valid[np.clip(lm2, 0, None)]
        kp1 = np.nonzero(good)[0]
        return kp1, lm2[kp1], win_kfs

    def _uniforms(self, iters, n):
        if self.uniforms_fn is not None:
            return self._t(self.uniforms_fn(iters, n), torch.float32)
        return torch.rand((iters, n), generator=self._gen).to(self.device)

    # ------------------------------------------------------------------
    def _verify_cascade(self, kf: int, cand: int):
        """Stages 2-5 for a fresh candidate.  Returns dict(Scw, window) or
        None."""
        m = self.map
        t = self._t
        kp1, lm2, _ = self._bow_window_match(kf, cand)
        if kp1.size < self.min_bow_matches:
            return None
        self.stats["n_stage_bow"] += 1
        N = SIM3_PAD
        uniforms = self._uniforms(SIM3_RANSAC_ITERS, N)
        with m.lock:
            lm1 = m.kf_kp_lm[kf, kp1]
            P1 = m.lm_pos[lm1] @ m.kf_R[kf].T + m.kf_t[kf]
            P2 = m.lm_pos[lm2] @ m.kf_R[cand].T + m.kf_t[cand]
            uv1 = m.kf_kp_uv[kf, kp1]
            uv2 = _np(self.cfg.project_fn(t(P2.astype(np.float32))))
            out = ransac_sim3(
                t(_pad(P1, N)), t(_pad(P2, N)),
                t(_pad(np.ones(len(kp1), np.float32), N)), t(_pad(uv1, N)),
                t(_pad(uv2, N)), self.cfg.K, uniforms,
                fix_scale=self.inertial, project_fn=self.cfg.project_fn)
        n_inl = int(out["n_inliers"].cpu())
        if n_inl < self.min_ransac_inliers:
            return None
        self.stats["n_stage_ransac"] += 1
        R12, t12, s12 = _np(out["R12"]), _np(out["t12"]), float(out["s12"].cpu())
        # Stage 4: guided projection of the candidate window's landmarks.
        window, _ = self._window_landmarks(cand)
        with m.lock:
            R_c, t_c = m.kf_R[cand].copy(), m.kf_t[cand].copy()
        Scw = self._compose_scw(R12, t12, s12, R_c, t_c)
        kp_idx, lm_ids = self._guided_match(kf, window, *Scw, th=3.0)
        if kp_idx.size < self.min_proj_matches:
            return None
        self.stats["n_stage_proj"] += 1
        # Stage 5: OptimizeSim3 refinement + re-projection gate.
        ref = self._refine_sim3(kf, cand, kp_idx, lm_ids, R12, t12, s12)
        if ref is None:
            return None
        Scw = self._compose_scw(*ref, R_c, t_c)
        kp_idx, lm_ids = self._guided_match(kf, window, *Scw, th=1.5)
        if kp_idx.size < self.min_proj_opt_matches:
            return None
        return dict(Scw=Scw, window=window)

    # ------------------------------------------------------------------
    def _advance_pending(self, kf: int):
        """DetectAndReffineSim3FromLastKF: propagate the pending Sim3 through
        relative odometry to this keyframe and re-verify stages 4-5; accept
        once `consistency_required` consecutive KFs confirmed."""
        m = self.map
        p = self._pending
        last, cand = p["last_kf"], p["cand"]
        with m.lock:
            # Scw_cur = T_cur_last . Scw_last from the current poses.
            R_cl = m.kf_R[kf] @ m.kf_R[last].T
            t_cl = m.kf_t[kf] - R_cl @ m.kf_t[last]
            R_c, t_c = m.kf_R[cand].copy(), m.kf_t[cand].copy()
        R_s, t_s, s_s = p["Scw"]
        Scw = (R_cl @ R_s, R_cl @ t_s + s_s * t_cl, s_s)
        kp_idx, lm_ids = self._guided_match(kf, p["window"], *Scw, th=3.0)
        if kp_idx.size >= self.min_proj_matches:
            S12 = self._s12_from_scw(*Scw, R_c, t_c)
            ref = self._refine_sim3(kf, cand, kp_idx, lm_ids, *S12)
            if ref is not None:
                Scw_ref = self._compose_scw(*ref, R_c, t_c)
                kp_idx, _ = self._guided_match(kf, p["window"], *Scw_ref,
                                               th=1.5)
                if kp_idx.size >= self.min_proj_opt_matches:
                    p.update(Scw=Scw_ref, last_kf=kf, not_found=0)
                    p["count"] += 1
                    if p["count"] >= self.consistency_required:
                        return self._accept(kf)
                    return False
        p["not_found"] += 1
        if p["not_found"] >= self.max_not_found:
            self.stats["n_rejected_temporal"] += 1
            self._pending = None
        return False

    # ------------------------------------------------------------------
    def _accept(self, kf: int):
        m = self.map
        p = self._pending
        self._pending = None
        cand = p["cand"]
        with m.lock:
            R12, t12, s12 = self._s12_from_scw(*p["Scw"], m.kf_R[cand],
                                               m.kf_t[cand])
            self._correct(kf, cand, dict(R12=R12, t12=t12, s12=s12))
            self._search_and_fuse(kf, p["window"])
        self.stats["n_corrected"] += 1
        self._run_gba()
        return True

    # ------------------------------------------------------------------
    def _correct(self, kf: int, cand: int, sim3):
        """Essential-graph correction: the loop edge constrains
        S_kf = S12 . S_cand; every earlier loop edge participates."""
        m = self.map
        kfs = np.nonzero(m.kf_valid)[0]
        K = kfs.size
        pos = {int(k): i for i, k in enumerate(kfs)}
        R_old = m.kf_R[kfs].copy()
        t_old = m.kf_t[kfs].copy()

        ei, ej, w = [], [], []

        def add_edge(i, j, weight=1.0):
            ei.append(pos[i]); ej.append(pos[j]); w.append(weight)

        # Covisibility spanning tree: each keyframe's parent is the earlier
        # keyframe it shares most observations with, else its temporal
        # predecessor.
        order = {int(k): i for i, k in enumerate(kfs)}
        for a in kfs[1:]:
            a = int(a)
            nb, wts = m.covisibility(a, min_shared=1)
            parent, best_w = None, 0
            for j, wj in zip(nb, wts):
                if order[int(j)] < order[a] and wj > best_w:
                    parent, best_w = int(j), int(wj)
            if parent is None:
                parent = int(kfs[order[a] - 1])
            add_edge(a, parent)
        # Strong covisibility edges.
        for i in kfs:
            nb, wts = m.covisibility(int(i), min_shared=COVIS_EDGE_WEIGHT)
            for j, _ in zip(nb[:5], wts):
                if int(j) > int(i) + 1:
                    add_edge(int(i), int(j))
        # Earlier loop edges, re-measured from the poses.
        for (a, b) in self.loop_edges:
            if a in pos and b in pos:
                add_edge(a, b, weight=5.0)
        self.loop_edges.append((int(kf), int(cand)))

        # The reference pads vertices and edges to buckets (padded vertices
        # fixed at identity, padded edges weight 0); kept for parity.
        Kp = max(16, -(-K // 16) * 16)
        E = len(ei) + 1                       # + the measured loop edge
        Ep = max(64, -(-E // 64) * 64)
        R_p = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        t_p = np.zeros((Kp, 3), np.float32)
        R_p[:K] = m.kf_R[kfs]
        t_p[:K] = m.kf_t[kfs]
        ei_p = np.zeros(Ep, np.int64)
        ej_p = np.zeros(Ep, np.int64)
        w_p = np.zeros(Ep, np.float32)
        ei_p[: E - 1] = ei
        ej_p[: E - 1] = ej
        w_p[: E - 1] = w
        t = self._t
        R_dev, t_dev = t(R_p), t(t_p)
        s_dev = torch.ones(Kp, dtype=torch.float32, device=self.device)
        ei_d, ej_d = t(ei_p), t(ej_p)

        # Measured relative Sim3 of every non-loop edge, batched.
        Rm, tm, sm = relative_sim3(R_dev[ei_d], t_dev[ei_d], s_dev[ei_d],
                                   R_dev[ej_d], t_dev[ej_d], s_dev[ej_d])
        # The new loop edge, measured as S12.
        le = E - 1
        ei_p[le], ej_p[le], w_p[le] = pos[kf], pos[cand], 5.0
        Rm[le] = t(sim3["R12"], torch.float32)
        tm[le] = t(sim3["t12"], torch.float32)
        sm[le] = float(sim3["s12"])

        fixed = np.ones(Kp, np.float32)
        fixed[1:K] = 0.0                      # origin keyframe anchors
        R_f, t_f, s_f = optimize_pose_graph(
            R_dev, t_dev, s_dev, t(ei_p), t(ej_p), Rm, tm, sm, t(w_p),
            t(fixed), n_iters=20, dof=4 if self.inertial else 7)
        R_f, t_f, s_f = _np(R_f)[:K], _np(t_f)[:K], _np(s_f)[:K]

        # Scaled-rigid per keyframe: [R | t/s] keeps SE3 poses.
        m.kf_R[kfs] = R_f
        m.kf_t[kfs] = t_f / s_f[:, None]

        # Landmarks: re-express through the keyframe that first observed
        # them, X_new = S_new^-1(S_old(X)).
        lms = np.nonzero(m.lm_valid)[0]
        if lms.size:
            ref_kf = np.clip(m.lm_first_kf[lms], 0, m.max_kf - 1)
            ref_idx = np.array([pos.get(int(k), 0) for k in ref_kf])
            pc = (np.einsum("nij,nj->ni", R_old[ref_idx], m.lm_pos[lms])
                  + t_old[ref_idx])
            m.lm_pos[lms] = np.einsum(
                "nji,nj->ni", R_f[ref_idx], pc - t_f[ref_idx]) / s_f[ref_idx][:, None]
        m.change_idx += 1

    # ------------------------------------------------------------------
    def _search_and_fuse(self, kf: int, window_lms: np.ndarray):
        """Loop-point fusion (LoopClosing::SearchAndFuse): project the loop
        side's landmarks into the current keyframe and its covisible
        neighbors (poses already corrected); duplicates are welded in favor
        of the loop-side landmark."""
        m = self.map
        nbs, _ = m.covisibility(kf, min_shared=15)
        targets = [kf] + [int(k) for k in nbs[:10]]
        window_lms = window_lms[m.lm_valid[window_lms]]
        if window_lms.size == 0:
            return
        for t_kf in targets:
            kp_idx, lm_ids = self._guided_match(
                kf=t_kf, lms=window_lms, R_s=m.kf_R[t_kf], t_s=m.kf_t[t_kf],
                s_s=1.0, th=4.0)
            for kp, lm_new in zip(kp_idx, lm_ids):
                lm_old = int(m.kf_kp_lm[t_kf, kp])
                lm_new = int(lm_new)
                if lm_old == lm_new or not m.lm_valid[lm_new]:
                    continue
                if lm_old == NO_LM:
                    m.kf_kp_lm[t_kf, kp] = lm_new
                    self.stats["n_fused_loop"] += 1
                elif m.lm_valid[lm_old]:
                    # The loop-side landmark replaces the current one
                    # everywhere (MapPoint::Replace).
                    native.replace_landmark(m.kf_kp_lm, lm_old, lm_new)
                    m.lm_valid[lm_old] = False
                    self.stats["n_fused_loop"] += 1
        m.n_lm = int(m.lm_valid.sum())
        m.update_landmark_stats(window_lms)
        m.change_idx += 1

    # ------------------------------------------------------------------
    def _run_gba(self):
        """Global BA refines the pose-graph solution over the whole map
        (RunGlobalBundleAdjustment, LoopClosing.cc:2273).  On an
        IMU-initialised inertial map it is the full inertial BA of 7
        iterations (LoopClosing.cc:2283-2291), except over a mesh of more
        than one shard, which keeps the visual sharded solve."""
        if not self.run_gba:
            return
        from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
        sharded = self.ba_mesh is not None and self.ba_mesh.size > 1
        if (self.inertial and self.map.imu_initialized
                and self.imu is not None and not sharded):
            ok = global_ba.global_inertial_bundle_adjustment(
                self.cfg, self.map, self.imu,
                n_iters=self.gba_inertial_iters, use_lock=True)
        else:
            ok = global_ba.global_bundle_adjustment(
                self.cfg, self.map, n_iters=self.gba_iters,
                mesh=self.ba_mesh, use_lock=True)
        if ok:
            self.stats["n_gba"] += 1
