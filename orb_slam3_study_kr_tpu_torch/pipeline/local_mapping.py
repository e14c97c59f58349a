"""Local mapping: triangulation of new landmarks, duplicate fusion, recent-
landmark culling, windowed bundle adjustment and keyframe culling.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/local_mapping.py``:
``run_once`` drains the keyframe queue — MapPointCulling,
CreateNewMapPoints (all neighbours in one batched call), SearchInNeighbors
fusion (all neighbours in one K2 launch), local BA and KeyFrameCulling —
with the reference's acceptance gates.  It runs in line on the tracker's
thread, or on the background worker (``pipeline/async_mapping.py``).
Numpy snapshots are taken under the map lock; device work runs outside it.
With ``cfg.bf > 0`` local BA carries the keyframes' stereo rows and culls
each observation at its own chi2 gate (7.815 stereo, 5.991 mono).  After an
Atlas merge ``welding_ba`` runs the same local BA over an explicit window
spanning both sides of the seam.  In an inertial session the inertial
local BA (``inertial_ba``) replaces the visual one once the map is
IMU-initialized, and keyframe culling keeps the temporal IMU chain's gaps
bounded.
"""

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch import native
from orb_slam3_study_kr_tpu_torch.ops import track_match, triangulation_match
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers.robust import CHI2_MONO, CHI2_STEREO
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

CULL_FOUND_RATIO = 0.25


# The reference's shape buckets stay: padded to them, the local BA and the
# searches see a few distinct shapes, which bounds what a CUDA-graph capture
# of these stages must record, and they keep the padded solves equal to the
# reference's.
def _bucket(n, step):
    return max(step, -(-n // step) * step)


def _nb_bucket(n, caps):
    """Smallest bucket >= n from `caps`."""
    for c in caps:
        if n <= c:
            return c
    return caps[-1]


def _np(t):
    return t.detach().cpu().numpy()


@dataclass
class LocalMapper:
    cfg: "TrackerConfig"
    map: MapState
    n_neighbors: int = 20
    ba_window: int = 20
    ba_iters: int = 8
    enable_kf_culling: bool = True
    kf_redundancy_th: float = 0.9
    # Inertial sessions: a keyframe is culled only where the temporal gap
    # it leaves between its neighbours stays below 0.5 s until the final
    # inertial refinement (imu_ba2) has run, 3 s after; the IMU intervals
    # are rebuilt from the raw log by timestamp, so an erased keyframe's
    # intervals merge by themselves.
    inertial_mode: bool = False
    inertial_max_gap_s: float = 3.0
    inertial_max_gap_early_s: float = 0.5
    # LocalInertialBA entry point (ImuMixin.local_inertial_ba): with the
    # map IMU-initialized it replaces the visual local BA, which runs
    # instead when it returns False.
    inertial_ba: "callable" = None
    on_kf_culled: "callable" = None
    timers: object = None
    recent: list = field(default_factory=list)
    queue: list = field(default_factory=list)
    stats: dict = field(default_factory=lambda: {"n_created": 0, "n_culled": 0,
                                                 "n_fused": 0, "n_ba": 0,
                                                 "n_kf_culled": 0})

    def __post_init__(self):
        self.device = resolve_device(self.cfg.device, "TrackerConfig.device")

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def note_new_keyframe(self, kf_id: int):
        self.queue.append(kf_id)

    def run_once(self):
        while self.queue:
            self._process(self.queue.pop(0))

    def _process(self, kf: int):
        m = self.map
        if m.n_kf < 2:
            return
        stage = (self.timers.stage if self.timers is not None
                 else (lambda name: contextlib.nullcontext()))
        with stage("mapping/cull_recent"), m.lock:
            self._cull_recent(kf)
        with stage("mapping/triangulate"):
            self._create_new_landmarks(kf)
        with stage("mapping/fuse"):
            self._fuse_neighbors(kf)
        if m.n_kf >= 3:
            ok = False
            if self.inertial_ba is not None and m.imu_initialized:
                with stage("mapping/local_inertial_ba"), m.lock:
                    ok = self.inertial_ba(kf)
            if not ok:
                with stage("mapping/local_ba"):
                    self._local_ba(kf)
        if self.enable_kf_culling and m.n_kf >= 5:
            with stage("mapping/cull_kf"), m.lock:
                self._cull_keyframes(kf)

    # ------------------------------------------------------------------
    def _cull_recent(self, kf: int):
        """MapPointCulling: drop recent landmarks with found/visible < 0.25
        or too few observations a couple of keyframes after creation."""
        m = self.map
        obs = m.landmark_obs_count()
        keep, kill = [], []
        for lm, born in self.recent:
            if not m.lm_valid[lm]:
                continue
            ratio = m.lm_found[lm] / max(m.lm_visible[lm], 1)
            age = kf - born
            if ratio < CULL_FOUND_RATIO:
                kill.append(lm)
            elif age >= 2 and obs[lm] <= 2:
                kill.append(lm)
            elif age >= 3:
                pass
            else:
                keep.append((lm, born))
        self.recent = keep
        if kill:
            m.remove_landmarks(np.array(kill))
            self.stats["n_culled"] += len(kill)

    # ------------------------------------------------------------------
    def _create_new_landmarks(self, kf: int):
        m = self.map
        with m.lock:
            pending = self._triangulation_prepare(kf)
        if pending is None:
            return
        nbs, call_args, sel1p, sel2p = pending
        out = self._triangulation_dispatch(call_args)
        good, idx2, X = _np(out["good"]), _np(out["idx2"]), _np(out["X"])
        with m.lock:
            self._triangulation_apply(kf, nbs, good, idx2, X, sel1p, sel2p)

    def _triangulation_prepare(self, kf: int):
        """Numpy snapshot of all neighbours' free keypoints (compacted and
        bucketed, padded with no-match rows)."""
        m = self.map
        neighbors, _ = m.covisibility(kf, min_shared=10)
        neighbors = neighbors[: self.n_neighbors]
        if neighbors.size == 0 and m.n_kf >= 2:
            neighbors = np.array([kf - 1], np.int32)
        center1 = m.kf_center(kf)
        nbs = []
        for nb in neighbors:
            nb = int(nb)
            baseline = np.linalg.norm(m.kf_center(nb) - center1)
            lms_nb = m.kf_kp_lm[nb]
            lms_nb = lms_nb[lms_nb != NO_LM]
            if lms_nb.size:
                p = m.lm_pos[lms_nb] @ m.kf_R[nb].T + m.kf_t[nb]
                med_depth = np.median(p[:, 2])
                if baseline / max(med_depth, 1e-9) < 0.01:
                    continue
            nbs.append(nb)
        if not nbs:
            return None
        NB = _nb_bucket(len(nbs), (8, self.n_neighbors))
        sl = np.asarray(nbs + [0] * (NB - len(nbs)), np.int32)
        free1 = m.kf_kp_valid[kf] & (m.kf_kp_lm[kf] == NO_LM)
        sel1 = np.nonzero(free1)[0]
        F1 = _nb_bucket(max(sel1.size, 1), (512, m.max_kp))
        sel1p = np.zeros(F1, np.int64)
        sel1p[: sel1.size] = sel1
        mask1 = np.zeros(F1, bool)
        mask1[: sel1.size] = True
        free2s = m.kf_kp_valid[sl] & (m.kf_kp_lm[sl] == NO_LM)
        free2s[len(nbs):] = False
        F2 = _nb_bucket(max(int(free2s.sum(1).max()), 1), (512, m.max_kp))
        sel2p = np.zeros((NB, F2), np.int64)
        mask2 = np.zeros((NB, F2), bool)
        for i in range(NB):
            s = np.nonzero(free2s[i])[0][:F2]
            sel2p[i, : s.size] = s
            mask2[i, : s.size] = True
        call_args = (
            m.kf_R[kf].copy(), m.kf_t[kf].copy(), m.kf_R[sl], m.kf_t[sl],
            m.kf_kp_uv[kf, sel1p], m.kf_kp_uv[sl[:, None], sel2p],
            m.kf_kp_level[kf, sel1p], m.kf_desc[kf, sel1p], mask1,
            m.kf_kp_level[sl[:, None], sel2p], m.kf_desc[sl[:, None], sel2p],
            mask2, m.kf_kp_angle[kf, sel1p], m.kf_kp_angle[sl[:, None], sel2p])
        return nbs, call_args, sel1p, sel2p

    def _triangulation_dispatch(self, call_args):
        cfg = self.cfg
        (R1, t1, R2s, t2s, uv_a, uv2s, lev1, desc1, mask1,
         lev2, desc2, mask2, ang1, ang2) = [self._t(a) for a in call_args]
        return triangulation_match.match_and_triangulate_batch(
            R1, t1, R2s, t2s, cfg.project_fn, cfg.focal,
            uv_a, cfg.unproject_fn(uv_a), lev1, desc1, mask1,
            uv2s, cfg.unproject_fn(uv2s), lev2, desc2, mask2, ang1, ang2)

    def _triangulation_apply(self, kf: int, nbs, good_all, idx2_all, X_all,
                             sel1p, sel2p):
        """Host-side binding; earlier neighbours take precedence on
        contested keypoints of kf."""
        m = self.map
        free1 = m.kf_kp_valid[kf] & (m.kf_kp_lm[kf] == NO_LM)
        created = []
        for i, nb in enumerate(nbs):
            good = good_all[i] & free1[sel1p]
            if not good.any():
                continue
            c1 = np.nonzero(good)[0]
            kp1 = sel1p[c1].astype(np.int32)
            kp2 = sel2p[i][idx2_all[i][c1]].astype(np.int32)
            lm_ids = m.add_landmarks(X_all[i][c1], m.kf_desc[kf, kp1], kf,
                                     patches=m.kf_kp_patch[kf, kp1])
            m.bind(kf, kp1, lm_ids)
            m.bind(nb, kp2, lm_ids)
            created.append(lm_ids)
            self.recent.extend((int(l), kf) for l in lm_ids)
            self.stats["n_created"] += lm_ids.size
            free1 = m.kf_kp_valid[kf] & (m.kf_kp_lm[kf] == NO_LM)
        if created:
            m.update_landmark_stats(np.concatenate(created))

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, kf: int):
        """SearchInNeighbors: project this keyframe's landmarks into its
        covisible neighbours; bind free keypoints and resolve duplicates in
        favour of the landmark with more observations."""
        m = self.map
        with m.lock:
            state = self._fuse_prepare(kf)
        if state is None:
            return
        nbs, cand, call_args, lms_kf, obs = state
        lm_slot, ok = self._fuse_dispatch(call_args)
        with m.lock:
            self._fuse_apply(nbs, cand, _np(lm_slot), _np(ok), lms_kf, obs)

    def _fuse_prepare(self, kf: int):
        m = self.map
        neighbors, _ = m.covisibility(kf, min_shared=10)
        neighbors = neighbors[:10]
        lms_kf = m.kf_kp_lm[kf]
        lms_kf = np.unique(lms_kf[lms_kf != NO_LM])
        if lms_kf.size == 0 or neighbors.size == 0:
            return None
        obs = m.landmark_obs_count()
        L = 1024
        if lms_kf.size > L:
            nb_arr = np.asarray([int(nb) for nb in neighbors])
            unbound = ~np.isin(lms_kf, m.kf_kp_lm[nb_arr])
            cand = np.concatenate([lms_kf[unbound], lms_kf[~unbound]])[:L]
        else:
            cand = lms_kf

        def pad(a, fill=0):
            if a.shape[0] >= L:
                return a[:L]
            return np.concatenate(
                [a, np.full((L - a.shape[0], *a.shape[1:]), fill, a.dtype)])

        nbs = [int(nb) for nb in neighbors]
        NB = _nb_bucket(len(nbs), (10,))
        sl = np.asarray(nbs + [0] * (NB - len(nbs)), np.int32)
        base = pad(np.ones(cand.size, np.float32))
        masks = np.zeros((NB, L), np.float32)
        for i, nb in enumerate(nbs):
            masks[i] = base * ~np.isin(np.pad(cand, (0, L - cand.size)),
                                       m.kf_kp_lm[nb])
        valids = m.kf_kp_valid[sl].copy()
        valids[len(nbs):] = False
        call_args = (
            m.kf_R[sl], m.kf_t[sl],
            pad(m.lm_pos[cand]), pad(m.lm_normal[cand]),
            pad(m.lm_min_dist[cand]), pad(m.lm_max_dist[cand]),
            pad(m.lm_desc[cand]), masks,
            m.kf_kp_uv[sl], m.kf_kp_level[sl], m.kf_desc[sl], valids)
        return nbs, cand, call_args, lms_kf, obs

    def _fuse_dispatch(self, call_args):
        """One batched K2 launch over every neighbour."""
        cfg = self.cfg
        args = [self._t(a) for a in call_args]
        lm_slot, ok, _ = track_match.match_local_map_batch(
            cfg.project_fn, *args, cfg.width, cfg.height, th=3.0, max_dist=50.0,
            max_theta_deg=cfg.max_theta_deg)
        return lm_slot, ok

    def _fuse_apply(self, nbs, cand, lm_slot_all, ok_all, lms_kf, obs):
        """Host-side binding / duplicate resolution (MapPoint::Replace)."""
        m = self.map
        for i, nb in enumerate(nbs):
            lm_slot, ok = lm_slot_all[i], ok_all[i]
            kps = np.nonzero(ok)[0]
            if kps.size == 0:
                continue
            lm_new = cand[np.minimum(lm_slot[kps], cand.size - 1)]
            live = m.lm_valid[lm_new]
            kps, lm_new = kps[live], lm_new[live]
            lm_old = m.kf_kp_lm[nb, kps]
            free = lm_old == NO_LM
            m.kf_kp_lm[nb, kps[free]] = lm_new[free]
            self.stats["n_fused"] += int(free.sum())
            for kp, ln, lo in zip(kps[~free], lm_new[~free], lm_old[~free]):
                ln, lo = int(ln), int(lo)
                if ln == lo or not m.lm_valid[ln] or not m.lm_valid[lo]:
                    continue
                a, b = (ln, lo) if obs[ln] >= obs[lo] else (lo, ln)
                native.replace_landmark(m.kf_kp_lm, b, a)
                m.lm_valid[b] = False
                self.stats["n_fused"] += 1
        m.n_lm = int(m.lm_valid.sum())
        m.update_landmark_stats(lms_kf)
        m.change_idx += 1

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling: erase covisible keyframes whose landmarks (with
        > 3 observations) are >= kf_redundancy_th observed by >= 3 other
        keyframes at the same-or-finer scale; culled frames redirect to
        their best covisible neighbour."""
        m = self.map
        neighbors, _ = m.covisibility(kf, min_shared=15)
        if neighbors.size == 0:
            return
        obs = m.landmark_obs_count()
        okf_all, okp_all, olm_all = m.observations()
        for c in neighbors:
            c = int(c)
            if c <= 1 or c == kf or not m.kf_valid[c]:
                continue
            if self.inertial_mode and not self._inertial_cullable(c):
                continue
            kp = np.nonzero(m.kf_kp_valid[c] & (m.kf_kp_lm[c] != NO_LM))[0]
            lms = m.kf_kp_lm[c, kp]
            live = m.lm_valid[lms]
            kp, lms = kp[live], lms[live]
            if lms.size == 0:
                continue
            lvl = m.kf_kp_level[c, kp]
            lm_index = np.full(m.max_lm, -1, np.int64)
            lm_index[lms] = np.arange(lms.size)
            sel = (okf_all != c) & (lm_index[olm_all] >= 0)
            oi = lm_index[olm_all[sel]]
            finer = m.kf_kp_level[okf_all[sel], okp_all[sel]] <= lvl[oi] + 1
            cnt = np.bincount(oi[finer], minlength=lms.size)
            redundant = (obs[lms] > 3) & (cnt >= 3)
            if redundant.sum() <= self.kf_redundancy_th * lms.size:
                continue
            parents, _ = m.covisibility(c, min_shared=1)
            parents = parents[parents != c]
            if parents.size == 0:
                continue
            m.cull_keyframe(c, int(parents[0]))
            dead = okf_all == c
            okf_all, okp_all, olm_all = (okf_all[~dead], okp_all[~dead],
                                         olm_all[~dead])
            obs = m.landmark_obs_count()
            self.stats["n_kf_culled"] += 1
            if self.on_kf_culled is not None:
                self.on_kf_culled(c)

    def _inertial_cullable(self, c: int) -> bool:
        """Erasing c must not stretch the temporal IMU chain beyond the gap
        bound (its previous and next keyframes by timestamp are welded);
        the chain's endpoints are never culled."""
        m = self.map
        kfs = np.nonzero(m.kf_valid)[0]
        ts = m.kf_timestamp[kfs]
        order = np.argsort(ts, kind="stable")
        kfs, ts = kfs[order], ts[order]
        i = int(np.nonzero(kfs == c)[0][0])
        if i == 0 or i == kfs.size - 1:
            return False
        bound = (self.inertial_max_gap_s if m.imu_ba2
                 else self.inertial_max_gap_early_s)
        return (ts[i + 1] - ts[i - 1]) < bound

    # ------------------------------------------------------------------
    def _local_ba(self, kf: int, window=None):
        m = self.map
        with m.lock:
            prob = self._local_ba_assemble(kf, window=window)
        if prob is None:
            return
        R, t, X_new, chi2, _ = bundle_adjust(*prob["args"],
                                             n_iters=self.ba_iters,
                                             wide_fov=self.cfg.is_kb8,
                                             **prob["stereo_kw"])
        with m.lock:
            self._local_ba_apply(prob, _np(R), _np(t), _np(X_new), _np(chi2))

    def welding_ba(self, window_a, window_b, fix_b: bool = False):
        """Two-map welding BA (MergeLocal's welding problem): the current
        keyframe's neighbourhood (window_a, from the absorbed map) and the
        target map's neighbourhood around the matched keyframe (window_b)
        form one local BA; every other observer of their landmarks, the far
        sides of both maps, enters as a fixed pose.  With fix_b the target
        window is held fixed too (the inertial weld keeps the target's
        gravity-consistent structure rigid)."""
        window_a = np.asarray(window_a, np.int32)
        window_b = np.asarray(window_b, np.int32)
        window_b = window_b[~np.isin(window_b, window_a)]
        # An observer outside the optimised window enters as a fixed pose,
        # so holding the target side rigid is leaving it out of the window.
        window = window_a if fix_b else np.concatenate([window_a, window_b])
        self._local_ba(int(window_a[0]), window=window)
        self.stats["n_welding_ba"] = self.stats.get("n_welding_ba", 0) + 1

    def _local_ba_assemble(self, kf: int, window=None):
        cfg, m = self.cfg, self.map
        if window is None:
            neighbors, _ = m.covisibility(kf, min_shared=1)
            window = np.concatenate(
                [[kf], neighbors[: self.ba_window - 1]]).astype(np.int32)
        else:
            window = np.asarray(window, np.int32)
            window = window[m.kf_valid[window]]
            if window.size == 0:
                return None
        lms = np.unique(m.kf_kp_lm[window])
        lms = lms[(lms != NO_LM) & m.lm_valid[np.maximum(lms, 0)]]
        if lms.size < 20:
            return None
        seen = np.zeros(m.max_lm, bool)
        seen[lms] = True
        observing = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).any(axis=1)
        observing &= m.kf_valid
        fixed_ids = np.nonzero(observing)[0]
        fixed_ids = fixed_ids[~np.isin(fixed_ids, window)]
        all_kf = np.concatenate([window, fixed_ids]).astype(np.int32)
        fixed = np.concatenate([np.zeros(window.size),
                                np.ones(fixed_ids.size)]).astype(np.float32)
        # The oldest two keyframes anchor the gauge.
        fixed[np.nonzero(np.isin(window, [0, 1]))[0]] = 1.0
        if fixed.sum() < 2:
            need = 2 - int(fixed.sum())
            for o in np.argsort(window):
                if fixed[o] == 0 and need > 0:
                    fixed[o] = 1.0
                    need -= 1

        okf, okp, olm = m.observations(all_kf)
        keep = seen[olm]
        okf, okp, olm = okf[keep], okp[keep], olm[keep]
        kf_index = np.full(m.max_kf, -1, np.int64)
        kf_index[all_kf] = np.arange(all_kf.size)
        lm_index = np.full(m.max_lm, -1, np.int64)
        lm_index[lms] = np.arange(lms.size)

        K = _bucket(all_kf.size, 16)
        M = _bucket(lms.size, 2048)
        O = _bucket(okf.size, 8192)

        def padr(a, n, fill=0):
            return np.concatenate(
                [a, np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)]
            ) if a.shape[0] < n else a[:n]

        R_all = padr(m.kf_R[all_kf], K, 0)
        R_all[all_kf.size:] = np.eye(3)
        t = self._t
        stereo_kw = {}
        if cfg.bf > 0:
            # Stereo observations add the third residual row.
            stereo_kw = dict(obs_ur=t(padr(m.kf_kp_ur[okf, okp], O, -1.0)),
                             bf=cfg.bf)
        return dict(
            args=(cfg.project_fn, cfg.project_jac_fn,
                  t(R_all), t(padr(m.kf_t[all_kf], K)), t(padr(fixed, K, 1.0)),
                  t(padr(m.lm_pos[lms], M)),
                  t(padr(np.ones(lms.size, np.float32), M)),
                  t(padr(kf_index[okf], O)), t(padr(lm_index[olm], O)),
                  t(padr(m.kf_kp_uv[okf, okp], O)),
                  t(padr(m.kf_kp_level[okf, okp], O)),
                  t(padr(np.ones(okf.size, np.float32), O))),
            stereo_kw=stereo_kw, window=window, fixed=fixed, lms=lms,
            kf_index=kf_index, okf=okf, okp=okp)

    def _local_ba_apply(self, prob, R, t, X_new, chi2):
        m = self.map
        window, fixed, lms = prob["window"], prob["fixed"], prob["lms"]
        kf_index, okf, okp = prob["kf_index"], prob["okf"], prob["okp"]
        upd = window[fixed[: window.size] == 0]
        sel = kf_index[upd].astype(np.int64)
        m.kf_R[upd] = R[sel]
        m.kf_t[upd] = t[sel]
        m.lm_pos[lms] = X_new[: lms.size]
        gate = CHI2_MONO
        if self.cfg.bf > 0:
            gate = np.where(m.kf_kp_ur[okf, okp] >= 0, CHI2_STEREO, CHI2_MONO)
        bad = chi2[: okf.size] > gate
        m.kf_kp_lm[okf[bad], okp[bad]] = NO_LM
        # Landmarks left with < 2 observations, and landmarks launched to
        # absurd range, are dead.
        obs_after = m.landmark_obs_count()
        centers = -np.einsum("kij,kj->ki", m.kf_R[window].transpose(0, 2, 1),
                             m.kf_t[window])
        scene_scale = max(float(np.linalg.norm(
            m.lm_pos[lms] - centers.mean(0), axis=1).mean()), 1e-6)
        dist = np.linalg.norm(m.lm_pos - centers.mean(0), axis=1)
        insane = m.lm_valid & ((dist > 50.0 * scene_scale)
                               | ~np.isfinite(m.lm_pos).all(axis=1))
        orphan = m.lm_valid & (obs_after < 2)
        kill = np.nonzero(orphan | insane)[0]
        if kill.size:
            m.remove_landmarks(kill)
            self.stats["n_culled"] += int(kill.size)
        m.change_idx += 1
        self.stats["n_ba"] += 1
        self.stats["n_obs_culled"] = self.stats.get("n_obs_culled", 0) + int(bad.sum())
        self.stats["n_obs_kept"] = self.stats.get("n_obs_kept", 0) + int((~bad).sum())
