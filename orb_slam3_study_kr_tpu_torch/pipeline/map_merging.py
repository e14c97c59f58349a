"""Atlas map merging (reference src/LoopClosing.cc MergeLocal / MergeLocal2).

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/map_merging.py``.  When
place recognition matches the current keyframe of the active map A against
a keyframe of a stored map B, map A is welded into map B:

1. Sim3 verification between the two keyframes (loop closing's gates):
   descriptor matching of their landmark-bound keypoints, one K3 launch
   (``ops/track_match.match_by_descriptor``), then a Sim3 RANSAC over the
   matches padded to 256 pairs, giving S12 with q_kf = s12 R12 q_cand + t12.
2. The world transform X_B = sigma R_BA X_A + t_BA (sigma = 1 / s12) is
   composed from S12 and the two keyframe poses and applied to all of map
   A (keyframes, landmarks, normals, scale bands, velocities).  Two
   IMU-initialized maps (gravity-aligned and metric) weld by a yaw-only
   rotation at unit scale instead.
3. Map A's rows are appended to map B's tables with keyframe and landmark
   ids remapped (map B's tables grow on demand), and the verified pairs are
   fused: each A landmark is replaced by its B counterpart.

The caller (``SlamSystem._apply_merge``) then rebinds the session to map B
and runs the welding BA.  Everything after the matching and the RANSAC is
host numpy on ``MapState``, as in the reference.  The RANSAC draws come
from ``uniforms_fn(iters, n)`` when given (tests inject the reference's
jax.random stream), else from a torch.Generator seeded 23, the reference's
PRNGKey, drawn once per verification that reaches the RANSAC.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.ops.track_match import match_by_descriptor
from orb_slam3_study_kr_tpu_torch.pipeline.loop_closing import (SIM3_PAD,
                                                                SIM3_RANSAC_ITERS,
                                                                _pad)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers.sim3_solver import ransac_sim3
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

MIN_BOW_MATCHES = 20
MIN_SIM3_INLIERS = 20


def _np(t):
    return t.detach().cpu().numpy()


@dataclass
class MergeResult:
    target_map: MapState
    kf_map: dict        # old A kf id -> new B kf id
    lm_map: np.ndarray  # (A.max_lm,) old lm id -> new B lm id (or NO_LM)
    sigma: float
    R_BA: np.ndarray
    t_BA: np.ndarray
    target_kf: int = -1   # matched keyframe on the target-map side


@dataclass
class MapMerger:
    cfg: "TrackerConfig"
    stats: dict = field(default_factory=lambda: {
        "n_attempts": 0, "n_verified": 0, "n_merged": 0})
    uniforms_fn: object = None   # (iters, n) -> uniforms of one Sim3 RANSAC
    _gen: object = None

    def __post_init__(self):
        self.device = resolve_device(self.cfg.device, "TrackerConfig.device")
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(23)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _uniforms(self, iters, n):
        if self.uniforms_fn is not None:
            return self._t(self.uniforms_fn(iters, n), torch.float32)
        return torch.rand((iters, n), generator=self._gen).to(self.device)

    # ------------------------------------------------------------------
    def verify(self, mA: MapState, kf: int, mB: MapState, cand: int,
               fix_scale=False):
        """Cross-map Sim3 verification (DetectCommonRegionsFromBoW gates).
        Returns dict(R12, t12, s12, pairs=(A landmarks, B landmarks)) or
        None."""
        self.stats["n_attempts"] += 1
        t = self._t
        b1 = mA.kf_kp_lm[kf] != NO_LM
        b2 = mB.kf_kp_lm[cand] != NO_LM
        idx, ok, _ = match_by_descriptor(
            t(mA.kf_desc[kf]), t(mA.kf_kp_valid[kf] & b1),
            t(mB.kf_desc[cand]), t(mB.kf_kp_valid[cand] & b2))
        idx, ok = _np(idx), _np(ok)
        if ok.sum() < MIN_BOW_MATCHES:
            return None
        N = SIM3_PAD
        kp1 = np.nonzero(ok)[0][:N]
        kp2 = idx[kp1]
        lm1 = mA.kf_kp_lm[kf, kp1]
        lm2 = mB.kf_kp_lm[cand, kp2]
        P1 = mA.lm_pos[lm1] @ mA.kf_R[kf].T + mA.kf_t[kf]
        P2 = mB.lm_pos[lm2] @ mB.kf_R[cand].T + mB.kf_t[cand]
        uniforms = self._uniforms(SIM3_RANSAC_ITERS, N)
        out = ransac_sim3(
            t(_pad(P1, N)), t(_pad(P2, N)),
            t(_pad(np.ones(len(kp1), np.float32), N)),
            t(_pad(mA.kf_kp_uv[kf, kp1], N)), t(_pad(mB.kf_kp_uv[cand, kp2], N)),
            self.cfg.K, uniforms, fix_scale=fix_scale,
            project_fn=self.cfg.project_fn)
        if int(out["n_inliers"].cpu()) < MIN_SIM3_INLIERS:
            return None
        self.stats["n_verified"] += 1
        inl = _np(out["inliers"])[: len(kp1)].astype(bool)
        return dict(R12=_np(out["R12"]), t12=_np(out["t12"]),
                    s12=float(out["s12"].cpu()), pairs=(lm1[inl], lm2[inl]))

    # ------------------------------------------------------------------
    def merge(self, mA: MapState, kf: int, mB: MapState, cand: int,
              sim3) -> MergeResult:
        """Weld active map A into stored map B.  Map B's tables grow on
        demand (MapState._ensure_*_capacity), so a merge is never refused
        for capacity."""
        kfsA = np.nonzero(mA.kf_valid)[0]
        lmsA = np.nonzero(mA.lm_valid)[0]

        # X_B = sigma R_BA X_A + t_BA from T_candB^-1 . S12^-1 . T_kfA
        # (q_kf = S12(q_cand)).
        R12, t12, s12 = sim3["R12"], sim3["t12"], sim3["s12"]
        sigma = 1.0 / s12
        Rk, tk = mA.kf_R[kf], mA.kf_t[kf]
        Rc, tc = mB.kf_R[cand], mB.kf_t[cand]
        R_BA = (Rc.T @ R12.T @ Rk).astype(np.float32)
        t_BA = (sigma * Rc.T @ R12.T @ (tk - t12) - Rc.T @ tc).astype(np.float32)

        # Inertial weld (MergeLocal2): both worlds are gravity-aligned (-z)
        # and metric, so the true relative transform is a rotation about z
        # at unit scale.  Keep the current keyframe's camera centre on its
        # Sim3-verified target so the weld point does not move.
        if mA.imu_initialized and mB.imu_initialized:
            cA = (-Rk.T @ tk).astype(np.float32)
            target = sigma * R_BA @ cA + t_BA
            yaw = np.arctan2(R_BA[1, 0] - R_BA[0, 1], R_BA[0, 0] + R_BA[1, 1])
            cy, sy = np.cos(yaw), np.sin(yaw)
            R_BA = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                            np.float32)
            sigma = 1.0
            t_BA = (target - sigma * R_BA @ cA).astype(np.float32)

        # Transform map A in place (its frozen rows stay consistent with the
        # merged world for trajectory replay).
        k = mA.kf_valid
        mA.kf_R[k] = mA.kf_R[k] @ R_BA.T
        mA.kf_t[k] = sigma * mA.kf_t[k] - np.einsum("nij,j->ni", mA.kf_R[k], t_BA)
        mA.kf_v[k] = sigma * mA.kf_v[k] @ R_BA.T
        lv = mA.lm_valid
        mA.lm_pos[lv] = sigma * mA.lm_pos[lv] @ R_BA.T + t_BA
        mA.lm_normal[lv] = mA.lm_normal[lv] @ R_BA.T
        mA.lm_min_dist[lv] *= sigma
        mA.lm_max_dist[lv] *= sigma
        mA.change_idx += 1

        # Landmarks, with the id remap (add_landmarks bumps B's member_idx,
        # so any cached candidate block of B is rebuilt).
        lm_map = np.full(mA.max_lm, NO_LM, np.int32)
        new_ids = mB.add_landmarks(mA.lm_pos[lmsA], mA.lm_desc[lmsA], first_kf=0,
                                   patches=mA.lm_patch[lmsA])
        lm_map[lmsA] = new_ids
        mB.lm_normal[new_ids] = mA.lm_normal[lmsA]
        mB.lm_min_dist[new_ids] = mA.lm_min_dist[lmsA]
        mB.lm_max_dist[new_ids] = mA.lm_max_dist[lmsA]
        mB.lm_visible[new_ids] = mA.lm_visible[lmsA]
        mB.lm_found[new_ids] = mA.lm_found[lmsA]

        # Keyframes, in timestamp order.
        kf_map = {}
        order = kfsA[np.argsort(mA.kf_timestamp[kfsA])]
        for a in order:
            old = mA.kf_kp_lm[a]
            remapped = np.where(old != NO_LM,
                                lm_map[np.clip(old, 0, mA.max_lm - 1)], NO_LM)
            j = mB.add_keyframe(
                mA.kf_R[a], mA.kf_t[a], mA.kf_kp_uv[a], mA.kf_kp_level[a],
                mA.kf_kp_angle[a], mA.kf_kp_valid[a], mA.kf_desc[a],
                mA.kf_frame_id[a], mA.kf_timestamp[a],
                kp_lm=remapped.astype(np.int32), patch=mA.kf_kp_patch[a],
                ur=mA.kf_kp_ur[a])
            mB.kf_v[j] = mA.kf_v[a]
            mB.kf_bias[j] = mA.kf_bias[a]
            kf_map[int(a)] = j
        mB.lm_first_kf[new_ids] = np.array(
            [kf_map.get(int(f), kf_map[int(order[0])])
             for f in mA.lm_first_kf[lmsA]], np.int32)

        # Fuse the Sim3-verified duplicates (SearchAndFuse's role).
        lm1, lm2 = sim3["pairs"]
        dup_new = lm_map[lm1]            # A landmarks, as B ids
        keep = lm2                       # their verified B counterparts
        sel = (dup_new != NO_LM) & mB.lm_valid[np.clip(keep, 0, mB.max_lm - 1)]
        if sel.any():
            repl = np.full(mB.max_lm, -1, np.int64)
            repl[dup_new[sel]] = keep[sel]
            bound = mB.kf_kp_lm[mB.kf_valid]
            safe = np.clip(bound, 0, mB.max_lm - 1)
            hit = (bound != NO_LM) & (repl[safe] >= 0)
            bound[hit] = repl[safe][hit]
            mB.kf_kp_lm[mB.kf_valid] = bound
            mB.lm_valid[dup_new[sel]] = False
            mB.n_lm = int(mB.lm_valid.sum())
            # The remap points at the kept duplicate, so frame bindings
            # translated through it land on live landmarks.
            lm_map[lm1[sel]] = keep[sel]
        mB.change_idx += 1
        self.stats["n_merged"] += 1
        return MergeResult(target_map=mB, kf_map=kf_map, lm_map=lm_map,
                           sigma=sigma, R_BA=R_BA, t_BA=t_BA, target_kf=int(cand))
