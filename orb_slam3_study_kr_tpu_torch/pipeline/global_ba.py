"""Global bundle adjustment over a whole map.

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/global_ba.py``
(Optimizer::GlobalBundleAdjustemnt + LoopClosing::RunGlobalBundleAdjustment):
after a loop correction every keyframe and landmark is refined with a
bounded-iteration LM solve.  Large maps switch from the dense-Schur
assembly to the matrix-free PCG reduced-camera solve, so GBA is never
skipped for memory.  With a mesh of more than one shard
(``parallel/dist_ba.py``, ``SystemConfig.ba_devices``) the solve is
sharded by landmark and the shards' reduced camera systems are summed.

The map is snapshotted (``_assemble_gba``), solved (``_solve_gba``) and
written back (``_apply_gba``); rows created between snapshot and write-back
are corrected through the newest snapshot keyframe.  With ``cfg.bf > 0``
the keyframes' stereo rows join the solve and each observation is culled
at its own chi2 gate.

Each call is a request of ``utils.profiling.DEFAULT_TIMERS``: the span
``gba/call`` with children ``gba/assemble``, ``gba/upload``, ``ba/solve``
(``solvers/local_ba.py``), ``gba/download`` and ``gba/apply`` (with
``gba/cull``).
"""

import contextlib

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers.robust import CHI2_MONO, CHI2_STEREO
from orb_slam3_study_kr_tpu_torch.utils import resolve_device
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS as TIMERS

# Above this dense cross-block size (K * M * 18 floats) the solve switches
# to the matrix-free PCG assembly.
DENSE_CROSS_BLOCK_FLOATS = 1 << 27


def _bucket(n, step):
    return max(step, -(-n // step) * step)


def _padr(a, n, fill=0):
    if a.shape[0] >= n:
        return a[:n]
    return np.concatenate(
        [a, np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)])


def global_bundle_adjustment(cfg, m: MapState, n_iters: int = 10,
                             cull_outliers: bool = True, mesh=None,
                             use_lock: bool = False) -> bool:
    """Full-map BA on ``cfg.device``, or over ``mesh`` (a
    ``parallel.dist_ba.BaMesh``) when it has more than one shard.  Returns
    False only for degenerate maps.  Gauge: the two oldest keyframes are
    frozen."""
    dev = resolve_device(cfg.device, "TrackerConfig.device")
    lock = m.lock if use_lock else contextlib.nullcontext()
    with TIMERS.stage("gba/call", request=True):
        with lock, TIMERS.stage("gba/assemble"):
            snap = _assemble_gba(cfg, m)
        if snap is None:
            return False
        if mesh is not None and mesh.size > 1:
            out = _distributed_gba(cfg, mesh, snap, n_iters)
        else:
            out = _solve_gba(cfg, snap, n_iters, dev)
        with lock, TIMERS.stage("gba/apply"):
            _apply_gba(cfg, m, snap, out, cull_outliers)
    return True


def _assemble_gba(cfg, m: MapState):
    kfs = np.nonzero(m.kf_valid)[0].astype(np.int32)
    if kfs.size < 3:
        return None
    obs_cnt = m.landmark_obs_count()
    lms = np.nonzero(m.lm_valid & (obs_cnt >= 2))[0].astype(np.int32)
    if lms.size < 20:
        return None

    okf, okp, olm = m.observations(kfs)
    sel = np.zeros(m.max_lm, bool)
    sel[lms] = True
    keep = sel[olm]
    okf, okp, olm = okf[keep], okp[keep], olm[keep]

    K = _bucket(kfs.size, 8)
    M = _bucket(lms.size, 2048)
    O = _bucket(okf.size, 8192)

    kf_index = np.full(m.max_kf, -1, np.int64)
    kf_index[kfs] = np.arange(kfs.size)
    lm_index = np.full(m.max_lm, -1, np.int64)
    lm_index[lms] = np.arange(lms.size)

    order = np.argsort(m.kf_timestamp[kfs], kind="stable")
    fixed = np.zeros(kfs.size, np.float32)
    fixed[order[:2]] = 1.0

    R_all = _padr(m.kf_R[kfs], K)
    R_all[kfs.size:] = np.eye(3)
    return dict(kfs=kfs, lms=lms, okf=okf, okp=okp, fixed=fixed,
                kf_index=kf_index, K=K, M=M,
                R_all=R_all, t_all=_padr(m.kf_t[kfs], K),
                fixed_p=_padr(fixed, K, 1.0), X=_padr(m.lm_pos[lms], M),
                lm_mask=_padr(np.ones(lms.size, np.float32), M),
                op=_padr(kf_index[okf].astype(np.int32), O),
                ol=_padr(lm_index[olm].astype(np.int32), O),
                ouv=_padr(m.kf_kp_uv[okf, okp], O),
                olev=_padr(m.kf_kp_level[okf, okp], O),
                omask=_padr(np.ones(okf.size, np.float32), O),
                our=(_padr(m.kf_kp_ur[okf, okp], O, -1.0) if cfg.bf > 0
                     else None),
                # pre-solve poses, for rows created before the write-back
                R_old=m.kf_R[kfs].copy(), t_old=m.kf_t[kfs].copy(),
                snap_next_kf=m.next_kf, snap_next_lm=m.next_lm)


def _solve_gba(cfg, s, n_iters, dev):
    assembly = ("dense" if s["K"] * s["M"] * 18 <= DENSE_CROSS_BLOCK_FLOATS
                else "pcg")

    names = ("R_all", "t_all", "fixed_p", "X", "lm_mask", "op", "ol", "ouv",
             "olev", "omask")
    with TIMERS.stage("gba/upload"):
        args = [torch.as_tensor(s[k], device=dev) for k in names]
        stereo_kw = {}
        if s["our"] is not None:
            stereo_kw = dict(obs_ur=torch.as_tensor(s["our"], device=dev),
                             bf=cfg.bf)
    R, tr, X_new, chi2, _ = bundle_adjust(
        cfg.project_fn, cfg.project_jac_fn, *args, n_iters=n_iters,
        assembly=assembly, wide_fov=cfg.is_kb8, **stereo_kw)
    with TIMERS.stage("gba/download"):
        return {k: v.cpu().numpy() for k, v in
                dict(R=R, t=tr, X_new=X_new, chi2=chi2).items()}


def _apply_gba(cfg, m, s, out, cull_outliers):
    kfs, lms, okf, okp = s["kfs"], s["lms"], s["okf"], s["okp"]
    fixed, kf_index = s["fixed"], s["kf_index"]
    upd = kfs[fixed == 0]
    upd = upd[m.kf_valid[upd]]           # culled since the snapshot
    m.kf_R[upd] = out["R"][kf_index[upd]]
    m.kf_t[upd] = out["t"][kf_index[upd]]
    live = lms[m.lm_valid[lms]]
    lm_index = np.full(m.max_lm, -1, np.int64)
    lm_index[lms] = np.arange(lms.size)
    m.lm_pos[live] = out["X_new"][lm_index[live]]

    # Rows created since the snapshot: correct through the newest snapshot
    # keyframe, T_child_new = T_child_old . T_ref_old^-1 . T_ref_new
    # (the reference's spanning-tree mTcwGBA propagation).
    if m.next_kf > s["snap_next_kf"] or m.next_lm > s["snap_next_lm"]:
        i = {int(k): j for j, k in enumerate(kfs)}[int(kfs[-1])]
        R_d = s["R_old"][i].T @ out["R"][i]
        t_d = s["R_old"][i].T @ (out["t"][i] - s["t_old"][i])
        new_kfs = np.arange(s["snap_next_kf"], m.next_kf)
        new_kfs = new_kfs[m.kf_valid[new_kfs]]
        for c in new_kfs:
            m.kf_R[c] = (m.kf_R[c] @ R_d).astype(np.float32)
            m.kf_t[c] = (m.kf_t[c] + m.kf_R[c] @ (R_d.T @ t_d)).astype(
                np.float32)
        new_lms = np.arange(s["snap_next_lm"], m.next_lm)
        new_lms = new_lms[m.lm_valid[new_lms]]
        if new_lms.size:
            Ro, to = s["R_old"][i], s["t_old"][i]
            Rn, tn = out["R"][i], out["t"][i]
            pc = m.lm_pos[new_lms] @ Ro.T + to
            m.lm_pos[new_lms] = (pc - tn) @ Rn

    if cull_outliers:
        with TIMERS.stage("gba/cull"):
            gate = CHI2_MONO
            if cfg.bf > 0:
                gate = np.where(m.kf_kp_ur[okf, okp] >= 0, CHI2_STEREO,
                                CHI2_MONO)
            bad = out["chi2"][: okf.size] > gate
            m.kf_kp_lm[okf[bad], okp[bad]] = NO_LM
            orphan = np.nonzero(m.lm_valid & (m.landmark_obs_count() < 2))[0]
            if orphan.size:
                m.remove_landmarks(orphan)
    m.change_idx += 1


def _distributed_gba(cfg, mesh, s, n_iters):
    """Landmark-sharded GBA over the mesh: the dense-chunked assembly while
    the keyframes number 512 or fewer (its replicated (6K, 6K) solve stays
    cheap), PCG beyond.  Returns the solve in the snapshot's order: X in
    the snapshot's landmark order, chi2 in its observation order."""
    from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjust, shard_ba_problem)
    parts = shard_ba_problem(mesh.size, s["X"], s["lm_mask"], s["op"], s["ol"],
                             s["ouv"], s["olev"], s["omask"], obs_ur=s["our"])
    dev_of_lm, local_of_lm, Mb, obs_slot = parts[-4:]
    sharded = [torch.as_tensor(mesh.local_rows(a)) for a in parts[:-4]]
    stereo_kw = {}
    if s["our"] is not None:
        stereo_kw = dict(obs_ur=sharded.pop(), bf=cfg.bf)
    R, t, X_sh, chi2_sh = distributed_bundle_adjust(
        mesh, cfg.project_fn, cfg.project_jac_fn,
        torch.as_tensor(s["R_all"]), torch.as_tensor(s["t_all"]),
        torch.as_tensor(s["fixed_p"]), *sharded, n_iters=n_iters,
        assembly="dense_chunked" if s["kfs"].size <= 512 else "pcg",
        wide_fov=cfg.is_kb8, **stereo_kw)
    n_lms = s["lms"].size
    X = mesh.gather(X_sh)
    chi2 = np.zeros(s["op"].shape[0], np.float32)
    live = obs_slot >= 0
    chi2[obs_slot[live]] = mesh.gather(chi2_sh)[live]
    return dict(R=R.cpu().numpy(), t=t.cpu().numpy(),
                X_new=X[dev_of_lm[:n_lms] * Mb + local_of_lm[:n_lms]],
                chi2=chi2)
