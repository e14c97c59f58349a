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

``global_inertial_bundle_adjustment`` is the full inertial BA that the
loop closer runs on an IMU-initialised inertial map
(Optimizer::FullInertialBA(pMap, 7, false, ...), LoopClosing.cc:2289-2291):
the same snapshot plus the temporal chain of keyframes, their body
states, velocities and biases and the chain's IMU intervals,
preintegrated in one batched call (``imu.preintegration.
preintegrate_batch_scan``); the solve is
``solvers/inertial_ba.inertial_bundle_adjust`` (its PCG assembly on a
large map); the write-back adds velocities and biases.  Gauge: the oldest
keyframe's pose is frozen, its velocity and biases are free.

Each call is a request of ``utils.profiling.DEFAULT_TIMERS``: the span
``gba/call`` with children ``gba/assemble`` (with ``gba/preintegrate`` in
the inertial BA), ``gba/upload``, ``ba/solve`` (``solvers/local_ba.py``)
or ``viba/solve`` (``solvers/inertial_ba.py``), ``gba/download`` and
``gba/apply`` (with ``gba/cull``).
"""

import contextlib
from collections import namedtuple

import numpy as np
import torch

from orb_slam3_study_kr_tpu_torch import native
from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    preintegrate_batch_scan)
from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust
from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
    inertial_bundle_adjust)
from orb_slam3_study_kr_tpu_torch.solvers.robust import CHI2_MONO, CHI2_STEREO
from orb_slam3_study_kr_tpu_torch.utils import resolve_device
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS as TIMERS

ImuIntervals = namedtuple("ImuIntervals", "calib rows_between")
ImuIntervals.__doc__ = """The IMU log as the inertial BA reads it: ``calib``
an ``imu.ImuCalib``, ``rows_between(t0, t1)`` the (n, 7) rows [dt, acc,
gyro] logged in (t0, t1] (the inertial tracker's ``_rows_between``)."""

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


def global_inertial_bundle_adjustment(cfg, m: MapState, imu: ImuIntervals,
                                      n_iters: int = 7,
                                      cull_outliers: bool = True,
                                      use_lock: bool = False) -> bool:
    """Full inertial BA of the whole map on ``cfg.device``: every
    keyframe's pose, velocity and biases and every landmark, the chain's
    IMU intervals from ``imu``.  An interval without IMU rows leaves its
    edge out.  Returns False for degenerate maps and non-finite solves
    (the map is then left as it was)."""
    dev = resolve_device(cfg.device, "TrackerConfig.device")
    lock = m.lock if use_lock else contextlib.nullcontext()
    with TIMERS.stage("gba/call", request=True):
        with lock, TIMERS.stage("gba/assemble"):
            snap = _assemble_gba(cfg, m)
            if snap is not None:
                snap = _assemble_inertial(m, imu, snap)
        if snap is None:
            return False
        out = _solve_vigba(cfg, imu, snap, n_iters, dev)
        if out is None:
            return False
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

    # Every observation of a kept landmark: obs_cnt counts them in the
    # valid keyframes, which are kfs.
    n_obs = int(obs_cnt[lms].sum())
    K = _bucket(kfs.size, 8)
    M = _bucket(lms.size, 2048)
    O = _bucket(n_obs, 8192)

    kf_index = np.full(m.max_kf, -1, np.int64)
    kf_index[kfs] = np.arange(kfs.size)
    lm_index = np.full(m.max_lm, -1, np.int32)
    lm_index[lms] = np.arange(lms.size)
    okf, okp, op, ol, ouv, olev, our = native.gather_observations(
        m.kf_kp_lm, m.kf_kp_uv, m.kf_kp_level, m.kf_kp_ur, kfs, lm_index,
        n_obs, O)

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
                op=op, ol=ol, ouv=ouv, olev=olev,
                omask=_padr(np.ones(n_obs, np.float32), O),
                our=our if cfg.bf > 0 else None,
                # pre-solve poses, for rows created before the write-back
                R_old=m.kf_R[kfs].copy(), t_old=m.kf_t[kfs].copy(),
                snap_next_kf=m.next_kf, snap_next_lm=m.next_lm)


def _assemble_inertial(m, imu, s):
    """The visual snapshot ``s`` plus the inertial one: the gauge (only the
    oldest keyframe's pose frozen), the body states through T_bc,
    velocities and biases, and the chain's intervals, preintegrated at
    each interval's first bias.  None when the chain has no interval with
    IMU rows."""
    from orb_slam3_study_kr_tpu_torch.pipeline.inertial_tracking import (
        KF_MAX_ROWS)
    kfs, K = s["kfs"], s["K"]
    chain = np.argsort(m.kf_timestamp[kfs], kind="stable")
    fixed = np.zeros(kfs.size, np.float32)
    fixed[chain[0]] = 1.0
    R_bc = imu.calib.R_bc.detach().cpu().numpy().astype(np.float64)
    t_bc = imu.calib.t_bc.detach().cpu().numpy().astype(np.float64)
    R_wb = np.swapaxes(R_bc @ s["R_all"], 1, 2)
    p_wb = -(R_wb @ (R_bc @ s["t_all"][..., None] + t_bc[:, None]))[..., 0]
    ts = m.kf_timestamp[kfs[chain]]
    # Each interval keeps its newest rows, as the inertial tracker does.
    rows = [imu.rows_between(float(a), float(b))[-KF_MAX_ROWS:]
            for a, b in zip(ts[:-1], ts[1:])]
    n = np.array([r.shape[0] for r in rows])
    if not n.any():
        return None
    with TIMERS.stage("gba/preintegrate"):
        pre = _preintegrate_chain(rows, n, m.kf_bias[kfs[chain[:-1]]],
                                  imu.calib)
    mask = (n > 0).astype(np.float32)
    return s | dict(
        fixed=fixed, fixed_p=_padr(fixed, K, 1.0),
        fixed_vb=_padr(np.zeros(kfs.size, np.float32), K, 1.0),
        R_wb=R_wb.astype(np.float32), p_wb=p_wb.astype(np.float32),
        v=_padr(m.kf_v[kfs], K), bias=_padr(m.kf_bias[kfs], K),
        edge_i=chain[:-1].astype(np.int32), edge_j=chain[1:].astype(np.int32),
        edge_mask=mask, pre=pre)


def _preintegrate_chain(rows, n, biases, calib):
    """Intervals rows[i] ((n[i], 7) [dt, acc, gyro]) at their biases (B,
    6), padded into one batch and preintegrated at once on the
    calibration's device."""
    live = np.arange(max(int(n.max()), 1)) < n[:, None]
    padded = np.zeros(live.shape + (7,), np.float32)
    padded[live] = np.concatenate(rows)
    t = torch.as_tensor(padded, device=calib.device)
    return preintegrate_batch_scan(
        t[..., 1:4], t[..., 4:7], t[..., 0],
        torch.as_tensor(live, dtype=torch.float32, device=calib.device),
        torch.as_tensor(np.asarray(biases, np.float32), device=calib.device),
        calib)


def _solve_vigba(cfg, imu, s, n_iters, dev):
    assembly = ("dense" if s["K"] * s["M"] * 18 <= DENSE_CROSS_BLOCK_FLOATS
                else "pcg")
    names = ("R_wb", "p_wb", "v", "bias", "fixed_p", "X", "lm_mask", "op",
             "ol", "ouv", "olev", "omask", "edge_i", "edge_j", "edge_mask",
             "fixed_vb")
    with TIMERS.stage("gba/upload"):
        a = {k: torch.as_tensor(s[k], device=dev) for k in names}
        R_cb = imu.calib.R_bc.T.to(dev, torch.float32)
        t_cb = -(R_cb @ imu.calib.t_bc.to(dev, torch.float32))
        pre = s["pre"].map(lambda x: x.to(dev))
        stereo_kw = {}
        if s["our"] is not None:
            stereo_kw = dict(obs_ur=torch.as_tensor(s["our"], device=dev),
                             bf=cfg.bf)
    R_wb, p_wb, v, bias, X_new, chi2, cost = inertial_bundle_adjust(
        cfg.project_fn, cfg.project_jac_fn, a["R_wb"], a["p_wb"], a["v"],
        a["bias"], a["fixed_p"], R_cb, t_cb, a["X"], a["lm_mask"], a["op"],
        a["ol"], a["ouv"], a["olev"], a["omask"], a["edge_i"], a["edge_j"],
        pre, a["edge_mask"], n_iters=n_iters, fixed_vb=a["fixed_vb"],
        wide_fov=cfg.is_kb8, assembly=assembly, camera=cfg.camera,
        **stereo_kw)
    with TIMERS.stage("gba/download"):
        R_cw = R_cb @ R_wb.transpose(1, 2)
        t_cw = t_cb - torch.einsum("kij,kj->ki", R_cw, p_wb)
        out = {k: x.cpu().numpy() for k, x in dict(
            R=R_cw, t=t_cw, X_new=X_new, chi2=chi2, v=v, bias=bias,
            cost=cost).items()}
    if not (np.isfinite(out["cost"]) and np.isfinite(out["R"]).all()
            and np.isfinite(out["t"]).all()):
        return None
    return out


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
        assembly=assembly, wide_fov=cfg.is_kb8, camera=cfg.camera,
        **stereo_kw)
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
    if "v" in out:
        # Every keyframe's velocity and biases are free, the gauge's too.
        vb = kfs[m.kf_valid[kfs]]
        m.kf_v[vb] = out["v"][kf_index[vb]]
        m.kf_bias[vb] = out["bias"][kf_index[vb]]
    live = lms[m.lm_valid[lms]]
    lm_index = np.full(m.max_lm, -1, np.int64)
    lm_index[lms] = np.arange(lms.size)
    m.lm_pos[live] = out["X_new"][lm_index[live]]

    # Rows created since the snapshot: correct through the newest snapshot
    # keyframe, T_child_new = T_child_old . T_ref_old^-1 . T_ref_new
    # (the reference's spanning-tree mTcwGBA propagation); an inertial
    # solve also turns their velocities by the world's correction R_d^T
    # (mVwbGBA) and keeps their biases.
    if m.next_kf > s["snap_next_kf"] or m.next_lm > s["snap_next_lm"]:
        i = kfs.size - 1
        R_d = s["R_old"][i].T @ out["R"][i]
        t_d = s["R_old"][i].T @ (out["t"][i] - s["t_old"][i])
        new_kfs = np.arange(s["snap_next_kf"], m.next_kf)
        new_kfs = new_kfs[m.kf_valid[new_kfs]]
        if new_kfs.size:
            R_c = (m.kf_R[new_kfs] @ R_d).astype(np.float32)
            m.kf_R[new_kfs] = R_c
            m.kf_t[new_kfs] = (m.kf_t[new_kfs]
                               + R_c @ (R_d.T @ t_d)).astype(np.float32)
            if "v" in out:
                m.kf_v[new_kfs] = m.kf_v[new_kfs] @ R_d
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
                # A keyframe's right coordinates are fixed when it is made:
                # the snapshot's are the map's.
                gate = np.where(s["our"][: okf.size] >= 0, CHI2_STEREO,
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
