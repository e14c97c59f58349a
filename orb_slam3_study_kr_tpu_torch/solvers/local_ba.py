"""Bundle adjustment as dense-block Levenberg-Marquardt with the Schur
complement over landmarks.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/local_ba.py``:

- observations are flat index arrays (pose_idx, landmark_idx, uv, level,
  mask) — the bipartite graph as COO;
- per-pose 6x6 and per-landmark 3x3 blocks come from segment sums
  (``ops/segment.py``: ``index_add_`` on the CPU, a fixed order on the
  card, its plans built once per solve);
- landmark elimination inverts (M, 3, 3) blocks in batch;
- ``assembly="dense"`` (the init BA and local BA) builds the reduced camera
  system S = Hpp - W Hll^-1 W^T from the dense (K, M, 6, 3) cross block and
  solves it densely; ``assembly="pcg"`` (global BA on large maps) never
  forms the cross block and solves S matrix-free with block-Jacobi
  preconditioned conjugate gradients, two segment-sum sweeps per matvec
  (on the card, one shard: the CG loop as the kernels of
  ``ops/cuda_schur.py``);
- on that route, with the BA's ideal pinhole camera, the linearization and
  every cost pass run as K5 (``ops/cuda_reproj.py``): residuals,
  Jacobians, Huber weights, the four block sums and E in one launch;
- LM damping with accept/reject stays on the device.

The caller culls observations whose final chi2 exceeds the 5.991 gate.

Spans of ``utils.profiling.DEFAULT_TIMERS`` (traced only while a profiler
runs): ``ba/solve`` with children ``ba/setup``, one ``ba/lm_iter`` per LM
iteration (``ba/linearize``, ``ba/schur``, ``ba/update``) and ``ba/final``;
in ``_schur_pcg`` ``ba/pcg_setup`` and ``ba/pcg_loop``.  Counts:
``ba/lm_steps`` and ``ba/cg_iters``.
"""

import torch

from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu_torch.ops import cuda_reproj, cuda_schur
from orb_slam3_study_kr_tpu_torch.ops.segment import segment_plan, segment_sum
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, solve_nan
from orb_slam3_study_kr_tpu_torch.solvers.reproj import residual_and_jacobians
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS as TIMERS


def _diag(Hb, n):
    eye = torch.eye(n, dtype=Hb.dtype, device=Hb.device)
    return eye * Hb * eye


def _only(parts):
    return parts[0]


def _schur_pcg(Hpp_d, bp, Hll_inv, bl, E, obs_pose, obs_lm, fixed, n_cg,
               plans, psum_fn=None, index=None, E_planes=None):
    """Matrix-free solve of the reduced camera system S dp = rhs.

    S v = Hpp_d v - W Hll_inv W^T v is two segment-sum sweeps over the
    observations (W is never formed); the block-Jacobi preconditioner uses
    the exact diagonal blocks of S (a pose/landmark pair has at most one
    observation, so the correction is one segment-sum of Y E^T).

    On CUDA tensors of one shard (``psum_fn is None``) the CG loop runs as
    the hand-written kernels of ``ops/cuda_schur.py`` (K4), float32 or
    float64, and ``index`` is required: the solve's ``schur_index``, which
    the caller builds once per solve; ``E_planes``, E as the kernel's
    landmark-sorted planes when the caller has them (K5 writes them), else
    gathered here.  Elsewhere ``_pcg_plain``, which is the kernel's plain
    version, and ``index`` and ``E_planes`` are not read.

    With ``psum_fn`` (the landmark-sharded solve of parallel/dist_ba.py)
    Hll_inv, bl, E, obs_pose and obs_lm are sequences with one entry per
    local shard, and ``psum_fn(partials)`` returns the global sum of the
    shards' pose-space partials on Hpp_d's device.  The setup's two
    pose-space segment sums and each matvec's u2 sweep are reduced; the
    landmark-space sweep stays on its shard, which holds each of its
    landmarks' every observation.  The pose-space CG itself runs once,
    on the reduced values.

    ``plans``: one (pose plan, landmark plan) per shard, the segment plans
    of obs_pose over the K poses and of obs_lm over the shard's landmarks
    (``ops/segment.py``), which the caller builds once per solve."""
    K = Hpp_d.shape[0]
    fused = psum_fn is None and Hpp_d.device.type == "cuda"
    if psum_fn is None:
        shards = [(Hll_inv, bl, E, obs_pose, obs_lm)]
        psum_fn = _only
    else:
        shards = list(zip(Hll_inv, bl, E, obs_pose, obs_lm))
    freeK = (1.0 - fixed)[:, None]
    with TIMERS.stage("ba/pcg_setup"):
        rhs, Minv = _pcg_setup(Hpp_d, bp, fixed, shards, plans, psum_fn)
        if fused:
            if index is None:
                raise ValueError("_schur_pcg: the CUDA route takes the "
                                 "solve's schur_index")
            if E_planes is None:
                E_planes = cuda_schur.landmark_planes(E, index)

    with TIMERS.stage("ba/pcg_loop"):
        TIMERS.count("ba/cg_iters", n_cg)
        if fused:
            return cuda_schur.schur_pcg(Hpp_d, Hll_inv, E_planes, Minv, rhs,
                                        fixed, index, n_cg)
        return _pcg_plain(lambda v: _schur_matvec(v, Hpp_d, freeK, shards,
                                                  plans, psum_fn),
                          Minv, rhs, n_cg)


def _schur_terms(Hpp_d, bp, shards, plans, psum_fn):
    """(g, Dk): the reduced gradient bp - W Hll_inv bl and the diagonal
    blocks Hpp_d - (W Hll_inv W^T)_kk of S, unmasked (a pose/landmark pair
    has at most one observation, so the correction is one segment-sum of
    Y E^T)."""
    K = Hpp_d.shape[0]
    Ys = [torch.einsum("nab,nbc->nac", Es, Hi[ol])            # (O, 6, 3)
          for Hi, _, Es, _, ol in shards]
    g = bp - psum_fn([segment_sum(K, op, torch.einsum(
        "nab,nb->na", Y, bls[ol]), pp)
        for Y, (_, bls, _, op, ol), (pp, _) in zip(Ys, shards, plans)])
    Dk = Hpp_d - psum_fn([segment_sum(K, op, torch.einsum(
        "nab,ncb->nac", Y, Es), pp)
        for Y, (_, _, Es, op, _), (pp, _) in zip(Ys, shards, plans)])
    return g, Dk


def _pcg_setup(Hpp_d, bp, fixed, shards, plans, psum_fn):
    """(rhs, Minv) of ``_schur_pcg``: the reduced right-hand side and the
    inverse diagonal blocks of S, identity at the fixed poses."""
    freeK = (1.0 - fixed)[:, None]
    g, Dk = _schur_terms(Hpp_d, bp, shards, plans, psum_fn)
    rhs = -g * freeK
    eye6 = torch.eye(6, dtype=Hpp_d.dtype, device=Hpp_d.device)
    Dk = Dk * freeK[..., None] + eye6[None] * fixed[:, None, None]
    return rhs, inv_nan(Dk)


def _schur_u2(w, shards, plans, psum_fn):
    """u2 = W Hll_inv W^T w (K, 6) as two segment-sum sweeps per shard,
    reduced over the shards by ``psum_fn``."""
    K = w.shape[0]

    def u2_part(w, Hi, Es, op, ol, pp, lp):
        w = w.to(Es.device)
        tv = segment_sum(Hi.shape[0], ol,
                         torch.einsum("nab,na->nb", Es, w[op]), lp)
        z = torch.einsum("mab,mb->ma", Hi, tv)
        return segment_sum(K, op, torch.einsum("nab,nb->na", Es, z[ol]), pp)

    return psum_fn([u2_part(w, Hi, Es, op, ol, pp, lp)
                    for (Hi, _, Es, op, ol), (pp, lp) in zip(shards, plans)])


def _schur_matvec(v, Hpp_d, freeK, shards, plans, psum_fn):
    """S v of ``_schur_pcg``'s plain loop: freeK (Hpp_d w - u2) with
    w = freeK v and u2 = W Hll_inv W^T w (``_schur_u2``)."""
    w = v * freeK
    u = torch.einsum("kab,kb->ka", Hpp_d, w)
    u2 = _schur_u2(w, shards, plans, psum_fn)
    return (u - u2) * freeK


def _pcg_plain(matvec, Minv, rhs, n_cg):
    """n_cg block-Jacobi PCG iterations on matvec(x) = rhs from x = 0."""
    dt, dev = rhs.dtype, rhs.device
    x = torch.zeros(rhs.shape, dtype=dt, device=dev)
    r = rhs
    z = torch.einsum("kab,kb->ka", Minv, r)
    p = z
    rz = torch.sum(r * z)
    zero = torch.zeros((), dtype=dt, device=dev)
    for _ in range(n_cg):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("kab,kb->ka", Minv, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x


def bundle_adjust(project_fn, project_jac_fn,
                  R_cw, t_cw, fixed,            # (K,3,3), (K,3), (K,) 1 = frozen
                  X, lm_mask,                   # (M,3), (M,) 1 = live landmark
                  obs_pose, obs_lm, obs_uv, obs_level, obs_mask,
                  n_iters: int = 10, use_huber: bool = True,
                  init_lambda: float = 1e-4, assembly: str = "dense",
                  n_cg: int = 60, obs_ur=None, bf=None, wide_fov=False,
                  camera=None):
    """Returns (R_cw, t_cw, X, final_chi2 (O,), final_cost).  ``assembly``
    is "dense" or "pcg" (see the module docstring).  With obs_ur (O,) and
    bf = fx * baseline, observations with obs_ur >= 0 get the stereo third
    residual row and the 3-dof chi2/Huber gate 7.815.  ``wide_fov``: the
    fisheye cheirality |p| > 1e-3 in place of z > 1e-3.  ``camera``: the
    ``cameras.camera.Camera`` that project_fn and project_jac_fn evaluate;
    a one-shard PCG solve on the card with a zero-distortion pinhole runs
    its linearization and costs as K5 (``cuda_reproj.takes``)."""
    if assembly not in ("dense", "pcg"):
        raise ValueError(f"bundle_adjust: unknown assembly {assembly!r}")
    with TIMERS.stage("ba/solve"):
        K = R_cw.shape[0]
        M = X.shape[0]
        dt = R_cw.dtype
        dev = R_cw.device
        with TIMERS.stage("ba/setup"):
            obs_pose = obs_pose.long()
            obs_lm = obs_lm.long()
            inv_sigma2 = robust.octave_inv_sigma2(obs_level)
            if obs_ur is None:
                chi2_gate = torch.tensor(robust.CHI2_MONO, dtype=dt,
                                         device=dev)
            else:
                chi2_gate = torch.where(
                    obs_ur >= 0,
                    torch.tensor(robust.CHI2_STEREO, dtype=dt, device=dev),
                    torch.tensor(robust.CHI2_MONO, dtype=dt, device=dev))
            huber_delta = torch.sqrt(chi2_gate)
            eye3 = torch.eye(3, dtype=dt, device=dev)
            eye6 = torch.eye(6, dtype=dt, device=dev)
            cell = obs_pose * M + obs_lm
            # The segment sums' orders, fixed once per solve (None on the
            # CPU).
            pose_plan = segment_plan(K, obs_pose)
            lm_plan = segment_plan(M, obs_lm)
            cell_plan = (segment_plan(K * M, cell) if assembly == "dense"
                         else None)
            # The PCG kernels' index arrays, once per solve; the masked
            # observations (weight 0, so E = 0) stay out of their ranges.
            k5 = cuda_reproj.takes(camera, dev, assembly, wide_fov)
            pcg_index = (cuda_schur.schur_index(K, M, obs_pose, obs_lm,
                                                pose_plan, lm_plan, obs_mask)
                         if assembly == "pcg" and (dev.type == "cuda" or k5)
                         else None)
            lin = (cuda_reproj.setup(camera, pcg_index, obs_pose, obs_lm,
                                     obs_uv, inv_sigma2, obs_mask, lm_mask,
                                     fixed, obs_ur=obs_ur, bf=bf,
                                     use_huber=use_huber)
                   if k5 else None)

            def huber_rho(chi2):
                r = torch.sqrt(torch.clamp(chi2, min=1e-12))
                return torch.where(chi2 <= chi2_gate, chi2,
                                   2 * huber_delta * r - chi2_gate)

            def compute(R_all, t_all, X_all):
                r, J_pose, J_point, p = residual_and_jacobians(
                    project_jac_fn, project_fn, R_all[obs_pose],
                    t_all[obs_pose], X_all[obs_lm], obs_uv, ur_obs=obs_ur,
                    bf=bf)
                chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
                valid = (obs_mask * lm_mask[obs_lm]
                         * robust.cheirality(p, wide_fov))
                w = inv_sigma2 * valid
                if use_huber:
                    w = w * robust.huber_weight(chi2, huber_delta)
                    cost = torch.sum(huber_rho(chi2) * valid)
                else:
                    cost = torch.sum(chi2 * valid)
                return r, J_pose, J_point, w, chi2, cost

            free_pose = (1.0 - fixed)[obs_pose]
            fixd = fixed.repeat_interleave(6)
            R_all, t_all, X_all = R_cw, t_cw, X
            lam = torch.tensor(init_lambda, dtype=dt, device=dev)
            cost = (cuda_reproj.cost(lin, R_all, t_all, X_all) if k5
                    else compute(R_all, t_all, X_all)[5])
        for _ in range(n_iters):
            with TIMERS.stage("ba/lm_iter"):
                TIMERS.count("ba/lm_steps")
                with TIMERS.stage("ba/linearize"):
                    if k5:
                        Hpp, bp, Hll, bl, E, E_planes = cuda_reproj.linearize(
                            lin, R_all, t_all, X_all)
                    else:
                        r, J_pose, J_point, w, chi2, _ = compute(R_all, t_all,
                                                                 X_all)
                        Jp = J_pose * free_pose[:, None, None]
                        Hpp = segment_sum(K, obs_pose, torch.einsum(
                            "nia,n,nib->nab", Jp, w, Jp), pose_plan)
                        bp = segment_sum(K, obs_pose, torch.einsum(
                            "nia,n,ni->na", Jp, w, r), pose_plan)
                        Hll = segment_sum(M, obs_lm, torch.einsum(
                            "nia,n,nib->nab", J_point, w, J_point), lm_plan)
                        bl = segment_sum(M, obs_lm, torch.einsum(
                            "nia,n,ni->na", J_point, w, r), lm_plan)
                        E = torch.einsum("nia,n,nib->nab", Jp, w,
                                         J_point)               # (O, 6, 3)
                        E_planes = None

                with TIMERS.stage("ba/schur"):
                    Hll_d = Hll + lam * (eye3[None] + _diag(Hll, 3))
                    Hpp_d = Hpp + lam * (eye6[None] + _diag(Hpp, 6))
                    Hll_inv = inv_nan(Hll_d) * lm_mask[:, None, None]
                    if assembly == "dense":
                        # Dense cross block W (K, M, 6, 3) and the reduced
                        # camera system.
                        W = segment_sum(K * M, cell, E, cell_plan).reshape(
                            K, M, 6, 3)
                        Wi = torch.einsum("kmab,mbc->kmac", W, Hll_inv)
                        S = -torch.einsum("kmac,lmbc->kalb", Wi, W).reshape(
                            6 * K, 6 * K)
                        S = S + torch.block_diag(*Hpp_d)
                        rhs = -(bp - torch.einsum("kmab,mb->ka", Wi,
                                                  bl)).reshape(6 * K)
                        S = (S * (1 - fixd)[:, None] * (1 - fixd)[None, :]
                             + torch.diag(fixd))
                        dp = solve_nan(S, rhs).reshape(K, 6)
                    else:
                        dp = _schur_pcg(Hpp_d, bp, Hll_inv, bl, E, obs_pose,
                                        obs_lm, fixed, n_cg,
                                        [(pose_plan, lm_plan)],
                                        index=pcg_index, E_planes=E_planes)

                with TIMERS.stage("ba/update"):
                    Wtdp = segment_sum(M, obs_lm, torch.einsum(
                        "nab,na->nb", E, dp[obs_pose]), lm_plan)
                    dl = -torch.einsum("mab,mb->ma", Hll_inv, bl + Wtdp)

                    dR, dtr = exp_se3(dp)
                    R_new, t_new = se3_compose(dR, dtr, R_all, t_all)
                    X_new = X_all + dl * lm_mask[:, None]
                    cost_new = (cuda_reproj.cost(lin, R_new, t_new, X_new)
                                if k5 else compute(R_new, t_new, X_new)[5])
                    accept = cost_new < cost
                    R_all = torch.where(accept, R_new, R_all)
                    t_all = torch.where(accept, t_new, t_all)
                    X_all = torch.where(accept, X_new, X_all)
                    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                                      torch.clamp(lam * 4.0, max=1e3))
                    cost = torch.where(accept, cost_new, cost)
        with TIMERS.stage("ba/final"):
            chi2 = (cuda_reproj.cost(lin, R_all, t_all, X_all, chi2=True)[1]
                    if k5 else compute(R_all, t_all, X_all)[4])
    return R_all, t_all, X_all, chi2, cost
