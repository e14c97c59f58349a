"""Visual-inertial bundle adjustment: joint optimization of keyframe body
states (pose, velocity, IMU biases) and landmarks.

Counterpart of ``orb_slam3_study_kr_tpu/solvers/inertial_ba.py``
(Optimizer::LocalInertialBA: a temporal window with the keyframe before it
fixed and fixed visual observers, per-keyframe biases with random-walk
edges; Optimizer::FullInertialBA: the whole chain, in init mode one shared
bias with the priorG/priorA prior and no random-walk edges; Huber
sqrt(16.92) on the 9-D preintegration edges).

Each keyframe is a 15-dof state [phi, dp, dv, dbg, dba].  With
``assembly="dense"`` (the local inertial BA, IMU init, small maps) the
states form one dense (K*15, K*15) system; landmarks are eliminated with
the batched Schur complement through the dense (K, M, 6, 3) cross block,
the correction landing on the pose dims [0:6] of each state.  With
``assembly="pcg"`` (the loop closer's full inertial BA on a large map) the
cross block and the dense system are never formed: the reduced system is
each state's 15x15 diagonal block, its coupling to the next keyframe of
the temporal chain (the inertial edges of a chain are block-tridiagonal)
and the visual part W Hll^-1 W^T on the pose slice as two sweeps over the
observations, solved by block-Jacobi PCG (on one-shard CUDA tensors the
loop of ``ops/cuda_schur.vi_schur_pcg``; with the BA's ideal pinhole
camera its visual linearization and costs run as K5,
``ops/cuda_reproj.py``).  Both assemblies damp the Schur-complemented
diagonal alike, so they solve the same step.

Visual Jacobians are closed form; the 9-D preintegration edges get their
24-dim pair Jacobians from forward-mode autodiff in the dense assembly
(the reference's jacfwd twin) and in closed form
(``imu.preintegration.inertial_jacobian``: the exact derivative, within
1.4e-8 of autodiff's through exp_so3's small-angle series, without its host
dispatch) in the PCG assembly, whose LM step also queues no host sync.  Blocks are scattered
through ``ops/segment.py``: ``index_add_`` / ``index_put_(accumulate=True)``
in input order on the CPU, a fixed order on the card (its plans built once
per solve), so a run on the card gives the same bits every time; they
differ from the CPU's by float32 rounding.  LM damping with accept/reject
stays on the device.

Spans of ``utils.profiling.DEFAULT_TIMERS`` (traced only while a profiler
runs): ``viba/solve``; per LM step ``viba/linearize`` (visual rows, Hll,
E), ``viba/inertial`` (inertial residuals, Jacobians and blocks),
``viba/schur`` with ``viba/pcg_loop`` in the PCG assembly, and
``viba/update``.  Counts: ``viba/lm_steps``, ``viba/inertial_edges``,
``viba/cg_iters``.
"""

import torch
import torch.nn.functional as F

from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    Preintegrated, gravity, inertial_jacobian, inertial_residual)
from orb_slam3_study_kr_tpu_torch.lie.so3 import (exp_so3, hat,
                                                  normalize_rotation,
                                                  orthonormalize)
from orb_slam3_study_kr_tpu_torch.ops import cuda_reproj, cuda_schur
from orb_slam3_study_kr_tpu_torch.ops.segment import (put_add_, put_plan,
                                                      segment_plan, segment_sum)
from orb_slam3_study_kr_tpu_torch.solvers import local_ba, robust
from orb_slam3_study_kr_tpu_torch.solvers.inertial import (
    batched_jacobian, edge_whitening)
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, solve_nan
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS as TIMERS

# Huber delta^2 on the whitened 9-D inertial edges (Optimizer.cc:543).
CHI2_INERTIAL = 16.92


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _huber_rho(chi2, d2, d):
    rr = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= d2, chi2, 2 * d * rr - d2)


def _pairs(rows, cols):
    """The flat (row, col) index pair of broadcast rows and cols: H[rows,
    cols] += vals accumulates repeated pairs through put_add_."""
    rows, cols = torch.broadcast_tensors(rows, cols)
    return rows.reshape(-1), cols.reshape(-1)


def _edge_blocks(J_i, w_i, r_i, r_rw, Wd, edge_mask):
    """Each chain edge's normal-equation blocks over its two 15-wide
    states: (Hii, Hij, Hjj) (E, 15, 15) and (gi, gj) (E, 15), from the 9-D
    edge (Jacobian J_i (E, 9, 24) over [phi, p, v of i, bias of i, phi, p,
    v of j]) and the 6-D bias random-walk edge (J = [-diag(Wd) | diag(Wd)]
    on the two biases, residual r_rw sqrt(mask))."""
    He = torch.einsum("eia,e,eib->eab", J_i, w_i, J_i)
    ge = torch.einsum("eia,e,ei->ea", J_i, w_i, r_i)
    Hii, gi = He[:, :15, :15], ge[:, :15]
    Hij = F.pad(He[:, :15, 15:], (0, 6))
    Hjj = F.pad(He[:, 15:, 15:], (0, 6, 0, 6))
    gj = F.pad(ge[:, 15:], (0, 6))
    if r_rw is not None:
        rw = F.pad(torch.diag_embed(Wd * Wd), (9, 0, 9, 0))
        gr = F.pad(Wd * r_rw * edge_mask[:, None] ** 0.5, (9, 0))
        Hii, Hjj, Hij = Hii + rw, Hjj + rw, Hij - rw
        gi, gj = gi - gr, gj + gr
    return Hii, Hij, Hjj, gi, gj


def _vi_matvec(v, D, U, nxt, free_dims, shards, plans):
    """The PCG assembly's A v in plain torch: freeD (D w + U w[nxt] +
    U[prv]^T w[prv] - P^T W Hll^-1 W^T w[:, :6]), w = freeD v."""
    w = v * free_dims
    prv = cuda_schur.chain_prev(nxt).long()
    n = nxt.long()
    hn = (n >= 0).to(v.dtype)[:, None]
    hp = (prv >= 0).to(v.dtype)[:, None]
    n0, p0 = n.clamp(min=0), prv.clamp(min=0)
    u = (torch.einsum("kab,kb->ka", D, w)
         + torch.einsum("kab,kb->ka", U, w[n0]) * hn
         + torch.einsum("kba,kb->ka", U[p0], w[p0]) * hp)
    u2 = local_ba._schur_u2(w[:, :6], shards, plans, local_ba._only)
    u = torch.cat([u[:, :6] - u2, u[:, 6:]], 1)
    return u * free_dims


def _vi_schur_pcg(D, U, nxt, Minv, rhs, Hll_inv, E, obs_pose, obs_lm, fixed,
                  free_dims, n_cg, plans, index=None, E_planes=None):
    """x (K, 15) after n_cg block-Jacobi PCG iterations on the PCG
    assembly's reduced system from x = 0: on CUDA tensors the kernels of
    ``ops/cuda_schur.vi_schur_pcg`` (``index``: the solve's
    ``schur_index``, required there; ``E_planes`` as ``local_ba._schur_pcg``
    takes them), elsewhere the plain loop."""
    fused = D.device.type == "cuda"
    if fused:
        if index is None:
            raise ValueError("_vi_schur_pcg: the CUDA route takes the "
                             "solve's schur_index")
        if E_planes is None:
            E_planes = cuda_schur.landmark_planes(E, index)
    with TIMERS.stage("viba/pcg_loop"):
        TIMERS.count("viba/cg_iters", n_cg)
        if fused:
            return cuda_schur.vi_schur_pcg(D, U, nxt, Hll_inv, E_planes,
                                           Minv, rhs, fixed, free_dims, index,
                                           n_cg)
        shards = [(Hll_inv, None, E, obs_pose, obs_lm)]
        return local_ba._pcg_plain(
            lambda v: _vi_matvec(v, D, U, nxt, free_dims, shards, plans),
            Minv, rhs, n_cg)


@TIMERS.stage("viba/solve")
def inertial_bundle_adjust(
        project_fn, project_jac_fn,
        R_wb, p_wb, v_w, bias,        # (K,3,3) (K,3) (K,3) (K,6) body states
        fixed,                        # (K,) 1.0 = frozen pose
        R_cb, t_cb,                   # camera <- body extrinsic
        X, lm_mask,                   # (M,3), (M,)
        obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # visual COO
        edge_i, edge_j, pre_stack: Preintegrated, edge_mask,  # (E,) chain
        n_iters: int = 10,
        shared_bias: bool = False,    # FullInertialBA init mode
        bias_src=None,                # state index holding the shared bias
        prior_gyro: float = 0.0,      # bias prior information
        prior_acc: float = 0.0,
        init_lambda: float = 1e-4,
        obs_ur=None, bf=None,
        fixed_vb=None,                # (K,) 1.0 = frozen velocity and bias
        wide_fov: bool = False,       # fisheye: |p| > 1e-3, not z > 1e-3
        assembly: str = "dense", n_cg: int = 60,
        camera=None):                 # the Camera of project_fn (K5's route)
    """Returns (R_wb, p_wb, v_w, bias, X, chi2_vis (O,), cost).

    edge_i / edge_j index the K states (masked edges are no-ops).  In
    shared_bias mode every inertial edge reads the bias of state `bias_src`
    and the random-walk edges are dropped; otherwise edge e uses state
    edge_i[e]'s bias and a 6-D random-walk edge couples the two states'
    biases.  ``assembly="pcg"`` (see the module docstring, ``n_cg`` CG
    iterations an LM step) takes a chain: each state is edge_i of at most
    one edge and edge_j of at most one, and no shared bias.  ``camera``:
    the ``cameras.camera.Camera`` that project_fn and project_jac_fn
    evaluate; on the card the PCG assembly with a zero-distortion pinhole
    runs the visual linearization and costs as K5
    (``cuda_reproj.takes``)."""
    if assembly not in ("dense", "pcg"):
        raise ValueError(f"inertial_bundle_adjust: unknown assembly "
                         f"{assembly!r}")
    if assembly == "pcg" and shared_bias:
        raise ValueError("inertial_bundle_adjust: the PCG assembly takes "
                         "per-keyframe biases (shared_bias=False)")
    pcg = assembly == "pcg"
    K = R_wb.shape[0]
    M = X.shape[0]
    E = edge_i.shape[0]
    dtype, dev = R_wb.dtype, R_wb.device
    g = gravity(dev, dtype)
    if bias_src is None:
        bias_src = K - 1
    fvb = fixed if fixed_vb is None else fixed_vb
    obs_pose, obs_lm = obs_pose.long(), obs_lm.long()
    ei, ej = edge_i.long(), edge_j.long()

    inv_sigma2 = robust.octave_inv_sigma2(obs_level)
    if obs_ur is None:
        chi2_gate = torch.tensor(robust.CHI2_MONO, dtype=dtype, device=dev)
    else:
        chi2_gate = torch.where(
            obs_ur >= 0, torch.tensor(robust.CHI2_STEREO, dtype=dtype, device=dev),
            torch.tensor(robust.CHI2_MONO, dtype=dtype, device=dev))
    huber_delta = torch.sqrt(chi2_gate)
    d2_in = torch.tensor(CHI2_INERTIAL, dtype=dtype, device=dev)
    d_in = torch.sqrt(d2_in)

    W9 = edge_whitening(pre_stack)
    # Bias random-walk whitening from the accumulated walk covariance
    # (EdgeGyroRW/EdgeAccRW information, diagonal by construction).
    w_rw = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(pre_stack.cov, dim1=-2, dim2=-1)[:, 9:15], min=1e-14))

    ebias_src = (torch.full((E,), bias_src, dtype=torch.long, device=dev)
                 if shared_bias else ei)
    ar15 = torch.arange(15, device=dev)
    all_edge_cols = torch.cat([ei[:, None] * 15 + ar15[None, 0:9],
                               ebias_src[:, None] * 15 + ar15[None, 9:15],
                               ej[:, None] * 15 + ar15[None, 0:9]], 1)
    rw_cols = torch.cat([ei[:, None] * 15 + ar15[None, 9:15],
                         ej[:, None] * 15 + ar15[None, 9:15]], 1)
    free = (1.0 - fixed).to(dtype)
    n_dim = K * 15
    pose_dims = (torch.arange(K, device=dev)[:, None] * 15
                 + ar15[None, :6]).reshape(-1)
    fixd = torch.where((ar15 < 6).repeat(K), fixed.repeat_interleave(15),
                       fvb.repeat_interleave(15))
    pr = torch.cat([torch.full((3,), float(prior_gyro), dtype=dtype, device=dev),
                    torch.full((3,), float(prior_acc), dtype=dtype, device=dev)])
    pcols = bias_src * 15 + ar15[9:15]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    # Every scatter's index with the segment plan of its sums (None on the
    # CPU), fixed once per solve.
    plan = dict(pose=segment_plan(K, obs_pose), lm=segment_plan(M, obs_lm))
    if pcg:
        # The chain: nxt[k] the state after k (-1: none); each state's
        # diagonal blocks are summed over the edges that touch it.
        nxt = torch.full((K,), -1, dtype=torch.int32, device=dev)
        nxt[ei] = ej.to(torch.int32)
        ends = torch.cat([ei, ej])
        plan["state"] = segment_plan(K, ends)
        free_dims = (1.0 - fixd).reshape(K, 15).to(dtype)
        k5 = cuda_reproj.takes(camera, dev, assembly, wide_fov)
        pcg_index = (cuda_schur.schur_index(K, M, obs_pose, obs_lm,
                                            plan["pose"], plan["lm"],
                                            obs_mask)
                     if dev.type == "cuda" or k5 else None)
        lin = (cuda_reproj.setup(camera, pcg_index, obs_pose, obs_lm, obs_uv,
                                 inv_sigma2, obs_mask, lm_mask, fixed,
                                 obs_ur=obs_ur, bf=bf,
                                 extrinsic=(R_cb, t_cb))
               if k5 else None)
    else:
        lin = None
        HS = (n_dim, n_dim)
        edge_pairs = _pairs(all_edge_cols[:, :, None],
                            all_edge_cols[:, None, :])
        rw_pairs = _pairs(rw_cols[:, :, None], rw_cols[:, None, :])
        pose_pairs = _pairs(pose_dims[:, None], pose_dims[None, :])
        plan.update(
            W=put_plan((K, M), (obs_pose, obs_lm)),
            edge_H=put_plan(HS, edge_pairs),
            edge_b=segment_plan(n_dim, all_edge_cols.reshape(-1)),
            rw_H=None if shared_bias else put_plan(HS, rw_pairs),
            rw_b=(None if shared_bias
                  else segment_plan(n_dim, rw_cols.reshape(-1))),
            prior_H=put_plan(HS, (pcols, pcols)),
            prior_b=segment_plan(n_dim, pcols),
            pose_H=put_plan(HS, pose_pairs),
            pose_b=segment_plan(n_dim, pose_dims))

    def vis_terms(R_all, p_all, X_all, jacobians=True):
        """Residuals and closed-form Jacobians of the visual edges w.r.t.
        right-multiplicative body increments: with q = R_wb^T (X - p_wb),
        p_cam = R_cb q + t_cb: dp_cam/dphi = R_cb hat(q), dp_cam/ddp =
        -R_cb R_wb^T, dp_cam/dX = R_cb R_wb^T.  Without ``jacobians`` (a
        cost) the Jacobians are None."""
        Ro = R_all[obs_pose]
        po = p_all[obs_pose]
        Xo = X_all[obs_lm]
        q = torch.einsum("nji,nj->ni", Ro, Xo - po)
        pc = torch.einsum("ab,nb->na", R_cb, q) + t_cb
        uv_hat = project_fn(pc)
        r = uv_hat - obs_uv
        if obs_ur is not None:
            z = torch.clamp(pc[..., 2], min=1e-6)
            ur_hat = uv_hat[..., 0] - bf / z
            has_ur = (obs_ur >= 0).to(dtype)
            r3 = (ur_hat - obs_ur) * has_ur
            r = torch.cat([r, r3[..., None]], -1)
        depth_ok = robust.cheirality(pc, wide_fov).to(dtype)
        if not jacobians:
            return r, None, None, depth_ok
        Jp = project_jac_fn(pc)                          # (O, 2, 3)
        if obs_ur is not None:
            zero = torch.zeros_like(z)
            J3 = Jp[..., 0, :] + torch.stack([zero, zero, bf / (z * z)], -1)
            J3 = J3 * has_ur[..., None]
            Jp = torch.cat([Jp, J3[..., None, :]], -2)
        RcRbw = torch.einsum("ab,ncb->nac", R_cb, Ro)      # R_cb @ R_wb^T
        J_phi = torch.einsum("nda,ab,nbc->ndc", Jp, R_cb, hat(q))
        J_dp = -torch.einsum("nda,nab->ndb", Jp, RcRbw)
        J_X = torch.einsum("nda,nab->ndb", Jp, RcRbw)
        return r, torch.cat([J_phi, J_dp], -1), J_X, depth_ok

    def edge_res(dx, R_all, p_all, v_all, b_all):
        """(..., E, 9) whitened inertial residuals at the states moved by
        the local increments dx (..., E, 24) = [phi_i, dp_i, dv_i,
        dbias_src, phi_j, dp_j, dv_j]."""
        R1 = R_all[ei] @ exp_so3(dx[..., 0:3])
        p1 = p_all[ei] + dx[..., 3:6]
        v1 = v_all[ei] + dx[..., 6:9]
        b = b_all[ebias_src] + dx[..., 9:15]
        R2 = R_all[ej] @ exp_so3(dx[..., 15:18])
        p2 = p_all[ej] + dx[..., 18:21]
        v2 = v_all[ej] + dx[..., 21:24]
        return _mv(W9, inertial_residual(R1, p1, v1, R2, p2, v2, b,
                                         pre_stack, g))

    def state_res(R_all, p_all, v_all, b_all):
        """edge_res at zero increments."""
        return _mv(W9, inertial_residual(
            R_all[ei], p_all[ei], v_all[ei], R_all[ej], p_all[ej], v_all[ej],
            b_all[ebias_src], pre_stack, g))

    z24 = torch.zeros((E, 24), dtype=dtype, device=dev)

    def full_cost(R_all, p_all, v_all, b_all, X_all):
        if lin is not None:
            c_vis = cuda_reproj.cost(lin, R_all, p_all, X_all)
        else:
            r_v, _, _, depth_ok = vis_terms(R_all, p_all, X_all, False)
            chi2 = torch.sum(r_v * r_v, -1) * inv_sigma2
            valid = obs_mask * lm_mask[obs_lm] * depth_ok
            c_vis = torch.sum(_huber_rho(chi2, chi2_gate, huber_delta)
                              * valid)
        r_i = state_res(R_all, p_all, v_all, b_all)
        chi2_i = torch.sum(r_i * r_i, -1)
        c_in = torch.sum(_huber_rho(chi2_i, d2_in, d_in) * edge_mask)
        if not shared_bias:
            r_rw = (b_all[ej] - b_all[ei]) * w_rw
            c_in = c_in + torch.sum(torch.sum(r_rw * r_rw, -1) * edge_mask)
        bsb = b_all[bias_src]
        c_pr = (prior_gyro * torch.sum(bsb[:3] ** 2)
                + prior_acc * torch.sum(bsb[3:] ** 2))
        return c_vis + c_in + c_pr

    R_all, p_all, v_all, b_all, X_all = R_wb, p_wb, v_w, bias, X
    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    cost = full_cost(R_all, p_all, v_all, b_all, X_all)
    for _ in range(n_iters):
        TIMERS.count("viba/lm_steps")
        # Visual part and the landmark Schur complement.
        with TIMERS.stage("viba/linearize"):
            if lin is not None:
                Hpp6, bp6, Hll, bl, Eob, E_planes = cuda_reproj.linearize(
                    lin, R_all, p_all, X_all)
            else:
                r_v, J_pose6, J_X, depth_ok = vis_terms(R_all, p_all, X_all)
                chi2 = torch.sum(r_v * r_v, -1) * inv_sigma2
                valid = obs_mask * lm_mask[obs_lm] * depth_ok
                w = inv_sigma2 * valid * robust.huber_weight(chi2,
                                                             huber_delta)
                Jp6 = J_pose6 * free[obs_pose][:, None, None]
                Hpp6 = segment_sum(K, obs_pose, torch.einsum(
                    "nia,n,nib->nab", Jp6, w, Jp6), plan["pose"])
                bp6 = segment_sum(K, obs_pose, torch.einsum(
                    "nia,n,ni->na", Jp6, w, r_v), plan["pose"])
                Hll = segment_sum(M, obs_lm, torch.einsum(
                    "nia,n,nib->nab", J_X, w, J_X), plan["lm"])
                bl = segment_sum(M, obs_lm, torch.einsum(
                    "nia,n,ni->na", J_X, w, r_v), plan["lm"])
                Eob = torch.einsum("nia,n,nib->nab", Jp6, w,
                                   J_X)                         # (O, 6, 3)
                E_planes = None

        # Inertial edges.
        with TIMERS.stage("viba/inertial"):
            TIMERS.count("viba/inertial_edges", E)
            args = (R_all, p_all, v_all, b_all)
            r_i = state_res(*args)
            if pcg:
                J_i = W9 @ inertial_jacobian(
                    R_all[ei], p_all[ei], v_all[ei], R_all[ej], p_all[ej],
                    v_all[ej], b_all[ebias_src], pre_stack, g)
            else:
                J_i = batched_jacobian(lambda dx: edge_res(dx, *args),
                                       z24)                     # (E, 9, 24)
            chi2_i = torch.sum(r_i * r_i, -1)
            w_i = edge_mask * robust.huber_weight(chi2_i, d_in)
            r_rw = Wd = None
            if not shared_bias:
                # Bias random-walk edges: linear, J = [-W_rw | W_rw].
                r_rw = (b_all[ej] - b_all[ei]) * w_rw
                Wd = w_rw * edge_mask[:, None] ** 0.5
            if pcg:
                Hii, Hij, Hjj, gi, gj = _edge_blocks(J_i, w_i, r_i, r_rw, Wd,
                                                     edge_mask)
                Hin = segment_sum(K, ends, torch.cat([Hii, Hjj]),
                                  plan["state"])
                g15 = segment_sum(K, ends, torch.cat([gi, gj]), plan["state"])
                U = torch.zeros((K, 15, 15), dtype=dtype, device=dev)
                U[ei] = Hij
                # Bias priors.
                Hin[bias_src, 9:, 9:] += torch.diag(pr)
                g15[bias_src, 9:] += pr * b_all[bias_src]
            else:
                Hd = torch.zeros((n_dim, n_dim), dtype=dtype, device=dev)
                bvec = torch.zeros((n_dim,), dtype=dtype, device=dev)
                put_add_(Hd, edge_pairs, torch.einsum(
                    "eia,e,eib->eab", J_i, w_i, J_i).reshape(-1),
                    plan["edge_H"])
                put_add_(bvec, (all_edge_cols.reshape(-1),), torch.einsum(
                    "eia,e,ei->ea", J_i, w_i, r_i).reshape(-1),
                    plan["edge_b"])
                if not shared_bias:
                    Jrw = torch.cat([-torch.diag_embed(Wd),
                                     torch.diag_embed(Wd)], -1)
                    put_add_(Hd, rw_pairs, torch.einsum(
                        "eia,eib->eab", Jrw, Jrw).reshape(-1), plan["rw_H"])
                    put_add_(bvec, (rw_cols.reshape(-1),), torch.einsum(
                        "eia,ei->ea", Jrw,
                        r_rw * edge_mask[:, None] ** 0.5).reshape(-1),
                        plan["rw_b"])
                # Bias priors.
                put_add_(Hd, (pcols, pcols), pr, plan["prior_H"])
                put_add_(bvec, (pcols,), pr * b_all[bias_src],
                         plan["prior_b"])

        with TIMERS.stage("viba/schur"):
            Hll_d = Hll + lam * (eye3[None] + Hll * eye3[None])
            Hll_inv = inv_nan(Hll_d) * lm_mask[:, None, None]
            if pcg:
                # The reduced system over the states, never formed: the
                # diagonal blocks B (the visual part Schur-complemented, as
                # the dense Hd has them) set the damping; the matvec's own
                # diagonal D holds the visual Hpp instead, the landmarks'
                # correction coming from the sweeps.
                g6, Dk6 = local_ba._schur_terms(
                    Hpp6, bp6, [(Hll_inv, bl, Eob, obs_pose, obs_lm)],
                    [(plan["pose"], plan["lm"])], local_ba._only)
                B = Hin + F.pad(Dk6, (0, 9, 0, 9))
                damp = torch.diag_embed(
                    lam * (1.0 + torch.diagonal(B, dim1=1, dim2=2)) + 1e-8)
                Dm = Hin + F.pad(Hpp6, (0, 9, 0, 9)) + damp
                fd = free_dims
                Pk = ((B + damp) * fd[:, :, None] * fd[:, None, :]
                      + torch.diag_embed(1.0 - fd))
                grad = g15 + F.pad(g6, (0, 9))
                dx = _vi_schur_pcg(Dm, U, nxt, inv_nan(Pk), -grad * fd,
                                   Hll_inv,
                                   Eob, obs_pose, obs_lm, fixed, fd, n_cg,
                                   [(plan["pose"], plan["lm"])], pcg_index,
                                   E_planes)
            else:
                Wc = torch.zeros((K, M, 6, 3), dtype=dtype, device=dev)
                put_add_(Wc, (obs_pose, obs_lm), Eob, plan["W"])
                Wi = torch.einsum("kmab,mbc->kmac", Wc, Hll_inv)
                corr = torch.einsum("kmac,lmbc->kalb", Wi, Wc).reshape(
                    6 * K, 6 * K)
                rhs_corr = torch.einsum("kmab,mb->ka", Wi, bl).reshape(-1)
                blk = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
                ar = torch.arange(K, device=dev)
                blk[ar, :, ar, :] = Hpp6
                put_add_(Hd, pose_pairs,
                         (blk.reshape(6 * K, 6 * K) - corr).reshape(-1),
                         plan["pose_H"])
                put_add_(bvec, (pose_dims,), bp6.reshape(-1) - rhs_corr,
                         plan["pose_b"])
                Hd = Hd + torch.diag(lam * (1.0 + torch.diagonal(Hd)) + 1e-8)

                # Freeze fixed dims: identity rows and columns.
                Hd = (Hd * (1 - fixd)[:, None] * (1 - fixd)[None, :]
                      + torch.diag(fixd))
                bvec = bvec * (1 - fixd)
                dx = -solve_nan(Hd, bvec).reshape(K, 15)

        with TIMERS.stage("viba/update"):
            if pcg:
                Wtdx = segment_sum(M, obs_lm, torch.einsum(
                    "nab,na->nb", Eob, dx[:, :6][obs_pose]), plan["lm"])
            else:
                Wtdx = torch.einsum("kmab,ka->mb", Wc, dx[:, :6])
            dl = -torch.einsum("mab,mb->ma", Hll_inv, bl + Wtdx)

            # Apply, accept or reject.
            # The PCG assembly queues its whole LM step without a host sync
            # (normalize_rotation's SVD would wait for the card).
            R_new = (orthonormalize if pcg else normalize_rotation)(
                R_all @ exp_so3(dx[:, 0:3]))
            p_new = p_all + dx[:, 3:6]
            v_new = v_all + dx[:, 6:9]
            b_new = b_all + dx[:, 9:15]
            X_new = X_all + dl * lm_mask[:, None]
            cost_new = full_cost(R_new, p_new, v_new, b_new, X_new)
            accept = cost_new < cost
            R_all = torch.where(accept, R_new, R_all)
            p_all = torch.where(accept, p_new, p_all)
            v_all = torch.where(accept, v_new, v_all)
            b_all = torch.where(accept, b_new, b_all)
            X_all = torch.where(accept, X_new, X_all)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 5.0, max=1e4))
            cost = torch.where(accept, cost_new, cost)
    if lin is not None:
        chi2_f = cuda_reproj.cost(lin, R_all, p_all, X_all, chi2=True)[1]
    else:
        r_v = vis_terms(R_all, p_all, X_all, False)[0]
        chi2_f = torch.sum(r_v * r_v, -1) * inv_sigma2
    return R_all, p_all, v_all, b_all, X_all, chi2_f, cost
