"""Plain reference of the loop closer's full inertial BA
(``Optimizer::FullInertialBA(pMap, 7, false, ...)``, ``Optimizer.cc:393``,
as ``LoopClosing::RunGlobalBundleAdjustment`` calls it on an
IMU-initialised map): Levenberg-Marquardt over every keyframe's body state
[R_wb, p_wb, v_wb, bg, ba] and every landmark, landmarks eliminated per
landmark by the Schur complement, the reduced system over the 15-wide
states solved by block-Jacobi preconditioned conjugate gradients; then the
loop closer's culling.

Its pieces, written here from the published equations:

- the preintegration of each interval between consecutive keyframes at
  the first keyframe's bias (``ImuTypes.cc`` ``IntegrateNewMeasurement``:
  the deltas, the 15x15 covariance through A and B plus the bias walk, the
  five bias Jacobians), and the first-order bias correction
  (``GetDeltaRotation/Velocity/Position``);
- ``EdgeInertial`` (``G2oTypes.cc:514-560``): the 9-D residual
  [Log(dR(b)^T R1^T R2), R1^T (v2 - v1 - g dt) - dV(b), R1^T (p2 - p1 -
  v1 dt - g dt^2 / 2) - dP(b)] at the first keyframe's bias, information
  the inverse of the interval's 9x9 covariance, Huber with delta^2 = 16.92
  (``Optimizer.cc:543``), its Jacobians in closed form;
- ``EdgeGyroRW`` / ``EdgeAccRW``: b_j - b_i with the interval's walk
  information, no robust kernel;
- the stereo reprojection edge of ``lm_schur`` (pinhole, the right-image
  row, information 1.2^(-2 level), Huber at the chi2 gate) on the camera
  T_cb T_bw;
- the gauge of the port's full inertial BA: the oldest keyframe's pose
  fixed, its velocity and biases free.

Departures from FullInertialBA, each as the port's solver has it (the
reference package's LM form of the g2o solve, as ``lm_schur`` follows the
visual one): LM with lambda from 1e-4, halved on an accepted step and
multiplied by 5 on a rejected one, within [1e-7, 1e4]; the landmarks'
3x3 blocks damped by lambda (1 + diag), the reduced system's diagonal by
lambda (1 + diag) + 1e-8 after the landmarks' elimination; 60 PCG
iterations an LM step (g2o solves exactly); a state's update is R_wb
Exp(dphi), p_wb + dp (in the world frame; g2o's VertexPose moves p in the
body frame), v + dv, b + db; the edge information is inv(C9 + 1e-8 I)
(the port whitens with that floor); the delta rotation is normalised once
per interval, not per sample; no priors on the biases (non-init mode) and
no marginalisation.

Sums are plain ``index_add_``; ``dtype`` sets the arithmetic: float64 for
the reference, bfloat16 for the control (whose 3x3, 9x9 and 15x15
inverses run in float32 and are rounded back).
"""

import torch

from portbench.reference.lm_schur import (CHI2_MONO, CHI2_STEREO, _hat,
                                          _inv, _sum)

CHI2_INERTIAL = 16.92
GRAVITY = (0.0, 0.0, -9.81)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def exp_so3(w):
    th2 = torch.sum(w * w, -1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    W = _hat(w)
    I = _eye(3, w).expand(W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    th = torch.acos(c)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-4
    s = torch.sin(th)
    k = torch.where(small, 0.5 + th * th / 12,
                    th / (2 * torch.where(small, torch.ones_like(s), s)))
    return k[..., None] * v


def _jr(w, inverse=False):
    """Right Jacobian of SO(3) at w, or its inverse."""
    th2 = torch.sum(w * w, -1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    W = _hat(w)
    I = _eye(3, w).expand(W.shape)
    if inverse:
        b = torch.where(small, 1.0 / 12 + th2 / 720,
                        1 / (th * th) - (1 + torch.cos(th))
                        / (2 * th * torch.sin(th)))
        return I + 0.5 * W + b[..., None, None] * (W @ W)
    a = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    b = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (
        th * th * th))
    return I - a[..., None, None] * W + b[..., None, None] * (W @ W)


def preintegrate(rows, bias, ng, na, wg, wa):
    """ImuTypes.cc over E intervals of n samples each: rows (E, n, 7) [dt,
    acc, gyro], bias (E, 6) [bg, ba]; ng, na, wg, wa the per-sample white
    noise and walk sigmas.  Returns dict(dT, dR, dV, dP, C (E, 15, 15)
    over [phi, v, p, bg, ba], JRg, JVg, JVa, JPg, JPa, bias)."""
    E, n, _ = rows.shape
    f = dict(dtype=rows.dtype, device=rows.device)
    I3 = torch.eye(3, **f).expand(E, 3, 3)
    Z3 = torch.zeros((E, 3, 3), **f)
    dR, dV, dP = I3.clone(), torch.zeros((E, 3), **f), torch.zeros((E, 3),
                                                                     **f)
    JRg, JVg, JVa, JPg, JPa = Z3, Z3, Z3, Z3, Z3
    C = torch.zeros((E, 15, 15), **f)
    dT = torch.zeros(E, **f)
    Nga = torch.diag(torch.tensor([ng * ng] * 3 + [na * na] * 3, **f))
    walk = torch.diag(torch.tensor([wg * wg] * 3 + [wa * wa] * 3, **f))
    bg, ba = bias[:, :3], bias[:, 3:]
    for s in range(n):
        dt = rows[:, s, 0][:, None]
        d3 = dt[..., None]
        acc = rows[:, s, 1:4] - ba
        w = rows[:, s, 4:7] - bg
        Ra = torch.einsum("eij,ej->ei", dR, acc)
        dP = dP + dV * dt + 0.5 * Ra * dt * dt
        dV = dV + Ra * dt
        Wa = _hat(acc)
        A = torch.eye(9, **f).repeat(E, 1, 1)
        A[:, 3:6, 0:3] = -dR @ Wa * d3
        A[:, 6:9, 0:3] = -0.5 * dR @ Wa * d3 * d3
        A[:, 6:9, 3:6] = I3 * d3
        B = torch.zeros((E, 9, 6), **f)
        B[:, 3:6, 3:6] = dR * d3
        B[:, 6:9, 3:6] = 0.5 * dR * d3 * d3
        JPa = JPa + JVa * d3 - 0.5 * dR * d3 * d3
        JPg = JPg + JVg * d3 - 0.5 * dR @ Wa @ JRg * d3 * d3
        JVa = JVa - dR * d3
        JVg = JVg - dR @ Wa @ JRg * d3
        dRi = exp_so3(w * dt)
        Jr = _jr(w * dt)
        dR = dR @ dRi
        A[:, 0:3, 0:3] = dRi.transpose(1, 2)
        B[:, 0:3, 0:3] = Jr * d3
        C9 = A @ C[:, :9, :9] @ A.transpose(1, 2) + B @ Nga @ B.transpose(
            1, 2)
        C = C.clone()
        C[:, :9, :9] = C9
        C[:, 9:, 9:] = C[:, 9:, 9:] + walk
        JRg = dRi.transpose(1, 2) @ JRg - Jr * d3
        dT = dT + dt[:, 0]
    # Normalised once (ImuTypes.cc normalises after every sample).
    U_, _, Vh = torch.linalg.svd(dR.double())
    dR = (U_ @ Vh).to(rows.dtype)
    return dict(dT=dT, dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa,
                JPg=JPg, JPa=JPa, bias=bias)


def _corrected(pre, b):
    db = b - pre["bias"]
    dbg, dba = db[:, :3], db[:, 3:]
    mv = lambda M, v: torch.einsum("eij,ej->ei", M, v)  # noqa: E731
    jg = mv(pre["JRg"], dbg)
    dR = pre["dR"] @ exp_so3(jg)
    dV = pre["dV"] + mv(pre["JVg"], dbg) + mv(pre["JVa"], dba)
    dP = pre["dP"] + mv(pre["JPg"], dbg) + mv(pre["JPa"], dba)
    return dR, dV, dP, jg


def inertial_edge(pre, R1, p1, v1, R2, p2, v2, b1, g, jacobian=True):
    """EdgeInertial: residual (E, 9) [e_R, e_v, e_p] and its Jacobian
    (E, 9, 24) over [phi_1, p_1, v_1, bg_1, ba_1, phi_2, p_2, v_2] (right
    rotation increments, world-frame position increments)."""
    dR, dV, dP, jg = _corrected(pre, b1)
    dt = pre["dT"][:, None]
    R1t = R1.transpose(1, 2)
    Er = dR.transpose(1, 2) @ R1t @ R2
    eR = log_so3(Er)
    a = torch.einsum("eij,ej->ei", R1t, v2 - v1 - g * dt)
    c = torch.einsum("eij,ej->ei", R1t, p2 - p1 - v1 * dt - 0.5 * g * dt * dt)
    r = torch.cat([eR, a - dV, c - dP], -1)
    if not jacobian:
        return r, None
    E = r.shape[0]
    J = torch.zeros((E, 9, 24), dtype=r.dtype, device=r.device)
    Ji = _jr(eR, inverse=True)
    J[:, 0:3, 0:3] = -Ji @ R2.transpose(1, 2) @ R1
    J[:, 0:3, 9:12] = -Ji @ Er.transpose(1, 2) @ _jr(jg) @ pre["JRg"]
    J[:, 0:3, 15:18] = Ji
    J[:, 3:6, 0:3] = _hat(a)
    J[:, 3:6, 6:9] = -R1t
    J[:, 3:6, 9:12] = -pre["JVg"]
    J[:, 3:6, 12:15] = -pre["JVa"]
    J[:, 3:6, 21:24] = R1t
    J[:, 6:9, 0:3] = _hat(c)
    J[:, 6:9, 3:6] = -R1t
    J[:, 6:9, 6:9] = -R1t * dt[..., None]
    J[:, 6:9, 9:12] = -pre["JPg"]
    J[:, 6:9, 12:15] = -pre["JPa"]
    J[:, 6:9, 18:21] = R1t
    return r, J


def _huber(chi2, d2):
    d = d2 ** 0.5
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w = torch.where(s <= d, torch.ones_like(s), d / s)
    rho = torch.where(chi2 <= d2, chi2, 2 * d * s - d2)
    return w, rho


def solve(Rwb, pwb, v, b, fixed, fixed_vb, X, op, ol, uv, level, ur, R_cb,
          t_cb, intr, bf, ei, ej, rows, imu_sigmas, n_iters=7, n_cg=60,
          init_lambda=1e-4, dtype=torch.float64):
    """The full inertial BA of the snapshot.  Body states Rwb (K, 3, 3),
    pwb, v (K, 3), b (K, 6); fixed (K,) 1 = frozen pose, fixed_vb (K,) 1 =
    frozen velocity and biases; the stereo observations as ``lm_schur``
    takes them; R_cb, t_cb the camera <- body extrinsic; chain edges ei ->
    ej (E,) with their IMU rows (E, n, 7), preintegrated at state ei's
    bias; imu_sigmas = (ng, na, wg, wa) per sample.  Returns (Rwb, pwb, v,
    b, X, chi2 per observation) as numpy float64."""
    dev = Rwb.device
    f = dict(dtype=dtype, device=dev)
    Rwb, pwb, v, b, fixed, fixed_vb, X, uv, ur, R_cb, t_cb, rows = (
        a.to(dtype) for a in (Rwb, pwb, v, b, fixed, fixed_vb, X, uv, ur,
                              R_cb, t_cb, rows))
    op, ol, ei, ej = op.long(), ol.long(), ei.long(), ej.long()
    K, M, E = Rwb.shape[0], X.shape[0], ei.shape[0]
    fx, fy, cx, cy = intr
    bf = torch.tensor(bf, **f)
    g = torch.tensor(GRAVITY, **f)
    info = torch.pow(torch.tensor(1.2, **f), -2.0 * level.to(dtype))
    has_ur = (ur >= 0).to(dtype)
    gate = torch.where(ur >= 0, torch.tensor(CHI2_STEREO, **f),
                       torch.tensor(CHI2_MONO, **f))

    pre = preintegrate(rows, b[ei], *imu_sigmas)
    C9 = pre["C"][:, :9, :9] + 1e-8 * torch.eye(9, **f)
    Om = _inv(C9)
    w_rw2 = 1.0 / torch.clamp(torch.diagonal(pre["C"], dim1=1, dim2=2)[:, 9:],
                              min=1e-14)

    def vis(Rwb, pwb, X):
        Rbw = Rwb.transpose(1, 2)
        q = torch.einsum("oij,oj->oi", Rbw[op], X[ol] - pwb[op])
        pc = q @ R_cb.T + t_cb
        z = torch.clamp(pc[:, 2], min=1e-6)
        u = fx * pc[:, 0] / z + cx
        vv = fy * pc[:, 1] / z + cy
        r3 = (u - bf / z - ur) * has_ur
        r = torch.stack([u - uv[:, 0], vv - uv[:, 1], r3], -1)
        zero = torch.zeros_like(z)
        Ju = torch.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], -1)
        Jv = torch.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], -1)
        J3 = (Ju + torch.stack([zero, zero, bf / (z * z)], -1)) * has_ur[:,
                                                                         None]
        Jp = torch.stack([Ju, Jv, J3], -2)                   # (O, 3, 3)
        RcRbw = R_cb @ Rbw[op]
        J_pose = torch.cat([Jp @ R_cb @ _hat(q), -Jp @ RcRbw], -1)
        J_X = Jp @ RcRbw
        chi2 = torch.sum(r * r, -1) * info
        valid = (pc[:, 2] > 1e-3).to(dtype)
        w, rho = _huber(chi2, gate)
        return r, J_pose, J_X, w * info * valid, chi2, torch.sum(rho * valid)

    def inertial(Rwb, pwb, v, b, jacobian=True):
        r, J = inertial_edge(pre, Rwb[ei], pwb[ei], v[ei], Rwb[ej], pwb[ej],
                             v[ej], b[ei], g, jacobian)
        chi2 = torch.einsum("ei,eij,ej->e", r, Om, r)
        w, rho = _huber(chi2, torch.tensor(CHI2_INERTIAL, **f))
        r_rw = b[ej] - b[ei]
        c_rw = torch.sum(r_rw * r_rw * w_rw2, -1)
        return r, J, w, torch.sum(rho) + torch.sum(c_rw), r_rw

    def cost_of(Rwb, pwb, v, b, X):
        return vis(Rwb, pwb, X)[5] + inertial(Rwb, pwb, v, b, False)[3]

    freeK = (1.0 - fixed)
    fd = torch.cat([freeK[:, None].expand(K, 6),
                    (1.0 - fixed_vb)[:, None].expand(K, 9)], 1)
    eye3, eye15 = torch.eye(3, **f), torch.eye(15, **f)
    lam = torch.tensor(init_lambda, **f)
    cost = cost_of(Rwb, pwb, v, b, X)
    for _ in range(n_iters):
        r, Jc, Jl, w, _, _ = vis(Rwb, pwb, X)
        Jc = Jc * freeK[op][:, None, None]
        Hpp = _sum(K, op, torch.einsum("nia,n,nib->nab", Jc, w, Jc))
        bp = _sum(K, op, torch.einsum("nia,n,ni->na", Jc, w, r))
        Hll = _sum(M, ol, torch.einsum("nia,n,nib->nab", Jl, w, Jl))
        bl = _sum(M, ol, torch.einsum("nia,n,ni->na", Jl, w, r))
        Ew = torch.einsum("nia,n,nib->nab", Jc, w, Jl)       # (O, 6, 3)

        # Inertial and random-walk edges, as blocks of the 15-wide states.
        ri, Ji, wi, _, r_rw = inertial(Rwb, pwb, v, b)
        Oi = Om * wi[:, None, None]
        He = Ji.transpose(1, 2) @ Oi @ Ji                    # (E, 24, 24)
        ge = torch.einsum("eia,eij,ej->ea", Ji, Oi, ri)
        H = torch.zeros((E, 30, 30), **f)                    # [i 15 | j 15]
        gE = torch.zeros((E, 30), **f)
        cols = list(range(15)) + list(range(15, 24))
        idx = torch.tensor(cols, device=dev)
        H[:, idx[:, None], idx[None, :]] = He
        gE[:, idx] = ge
        rw = torch.diag_embed(w_rw2)
        H[:, 9:15, 9:15] += rw
        H[:, 24:30, 24:30] += rw
        H[:, 9:15, 24:30] -= rw
        H[:, 24:30, 9:15] -= rw
        gE[:, 9:15] -= w_rw2 * r_rw
        gE[:, 24:30] += w_rw2 * r_rw
        Hin = _sum(K, ei, H[:, :15, :15]) + _sum(K, ej, H[:, 15:, 15:])
        gin = _sum(K, ei, gE[:, :15]) + _sum(K, ej, gE[:, 15:])
        Hij = H[:, :15, 15:]                                 # A[ei, ej]

        # Landmarks eliminated; the reduced system's blocks.
        Hll_d = Hll + lam * (eye3 + eye3 * Hll)
        Hli = _inv(Hll_d)
        Y = torch.einsum("nab,nbc->nac", Ew, Hli[ol])
        g6 = bp - _sum(K, op, torch.einsum("nab,nb->na", Y, bl[ol]))
        Dk6 = Hpp - _sum(K, op, torch.einsum("nab,ncb->nac", Y, Ew))
        Bk = Hin.clone()
        Bk[:, :6, :6] += Dk6
        damp = torch.diag_embed(lam * (1 + torch.diagonal(Bk, dim1=1, dim2=2))
                                + 1e-8)
        Dm = Hin.clone()
        Dm[:, :6, :6] += Hpp
        Dm = Dm + damp
        P = ((Bk + damp) * fd[:, :, None] * fd[:, None, :]
             + torch.diag_embed(1 - fd))
        Minv = _inv(P)
        gk = gin.clone()
        gk[:, :6] += g6
        rhs = -gk * fd

        def matvec(x):
            x = x * fd
            u = torch.einsum("kab,kb->ka", Dm, x)
            u = u.index_add(0, ei, torch.einsum("eab,eb->ea", Hij, x[ej]))
            u = u.index_add(0, ej, torch.einsum("eba,eb->ea", Hij, x[ei]))
            tv = _sum(M, ol, torch.einsum("nab,na->nb", Ew, x[op, :6]))
            zl = torch.einsum("mab,mb->ma", Hli, tv)
            u2 = _sum(K, op, torch.einsum("nab,nb->na", Ew, zl[ol]))
            u = torch.cat([u[:, :6] - u2, u[:, 6:]], 1)
            return u * fd

        dx = torch.zeros((K, 15), **f)
        res = rhs
        zv = torch.einsum("kab,kb->ka", Minv, res)
        pv = zv
        rz = torch.sum(res * zv)
        zero = torch.zeros((), **f)
        for _ in range(n_cg):
            Ap = matvec(pv)
            den = torch.sum(pv * Ap)
            alpha = torch.where(torch.abs(den) > 1e-20, rz / den, zero)
            dx = dx + alpha * pv
            res = res - alpha * Ap
            zv = torch.einsum("kab,kb->ka", Minv, res)
            rz_new = torch.sum(res * zv)
            beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
            pv = zv + beta * pv
            rz = rz_new
        Wtdx = _sum(M, ol, torch.einsum("nab,na->nb", Ew, dx[op, :6]))
        dl = -torch.einsum("mab,mb->ma", Hli, bl + Wtdx)
        R_n = Rwb @ exp_so3(dx[:, 0:3])
        p_n, v_n, b_n = pwb + dx[:, 3:6], v + dx[:, 6:9], b + dx[:, 9:15]
        X_n = X + dl
        cost_new = cost_of(R_n, p_n, v_n, b_n, X_n)
        ok = cost_new < cost
        Rwb = torch.where(ok, R_n, Rwb)
        pwb = torch.where(ok, p_n, pwb)
        v = torch.where(ok, v_n, v)
        b = torch.where(ok, b_n, b)
        X = torch.where(ok, X_n, X)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(ok, cost_new, cost)
    chi2 = vis(Rwb, pwb, X)[4]
    return tuple(a.double().cpu().numpy() for a in (Rwb, pwb, v, b, X, chi2))


def body_to_camera(Rwb, pwb, R_cb, t_cb):
    """Camera poses (R_cw, t_cw) numpy of body states through T_cb."""
    R_cw = R_cb @ Rwb.transpose(0, 2, 1)
    return R_cw, t_cb - (R_cw @ pwb[..., None])[..., 0]


def camera_to_body(R_cw, t_cw, R_bc, t_bc):
    """Body states (R_wb, p_wb) numpy of camera poses through T_bc."""
    R_wb = (R_bc @ R_cw).transpose(0, 2, 1)
    p_wb = -(R_wb @ ((R_bc @ t_cw[..., None])[..., 0] + t_bc)[..., None])[..., 0]
    return R_wb, p_wb
