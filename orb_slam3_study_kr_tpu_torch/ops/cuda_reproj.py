"""K5: the global BA's reprojection pass (``csrc/reproj_lin.cu``).

One launch linearizes every observation of a bundle adjustment (camera
point, pinhole projection, the stereo third row, cheirality, chi2, the
Huber weight, the Jacobians) and sums the normal equations' blocks Hpp,
bp, Hll, bl with the cross blocks E, written in observation order and as
K4's landmark-sorted planes (``ops/cuda_schur.landmark_planes``); the
cost pass gives the Huber cost as a device scalar and, when asked, each
observation's chi2.  It serves ``solvers/local_ba.bundle_adjust`` (the
left-multiplicative T_cw) and ``solvers/inertial_ba.inertial_bundle_adjust``
(the body state through the rig's extrinsic), on one-shard CUDA solves of
the PCG assembly with a zero-distortion pinhole camera (``takes``).

The kernel replaces no TPU kernel: the reference's linearization is plain
jnp.  It is bound by bytes: a pass reads each observation's 32-byte
record and writes its E twice (``linearize_bytes``), against about 20 ms
an LM step as PyTorch's batched products at the long map's size.

``linearize_plain`` and ``cost_plain`` are the kernel's plain twin: one
PyTorch operation for each of the kernel's rounded steps, the sums in the
kernel's order (a landmark's 8 lanes and their shuffle tree, a pose
block's 256 threads, its warps' trees and the warps in order), so on any
device they give the kernel's bits.  ``linearize`` and ``cost`` run the
twin on the CPU and the kernel on the card.
"""

from collections import namedtuple

import torch

from orb_slam3_study_kr_tpu_torch.cameras.camera import CameraKind
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS as TIMERS

G = 8              # lanes a landmark
THREADS = 256      # a block's threads
REC = 8            # a record: u, v, ur, inv_sigma2, mask, pose, lm, obs
NCAM = 21          # fx fy cx cy bf, gates (mono, stereo), deltas, R_cb, t_cb

Reproj = namedtuple("Reproj", "cam rec index lm_mask free body huber E "
                    "E_planes part counter")
Reproj.__doc__ = """A solve's K5 state, built once by ``setup``: the
camera block ``cam`` (21,), the landmark-sorted records ``rec`` (O, 8),
the solve's ``cuda_schur.SchurIndex``, ``lm_mask`` (M,), ``free`` (K,) 1 -
fixed, the parametrisation (``body``), the Huber kernel (``huber``), the
buffers E (O, 6, 3) (zero at the masked observations, which no pass
writes) and E_planes (18, O), and the cost's scratch."""


def _card(dev):
    return dev.type == "cuda"


def takes(camera, dev, assembly, wide_fov=False):
    """Whether a solve on ``dev`` takes K5: the PCG assembly of one shard on
    the card, with a pinhole ``camera`` of zero distortion (the BA's ideal
    camera); KB8, a distorted pinhole, the dense assembly, the CPU and the
    sharded solve keep the solvers' einsum pass.  Reads the camera's
    distortion from the card once."""
    return (assembly == "pcg" and _card(dev) and camera is not None
            and camera.kind == CameraKind.PINHOLE and not wide_fov
            and not bool(torch.any(camera.params[4:] != 0)))


def _camera_block(camera, dtype, dev, bf=None, extrinsic=None):
    """The kernel's camera block (21,) on ``dev``: fx, fy, cx, cy, bf (0
    without), the mono and stereo chi2 gates and their square roots as the
    solvers compute them, R_cb row-major and t_cb (identity and 0 without
    ``extrinsic``)."""
    gates = torch.tensor([robust.CHI2_MONO, robust.CHI2_STEREO], dtype=dtype,
                         device=dev)
    if extrinsic is None:
        R_cb = torch.eye(3, dtype=dtype, device=dev)
        t_cb = torch.zeros(3, dtype=dtype, device=dev)
    else:
        R_cb, t_cb = extrinsic
    return torch.cat([
        camera.params[:4].to(dev, dtype),
        torch.tensor([0.0 if bf is None else float(bf)], dtype=dtype,
                     device=dev),
        gates, torch.sqrt(gates), R_cb.reshape(9).to(dev, dtype),
        t_cb.reshape(3).to(dev, dtype)])


def _records(index, obs_pose, obs_lm, obs_uv, inv_sigma2, obs_mask,
            obs_ur=None, dtype=torch.float32):
    """(O, 8) records in the landmark-sorted order of ``index``: u, v, ur
    (-1: mono), inv_sigma2, mask, then pose, landmark and observation
    index as the integer bits of the record's type."""
    perm = index.lm_perm
    O = perm.numel()
    rec = torch.empty((O, REC), dtype=dtype, device=perm.device)
    rec[:, 0:2] = obs_uv[perm]
    rec[:, 2] = -1.0 if obs_ur is None else obs_ur[perm]
    rec[:, 3] = inv_sigma2[perm]
    rec[:, 4] = obs_mask[perm]
    bits = rec.view(torch.int32 if dtype == torch.float32 else torch.int64)
    bits[:, 5] = obs_pose[perm]
    bits[:, 6] = obs_lm[perm]
    bits[:, 7] = perm
    return rec


def setup(camera, index, obs_pose, obs_lm, obs_uv, inv_sigma2, obs_mask,
          lm_mask, fixed, obs_ur=None, bf=None, extrinsic=None,
          use_huber=True):
    """The solve's ``Reproj``, in the dtype and on the device of lm_mask.
    ``extrinsic`` (R_cb, t_cb): the body parametrisation."""
    dt, dev = lm_mask.dtype, lm_mask.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"reproj: unsupported dtype {dt}")
    O = obs_lm.numel()
    if O >= 2 ** 31:
        raise ValueError(f"reproj: {O} observations do not fit int32")
    nb = max(1, -(-O // THREADS))
    return Reproj(
        cam=_camera_block(camera, dt, dev, bf, extrinsic),
        rec=_records(index, obs_pose, obs_lm, obs_uv, inv_sigma2, obs_mask,
                    obs_ur, dt),
        index=index, lm_mask=lm_mask.contiguous(),
        free=(1.0 - fixed).to(dt).contiguous(), body=extrinsic is not None,
        huber=bool(use_huber),
        E=torch.zeros((O, 6, 3), dtype=dt, device=dev),
        E_planes=torch.empty((18, O), dtype=dt, device=dev),
        part=torch.empty(nb, dtype=dt, device=dev),
        counter=torch.zeros(1, dtype=torch.int32, device=dev))


def linearize_bytes(K, M, O, itemsize=4):
    """The bytes a linearize pass must move at K poses, M landmarks and O
    observations, each input read once and each output written once: the
    records, pose_pos and the offsets, the landmarks and their masks, the
    poses and their free flags; E in both layouts, Hll, bl, Hpp and bp."""
    reads = (O * (REC * itemsize + 4) + (M + 1 + K + 1) * 4
             + M * 4 * itemsize + K * 13 * itemsize + NCAM * itemsize)
    writes = (2 * O * 18 + M * 12 + K * 42) * itemsize
    return reads + writes


def cost_bytes(K, M, O, itemsize=4):
    """The bytes of a cost pass that writes chi2: the records, the
    landmarks and their masks, the poses; chi2."""
    return (O * (REC + 1) * itemsize + M * 4 * itemsize + K * 12 * itemsize
            + NCAM * itemsize)


def _check(s, R, t, X):
    K, M = s.free.shape[0], s.lm_mask.shape[0]
    for name, a, shape in (("R", R, (K, 3, 3)), ("t", t, (K, 3)),
                           ("X", X, (M, 3))):
        if tuple(a.shape) != shape or a.dtype != s.rec.dtype:
            raise ValueError(f"reproj: {name} is {a.dtype} {tuple(a.shape)}, "
                             f"expected {s.rec.dtype} {shape}")
        if a.device != s.rec.device:
            raise ValueError(f"reproj: {name} on {a.device}, expected "
                             f"{s.rec.device}")


def linearize(s, R, t, X):
    """(Hpp (K, 6, 6), bp (K, 6), Hll (M, 3, 3), bl (M, 3), E (O, 6, 3),
    E_planes (18, O)) of the poses (R, t) (R_cw, t_cw; body: R_wb, p_wb)
    and landmarks X: the solvers' Gauss-Newton blocks of every live
    observation, E_planes at the live positions of the landmark-sorted
    order.  E and E_planes are the state's buffers, rewritten by the next
    pass."""
    _check(s, R, t, X)
    TIMERS.count("k5/linearize")
    K, M, O = s.free.shape[0], s.lm_mask.shape[0], s.rec.shape[0]
    ix = s.index
    if s.rec.device.type != "cuda":
        Hpp, bp, Hll, bl, E, Ep = linearize_plain(
            s.cam, s.rec, ix.lm_off, ix.pose_pos, ix.pose_off, R, t, X,
            s.lm_mask, s.free, s.body, s.huber)
        s.E.copy_(E)
        s.E_planes.copy_(Ep)
        return Hpp, bp, Hll, bl, s.E, s.E_planes
    dt, dev = s.rec.dtype, s.rec.device
    Hpp = torch.empty((K, 6, 6), dtype=dt, device=dev)
    bp = torch.empty((K, 6), dtype=dt, device=dev)
    Hll = torch.empty((M, 3, 3), dtype=dt, device=dev)
    bl = torch.empty((M, 3), dtype=dt, device=dev)
    R, t, X = R.contiguous(), t.contiguous(), X.contiguous()
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("schur_pcg")
    fn = (lib.reproj_linearize_f32 if dt == torch.float32
          else lib.reproj_linearize_f64)
    with torch.cuda.device(dev):
        err = fn(*[a.data_ptr() for a in (
            s.cam, s.rec, ix.lm_off, ix.pose_pos, ix.pose_off, R, t, X,
            s.lm_mask, s.free, Hpp, bp, Hll, bl, s.E, s.E_planes)],
            K, M, O, int(s.body), int(s.huber),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "reproj_linearize")
    cuda_lib.count_launch(linearize)
    return Hpp, bp, Hll, bl, s.E, s.E_planes


def cost(s, R, t, X, chi2=False):
    """The visual cost (a 0-dim tensor): the sum of huber_rho(chi2) times
    each observation's validity (chi2 times it without Huber), in the
    kernel's fixed order; with ``chi2`` also (cost, chi2 (O,)), each
    observation's chi2 in observation order."""
    _check(s, R, t, X)
    TIMERS.count("k5/cost")
    if s.rec.device.type != "cuda":
        c, x2 = cost_plain(s.cam, s.rec, R, t, X, s.lm_mask, s.body, s.huber)
        return (c, x2) if chi2 else c
    dt, dev = s.rec.dtype, s.rec.device
    O = s.rec.shape[0]
    out = torch.empty(1, dtype=dt, device=dev)
    x2 = torch.empty(O, dtype=dt, device=dev) if chi2 else None
    R, t, X = R.contiguous(), t.contiguous(), X.contiguous()
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("schur_pcg")
    fn = lib.reproj_cost_f32 if dt == torch.float32 else lib.reproj_cost_f64
    with torch.cuda.device(dev):
        err = fn(s.cam.data_ptr(), s.rec.data_ptr(), R.data_ptr(),
                 t.data_ptr(), X.data_ptr(), s.lm_mask.data_ptr(),
                 None if x2 is None else x2.data_ptr(), s.part.data_ptr(),
                 out.data_ptr(), s.counter.data_ptr(), O, int(s.body),
                 int(s.huber), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "reproj_cost")
    cuda_lib.count_launch(cost)
    c = out.reshape(())
    return (c, x2) if chi2 else c


linearize.launches = 0
cost.launches = 0

# ---------------------------------------------------------------------------
# The plain twin: the kernel's steps as PyTorch operations, in its order.


def _dot3(a0, b0, a1, b1, a2, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def _unpack(rec):
    bits = rec.view(torch.int32 if rec.dtype == torch.float32
                    else torch.int64)
    return (rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3], rec[:, 4],
            bits[:, 5].long(), bits[:, 6].long(), bits[:, 7].long())


def _residual(cam, R, t, X, u_o, v_o, ur_o, isig, mask, lmk, body):
    """The kernel's ``residual`` over rows of observations: R (n, 9), t
    (n, 3), X (n, 3).  Returns a dict of its fields."""
    one = torch.ones((), dtype=cam.dtype, device=cam.device)
    zero = torch.zeros((), dtype=cam.dtype, device=cam.device)
    s = {}
    if body:
        d = [X[:, j] - t[:, j] for j in range(3)]
        q = [_dot3(R[:, i], d[0], R[:, 3 + i], d[1], R[:, 6 + i], d[2])
             for i in range(3)]
        p = [_dot3(cam[9 + 3 * i], q[0], cam[10 + 3 * i], q[1],
                   cam[11 + 3 * i], q[2]) + cam[18 + i] for i in range(3)]
        s["q"] = q
    else:
        p = [_dot3(R[:, 3 * i], X[:, 0], R[:, 3 * i + 1], X[:, 1],
                   R[:, 3 * i + 2], X[:, 2]) + t[:, i] for i in range(3)]
    z = torch.clamp(p[2], min=1e-6)
    u = cam[0] * (p[0] / z) + cam[2]
    v = cam[1] * (p[1] / z) + cam[3]
    stereo = ur_o >= 0
    h = torch.where(stereo, one, zero)
    r = [u - u_o, v - v_o, ((u - cam[4] / z) - ur_o) * h]
    s.update(p=p, z=z, h=h, r=r)
    s["chi2"] = _dot3(r[0], r[0], r[1], r[1], r[2], r[2]) * isig
    s["valid"] = (mask * lmk) * torch.where(p[2] > 1e-3, one, zero)
    s["gate"] = torch.where(stereo, cam[6], cam[5])
    s["delta"] = torch.where(stereo, cam[8], cam[7])
    return s


def _huber_r(chi2):
    return torch.sqrt(torch.clamp(chi2, min=1e-12))


def _weight(s, isig, huber):
    w = isig * s["valid"]
    if not huber:
        return w
    r = _huber_r(s["chi2"])
    return w * torch.where(r <= s["delta"], torch.ones_like(r),
                           s["delta"] / r)


def _cost_term(s, huber):
    rho = s["chi2"]
    if huber:
        rho = torch.where(s["chi2"] <= s["gate"], s["chi2"],
                          (2 * s["delta"]) * _huber_r(s["chi2"]) - s["gate"])
    return rho * s["valid"]


def _jacobians(s, cam, R, fr, body):
    """The kernel's ``jacobians``: Jp [i][a] (3 x 6 rows) and Jl [i][b]."""
    fx, fy, bf = cam[0], cam[1], cam[4]
    p, z, h = s["p"], s["z"], s["h"]
    zi = 1.0 / z
    zi2 = zi * zi
    zero = torch.zeros_like(z)
    c00 = fx * zi
    c02 = ((-fx) * p[0]) * zi2
    c = [[c00, zero, c02],
         [zero, fy * zi, ((-fy) * p[1]) * zi2],
         [c00 * h, zero, (c02 + bf / (z * z)) * h]]
    Jp, Jl = [], []
    if body:
        Rcb = [cam[9 + i] for i in range(9)]
        A = [[_dot3(Rcb[3 * a], R[:, 3 * b], Rcb[3 * a + 1], R[:, 3 * b + 1],
                    Rcb[3 * a + 2], R[:, 3 * b + 2]) for b in range(3)]
             for a in range(3)]
        q = s["q"]
        for i in range(3):
            ci = c[i]
            jl = [_dot3(ci[0], A[0][j], ci[1], A[1][j], ci[2], A[2][j])
                  for j in range(3)]
            d = [_dot3(ci[0], Rcb[j], ci[1], Rcb[3 + j], ci[2], Rcb[6 + j])
                 for j in range(3)]
            Jp.append([d[1] * q[2] - d[2] * q[1], d[2] * q[0] - d[0] * q[2],
                       d[0] * q[1] - d[1] * q[0]] + [-x for x in jl])
            Jl.append(jl)
    else:
        for i in range(3):
            ci = c[i]
            Jp.append([ci[2] * p[1] - ci[1] * p[2],
                       ci[0] * p[2] - ci[2] * p[0],
                       ci[1] * p[0] - ci[0] * p[1]] + list(ci))
            Jl.append([_dot3(ci[0], R[:, j], ci[1], R[:, 3 + j], ci[2],
                             R[:, 6 + j]) for j in range(3)])
    Jp = [[x * fr for x in row] for row in Jp]
    return Jp, Jl


def _terms(cam, rec, R, t, X, lm_mask, free, body, huber):
    """Every observation position's values, in the landmark-sorted order of
    the records: the pose sums' 27 (Hpp's upper triangle by rows, bp), the
    landmark sums' 9 (Hll 00 01 02 11 12 22, bl) and E's 18."""
    u_o, v_o, ur_o, isig, mask, pose, lm, _ = _unpack(rec)
    Rk = R.reshape(-1, 9)[pose]
    s = _residual(cam, Rk, t[pose], X[lm], u_o, v_o, ur_o, isig, mask,
                  lm_mask[lm], body)
    Jp, Jl = _jacobians(s, cam, Rk, free[pose], body)
    w = _weight(s, isig, huber)
    wr = [w * x for x in s["r"]]
    wJp = [[w * x for x in row] for row in Jp]
    wJl = [[w * x for x in row] for row in Jl]

    def dot(A, a, B, b):
        return _dot3(A[0][a], B[0][b], A[1][a], B[1][b], A[2][a], B[2][b])

    pose_v = ([dot(Jp, a, wJp, b) for a in range(6) for b in range(a, 6)]
              + [_dot3(Jp[0][a], wr[0], Jp[1][a], wr[1], Jp[2][a], wr[2])
                 for a in range(6)])
    lm_v = ([dot(Jl, a, wJl, b) for a in range(3) for b in range(a, 3)]
            + [_dot3(Jl[0][a], wr[0], Jl[1][a], wr[1], Jl[2][a], wr[2])
               for a in range(3)])
    E = [dot(Jp, a, wJl, b) for a in range(6) for b in range(3)]
    return (torch.stack(pose_v, 1), torch.stack(lm_v, 1), torch.stack(E, 1))


def _strided_sums(vals, off, width):
    """(S, width, C): run s's rows off[s]:off[s + 1] of vals (n, C), row j
    of a run summed in order into column j % width (the kernel's lanes or
    threads), each column starting from 0."""
    S = off.numel() - 1
    C = vals.shape[1]
    cnt = torch.diff(off.long())
    seg = torch.repeat_interleave(torch.arange(S, device=vals.device), cnt)
    n = seg.numel()
    rel = torch.arange(n, device=vals.device) - off[:-1].long()[seg]
    col, step = rel % width, rel // width
    acc = torch.zeros((S, width, C), dtype=vals.dtype, device=vals.device)
    for j in range(int(step.max()) + 1 if n else 0):
        sel = step == j
        upd = torch.zeros_like(acc)
        upd[seg[sel], col[sel]] = vals[:n][sel]
        acc = acc + upd
    return acc


def _halves(a, dim):
    """The shuffle tree: a's first half plus its second half along dim,
    until one entry is left."""
    while a.shape[dim] > 1:
        h = a.shape[dim] // 2
        a = a.narrow(dim, 0, h) + a.narrow(dim, h, h)
    return a.squeeze(dim)


def _block_sum(v):
    """The kernel's block_sum over v (..., 256, C): each warp's shuffle tree,
    then the 8 warps in order."""
    w = _halves(v.reshape(*v.shape[:-2], THREADS // 32, 32, v.shape[-1]), -2)
    s = w[..., 0, :]
    for i in range(1, THREADS // 32):
        s = s + w[..., i, :]
    return s


def linearize_plain(cam, rec, lm_off, pose_pos, pose_off, R, t, X, lm_mask,
                    free, body, huber):
    """The kernel's linearize pass in plain torch, in its order: (Hpp, bp,
    Hll, bl, E (O, 6, 3), E_planes (18, O)), E zero at the masked
    observations and E_planes at the masked positions."""
    K, M, O = free.shape[0], lm_mask.shape[0], rec.shape[0]
    L = int(lm_off[M])
    pose_v, lm_v, E = _terms(cam, rec[:L], R, t, X, lm_mask, free, body,
                             huber)
    ls = _halves(_strided_sums(lm_v, lm_off, G), 1)             # (M, 9)
    ps = _block_sum(_strided_sums(pose_v[pose_pos[:L].long()], pose_off,
                                  THREADS))                     # (K, 27)
    iu = torch.triu_indices(6, 6, device=rec.device)
    Hpp = torch.zeros((K, 6, 6), dtype=rec.dtype, device=rec.device)
    Hpp[:, iu[0], iu[1]] = ps[:, :21]
    Hpp[:, iu[1], iu[0]] = ps[:, :21]
    i3 = torch.triu_indices(3, 3, device=rec.device)
    Hll = torch.zeros((M, 3, 3), dtype=rec.dtype, device=rec.device)
    Hll[:, i3[0], i3[1]] = ls[:, :6]
    Hll[:, i3[1], i3[0]] = ls[:, :6]
    obs = _unpack(rec[:L])[7]
    E_obs = torch.zeros((O, 18), dtype=rec.dtype, device=rec.device)
    E_obs[obs] = E
    E_planes = torch.zeros((18, O), dtype=rec.dtype, device=rec.device)
    E_planes[:, :L] = E.t()
    return (Hpp, ps[:, 21:], Hll, ls[:, 6:], E_obs.reshape(O, 6, 3),
            E_planes)


def cost_plain(cam, rec, R, t, X, lm_mask, body, huber):
    """The kernel's cost pass in plain torch, in its order: (cost, chi2
    (O,) in observation order)."""
    O = rec.shape[0]
    u_o, v_o, ur_o, isig, mask, pose, lm, obs = _unpack(rec)
    s = _residual(cam, R.reshape(-1, 9)[pose], t[pose], X[lm], u_o, v_o,
                  ur_o, isig, mask, lm_mask[lm], body)
    nb = max(1, -(-O // THREADS))
    v = torch.zeros(nb * THREADS, dtype=rec.dtype, device=rec.device)
    v[:O] = _cost_term(s, huber)
    part = _block_sum(v.reshape(nb, THREADS, 1))[:, 0]
    run = -(-nb // THREADS)
    runs = torch.zeros(THREADS * run, dtype=rec.dtype, device=rec.device)
    runs[:nb] = part
    runs = runs.reshape(THREADS, run)
    acc = torch.zeros(THREADS, dtype=rec.dtype, device=rec.device)
    for j in range(run):
        acc = acc + runs[:, j]
    chi2 = torch.empty(O, dtype=rec.dtype, device=rec.device)
    chi2[obs] = s["chi2"]
    return _block_sum(acc.reshape(THREADS, 1))[0], chi2
