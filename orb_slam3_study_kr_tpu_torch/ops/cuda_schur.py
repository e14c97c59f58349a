"""K4: the global BA's block-Jacobi PCG loop (``csrc/schur_pcg.cu``).

``solvers/local_ba._schur_pcg`` takes this route for CUDA tensors of one
shard (``psum_fn is None``); the CPU and the landmark-sharded solve keep
the einsum and ``segment_sum`` loop there, which is the kernel's plain
version.  The kernel replaces no TPU kernel: the reference's PCG solve is
plain jnp.

The kernel takes the bipartite graph in two orders, built once per solve
from the observations' pose and landmark indices (``schur_index``, plain
torch on any device; masked observations kept out of both orders'
ranges), and the E blocks gathered once per LM step into
landmark-sorted order, as 18 planes of O values (``landmark_planes``).
``schur_matvec_plain`` computes the kernel's matvec from those arrays in
plain torch, landmark-major and then pose-major as the kernel does.

``vi_schur_pcg`` runs the same loop on the inertial BA's reduced system
(``solvers/inertial_ba``, the PCG assembly): 15-wide states whose pose
slice takes the visual matvec, with each state's 15x15 diagonal block and
its coupling to the next keyframe of the temporal chain; the kernels are
the visual ones instantiated at a state width of 15, and a pose sweep
that adds the chain's blocks; its plain twin is
``solvers/inertial_ba._vi_matvec`` under ``local_ba._pcg_plain``.  Both
loops have a float64 instance: a float64 solve on the card takes it, and
the checks against the plain loop in float64 hold the kernels to float64
rounding.
"""

from collections import namedtuple

import torch

SchurIndex = namedtuple("SchurIndex",
                        "lm_perm lm_off op_lm pose_pos pose_off")
SchurIndex.__doc__ = """The kernel's index arrays over O observations, of
which the first L = ``lm_off[M]`` = ``pose_off[K]`` positions are live.

- ``lm_perm`` (O,) int64: the observations in landmark-sorted order
  (stable: by index within a landmark), the masked ones last;
- ``lm_off`` (M + 1,) int32: landmark m's live observations are positions
  ``lm_off[m]:lm_off[m + 1]`` of that order;
- ``op_lm`` (O,) int32: the pose of each position, ``obs_pose[lm_perm]``;
- ``pose_pos`` (O,) int32: pose by pose (stable), the positions in the
  landmark-sorted order of the pose's live observations, then those of
  the masked ones;
- ``pose_off`` (K + 1,) int32: pose k's run of ``pose_pos``.

No range covers a masked position, so neither sweep reads one."""


def _live_first(perm, dead):
    """perm with the entries whose observation is dead moved to the end,
    both parts in perm's order."""
    return perm[torch.argsort(dead[perm].to(torch.int8), stable=True)]


def schur_index(K, M, obs_pose, obs_lm, pose_plan=None, lm_plan=None,
                obs_mask=None):
    """The ``SchurIndex`` of observations (obs_pose, obs_lm), indices in
    [0, K) and [0, M).  The segment plans' stable sorts are reused when
    given (``ops/segment.SegmentPlan.perm``).  Observations with
    ``obs_mask == 0`` (the padding of a bucketed map, all on pose 0 and
    landmark 0) are kept out of every range: the solver weighs them by 0,
    so their E blocks are 0 and S does not change, and a pad of up to a
    bucket's worth would otherwise lengthen one landmark's serial run and
    one pose's sum in every launch."""
    obs_pose = obs_pose.reshape(-1).long()
    obs_lm = obs_lm.reshape(-1).long()
    O = obs_lm.numel()
    if O >= 2 ** 31:
        raise ValueError(f"schur_index: {O} observations do not fit int32")
    dev = obs_lm.device
    lm_perm = (lm_plan.perm if lm_plan is not None
               else torch.argsort(obs_lm, stable=True))
    pose_perm = (pose_plan.perm if pose_plan is not None
                 else torch.argsort(obs_pose, stable=True))
    lm_key, pose_key = obs_lm, obs_pose
    if obs_mask is not None:
        dead = obs_mask.reshape(-1) == 0
        lm_perm = _live_first(lm_perm, dead)
        pose_perm = _live_first(pose_perm, dead)
        lm_key = torch.where(dead, M, obs_lm)
        pose_key = torch.where(dead, K, obs_pose)
    pos = torch.empty(O, dtype=torch.int64, device=dev)
    pos[lm_perm] = torch.arange(O, dtype=torch.int64, device=dev)
    lm_off = torch.searchsorted(
        lm_key[lm_perm], torch.arange(M + 1, dtype=torch.int64, device=dev))
    pose_off = torch.searchsorted(
        pose_key[pose_perm],
        torch.arange(K + 1, dtype=torch.int64, device=dev))
    return SchurIndex(lm_perm, lm_off.int(), obs_pose[lm_perm].int(),
                      pos[pose_perm].int(), pose_off.int())


def landmark_planes(E, index):
    """E (O, 6, 3) -> (18, O): plane a * 3 + b holds E[:, a, b] in the
    landmark-sorted order of ``index``."""
    return E.reshape(E.shape[0], 18).t().index_select(
        1, index.lm_perm).contiguous()


def schur_matvec_plain(v, Hpp_d, Hll_inv, E_planes, fixed, index):
    """The kernel's matvec in plain torch: freeK (Hpp_d w - W Hll_inv W^T w)
    with w = freeK v, from the index arrays and the E planes (the live
    positions only, as the kernel reads them)."""
    K, M = Hpp_d.shape[0], Hll_inv.shape[0]
    dev = v.device
    free = (1.0 - fixed)[:, None]
    w = v * free
    L = int(index.lm_off[M])                 # the live positions
    Es = E_planes[:, :L].t().reshape(-1, 6, 3)
    lm_of = torch.repeat_interleave(torch.arange(M, device=dev),
                                    torch.diff(index.lm_off.long()))
    pose_of = torch.repeat_interleave(torch.arange(K, device=dev),
                                      torch.diff(index.pose_off.long()))
    t = torch.zeros((M, 3), dtype=v.dtype, device=dev).index_add_(
        0, lm_of, torch.einsum("nab,na->nb", Es,
                               w[index.op_lm[:L].long()]))
    zm = torch.einsum("mab,mb->ma", Hll_inv, t)
    y = torch.einsum("nab,nb->na", Es, zm[lm_of])
    u2 = torch.zeros((K, 6), dtype=v.dtype, device=dev).index_add_(
        0, pose_of, y[index.pose_pos[:L].long()])
    return (torch.einsum("kab,kb->ka", Hpp_d, w) - u2) * free


def _check(name, a, dev, shape, dtype):
    if a.device != dev:
        raise ValueError(f"schur_pcg: {name} on {a.device}, expected {dev}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"schur_pcg: {name} has shape {tuple(a.shape)}, "
                         f"expected {tuple(shape)}")
    if a.dtype != dtype:
        raise ValueError(f"schur_pcg: {name} is {a.dtype}, expected {dtype}")


def schur_pcg(Hpp_d, Hll_inv, E_planes, Minv, rhs, fixed, index, n_cg):
    """K4 wrapper: x (K, 6) after n_cg block-Jacobi PCG iterations on
    S x = rhs from x = 0, S = Hpp_d - W Hll_inv W^T restricted to the free
    poses, preconditioned by Minv (K, 6, 6).  Hpp_d (K, 6, 6), Hll_inv
    (M, 3, 3), E_planes (18, O) from ``landmark_planes``, rhs (K, 6),
    fixed (K,) 1 = frozen, all float32 or all float64 on one CUDA device;
    ``index`` from ``schur_index`` on that device.  Counts launches in
    ``schur_pcg.launches``; raises on what the kernel does not take."""
    launch, x = schur_pcg_call(Hpp_d, Hll_inv, E_planes, Minv, rhs, fixed,
                               index, n_cg)
    launch()
    return x


def schur_pcg_call(Hpp_d, Hll_inv, E_planes, Minv, rhs, fixed, index, n_cg):
    """The CUDA half of ``schur_pcg``: checks, allocates, sets up x = 0,
    r = rhs, z = Minv r, p = 0 and rz = r . z, and returns (launch, x);
    each ``launch()`` queues n_cg further iterations (three kernels each)
    into x on the current stream and counts them.  Timing ``launch`` alone
    gives the loop's own time."""
    dev = Hpp_d.device
    if dev.type != "cuda":
        raise ValueError(f"schur_pcg: unsupported device {dev}")
    dt = Hpp_d.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"schur_pcg: unsupported dtype {dt}")
    K, M, O = Hpp_d.shape[0], Hll_inv.shape[0], E_planes.shape[-1]
    if K < 1 or M < 1:
        raise ValueError(f"schur_pcg: empty problem K={K} M={M}")
    n_cg = int(n_cg)
    if n_cg < 0:
        raise ValueError(f"schur_pcg: n_cg={n_cg}")
    for name, a, shape in (("Hpp_d", Hpp_d, (K, 6, 6)),
                           ("Hll_inv", Hll_inv, (M, 3, 3)),
                           ("E_planes", E_planes, (18, O)),
                           ("Minv", Minv, (K, 6, 6)), ("rhs", rhs, (K, 6)),
                           ("fixed", fixed, (K,))):
        _check(name, a, dev, shape, dt)
    for name, shape in (("lm_off", (M + 1,)), ("op_lm", (O,)),
                        ("pose_pos", (O,)), ("pose_off", (K + 1,))):
        _check(name, getattr(index, name), dev, shape, torch.int32)
    ins = tuple(a.contiguous() for a in (
        E_planes, index.lm_off, index.op_lm, Hll_inv, index.pose_pos,
        index.pose_off, Hpp_d, 1.0 - fixed, Minv))
    x = torch.zeros((K, 6), dtype=dt, device=dev)
    r = rhs.clone(memory_format=torch.contiguous_format)
    z = torch.einsum("kab,kb->ka", ins[8], r).contiguous()
    pa = torch.zeros((K, 6), dtype=dt, device=dev)
    pb = torch.empty((K, 6), dtype=dt, device=dev)
    Ap = torch.empty((K, 6), dtype=dt, device=dev)
    y = torch.empty((O, 8), dtype=dt, device=dev)
    part = torch.empty(K, dtype=dt, device=dev)
    zero = torch.zeros(1, dtype=dt, device=dev)
    scal = torch.cat([zero, zero, torch.sum(r * z).reshape(1)])
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    outs = (x, r, z, pa, pb, Ap, y, part, scal, counters)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("schur_pcg")
    fn = lib.schur_pcg_f32 if dt == torch.float32 else lib.schur_pcg_f64
    argv = (*[a.data_ptr() for a in ins + outs], K, M, O, n_cg)

    # `keep` holds the tensors whose pointers argv carries.
    def launch(keep=(ins, outs)):
        with torch.cuda.device(dev):
            err = fn(*argv, torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, "schur_pcg")
        cuda_lib.count_launch(schur_pcg, 3 * n_cg)

    return launch, x


schur_pcg.launches = 0

VI = 15      # an inertial state: [phi, p, v, bg, ba]


def chain_prev(nxt):
    """prv (K,) int32 of a chain given nxt (K,) (-1: none): prv[nxt[k]] =
    k.  No host sync: the states without a next write into a spare slot."""
    K = nxt.shape[0]
    prv = torch.full((K + 1,), -1, dtype=torch.int32, device=nxt.device)
    prv[torch.where(nxt >= 0, nxt, K).long()] = torch.arange(
        K, dtype=torch.int32, device=nxt.device)
    return prv[:K]


def vi_schur_pcg(D, U, nxt, Hll_inv, E_planes, Minv, rhs, fixed, free_dims,
                 index, n_cg):
    """K4 on the inertial BA's reduced system: x (K, 15) after n_cg
    block-Jacobi PCG iterations on A x = rhs from x = 0, A = freeD (D +
    the chain's couplings U - P^T W Hll_inv W^T P) freeD, preconditioned by
    Minv (K, 15, 15).  D and U (K, 15, 15): each state's diagonal block and
    its coupling to the next state of the chain nxt (K,) int32 (-1: none;
    a state is the next of at most one); fixed (K,) 1 = frozen pose,
    free_dims (K, 15) 0 where a value is frozen; the visual arrays as
    ``schur_pcg`` takes them.  All float32 or all float64 on one CUDA
    device.  Counts launches in ``schur_pcg.launches``."""
    launch, x = vi_schur_pcg_call(D, U, nxt, Hll_inv, E_planes, Minv, rhs,
                                  fixed, free_dims, index, n_cg)
    launch()
    return x


def vi_schur_pcg_call(D, U, nxt, Hll_inv, E_planes, Minv, rhs, fixed,
                      free_dims, index, n_cg):
    """The CUDA half of ``vi_schur_pcg``, as ``schur_pcg_call``."""
    dev = D.device
    if dev.type != "cuda":
        raise ValueError(f"vi_schur_pcg: unsupported device {dev}")
    dt = D.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"vi_schur_pcg: unsupported dtype {dt}")
    K, M, O = D.shape[0], Hll_inv.shape[0], E_planes.shape[-1]
    if K < 1 or M < 1:
        raise ValueError(f"vi_schur_pcg: empty problem K={K} M={M}")
    n_cg = int(n_cg)
    if n_cg < 0:
        raise ValueError(f"vi_schur_pcg: n_cg={n_cg}")
    for name, a, shape in (("D", D, (K, VI, VI)), ("U", U, (K, VI, VI)),
                           ("Hll_inv", Hll_inv, (M, 3, 3)),
                           ("E_planes", E_planes, (18, O)),
                           ("Minv", Minv, (K, VI, VI)), ("rhs", rhs, (K, VI)),
                           ("fixed", fixed, (K,)),
                           ("free_dims", free_dims, (K, VI))):
        _check(name, a, dev, shape, dt)
    _check("nxt", nxt, dev, (K,), torch.int32)
    for name, shape in (("lm_off", (M + 1,)), ("op_lm", (O,)),
                        ("pose_pos", (O,)), ("pose_off", (K + 1,))):
        _check(name, getattr(index, name), dev, shape, torch.int32)
    ins = tuple(a.contiguous() for a in (
        E_planes, index.lm_off, index.op_lm, Hll_inv, index.pose_pos,
        index.pose_off, D, U, nxt, chain_prev(nxt), 1.0 - fixed, free_dims,
        Minv))
    x = torch.zeros((K, VI), dtype=dt, device=dev)
    r = rhs.clone(memory_format=torch.contiguous_format)
    z = torch.einsum("kab,kb->ka", ins[12], r).contiguous()
    pa = torch.zeros((K, VI), dtype=dt, device=dev)
    pb = torch.empty((K, VI), dtype=dt, device=dev)
    Ap = torch.empty((K, VI), dtype=dt, device=dev)
    y = torch.empty((O, 8), dtype=dt, device=dev)
    part = torch.empty(K, dtype=dt, device=dev)
    zero = torch.zeros(1, dtype=dt, device=dev)
    scal = torch.cat([zero, zero, torch.sum(r * z).reshape(1)])
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    outs = (x, r, z, pa, pb, Ap, y, part, scal, counters)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("schur_pcg")
    fn = lib.vi_schur_pcg_f32 if dt == torch.float32 else lib.vi_schur_pcg_f64
    argv = (*[a.data_ptr() for a in ins + outs], K, M, O, n_cg)

    def launch(keep=(ins, outs)):
        with torch.cuda.device(dev):
            err = fn(*argv, torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, "vi_schur_pcg")
        cuda_lib.count_launch(schur_pcg, 3 * n_cg)

    return launch, x
