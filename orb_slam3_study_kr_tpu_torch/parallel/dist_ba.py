"""Landmark-sharded bundle adjustment over several shards.

Counterpart of ``orb_slam3_study_kr_tpu/parallel/dist_ba.py``.  Global BA
is split by landmark, the standard distributed-Schur structure:

- landmarks (and all their observations) are split into equal blocks, one
  per shard, so the 3x3 elimination blocks are local to a shard;
- camera poses are replicated;
- each shard builds its part of the reduced camera system, and ``psum``
  adds the parts;
- landmark updates back-substitute on their own shard.

A ``BaMesh`` holds this process's local shards (torch devices, which may
repeat: several shards may share one card) and, optionally, a
``torch.distributed`` process group for the shards of other processes.
Global shard order is the reference's: rank 0's local shards first, then
rank 1's, and so on.  ``psum`` adds the local shards' partials in shard
order on the first local device, then all-reduces that sum over the group.
Every decision the shards share (the LM accept test, lambda, the reduced
solve for dp and the pose-space CG) is taken once, on the reduced values,
so no two shards or ranks can diverge.

Three assemblies (as the reference):
- "dense": each shard forms its (K, M_blk, 6, 3) cross block and reduces
  its part of the (6K, 6K) reduced system once per iteration;
- "dense_chunked": the same, a landmark chunk of C = min(M_blk, 2048) at a
  time, so the cross block stays bounded;
- "pcg": matrix-free preconditioned CG on the reduced system, one reduced
  (K, 6) vector per CG matvec.

The stereo row comes in through ``obs_ur`` / ``bf``, the fisheye
cheirality through ``wide_fov``, and the per-observation chi2 goes out for
the caller's outlier culling, as in the single-device solver.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu_torch.ops.segment import segment_plan, segment_sum
from orb_slam3_study_kr_tpu_torch.solvers import robust
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan, solve_nan
from orb_slam3_study_kr_tpu_torch.solvers.local_ba import _diag, _schur_pcg
from orb_slam3_study_kr_tpu_torch.solvers.reproj import residual_and_jacobians
from orb_slam3_study_kr_tpu_torch.utils import resolve_device

CHUNK = 2048   # landmarks per chunk of the "dense_chunked" assembly
ASSEMBLIES = ("dense", "dense_chunked", "pcg")


class BaMesh:
    """This process's local shards and the group of the other processes'.

    ``devices``: the local shards' torch devices (a device may repeat);
    ``group``: a torch.distributed process group or None.  ``n_psum``
    counts the reductions, each one ``all_reduce`` over the group when one
    is set."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("BaMesh needs at least one local shard")
        self.group = group
        self.n_psum = 0

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.n_local * self.world_size

    def psum(self, parts):
        """Sum of every shard's partial: the local ones in shard order on
        the first local device, then an all_reduce over the group."""
        self.n_psum += 1
        dev0 = self.devices[0]
        total = parts[0].to(dev0)
        for p in parts[1:]:
            total = total + p.to(dev0)
        if self.group is not None:
            if total is parts[0]:
                total = total.clone()
            dist.all_reduce(total, group=self.group)
        return total

    def local_rows(self, a):
        """The rows of this process's shards of a host-replicated array
        (the concatenation of every global shard's equal block)."""
        n = a.shape[0] // self.size * self.n_local
        return a[self.rank * n:(self.rank + 1) * n]

    def gather(self, x):
        """The concatenation of every global shard's rows as numpy, from
        this process's concatenated local rows (an all_gather over the
        group)."""
        if self.group is None:
            return x.detach().cpu().numpy()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([p.cpu() for p in parts]).numpy()


def make_ba_mesh(devices=None, group=None) -> BaMesh:
    """A mesh over ``devices`` (default: every visible card; raises without
    one) and the process group ``group`` (None: this process alone)."""
    if devices is None:
        resolve_device("cuda", "make_ba_mesh devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return BaMesh(devices, group)


def collectives_per_iter(assembly: str, n_cg: int = 60) -> int:
    """Reductions per LM iteration: the dense assemblies pay a constant 5
    (Hpp, bp, S, rhs, cost) whatever the problem size; PCG pays one per CG
    matvec on top of its setup."""
    return 5 if assembly in ("dense", "dense_chunked") else n_cg + 5


def _on(fn, dev):
    """A camera function re-bound to ``dev``: a partial over a Camera (or
    a parameter tensor) gets its tensors moved, so that shards of one
    process may sit on several cards."""
    if not isinstance(fn, functools.partial):
        return fn

    def move(a):
        if torch.is_tensor(a):
            return a.to(dev)
        if dataclasses.is_dataclass(a) and torch.is_tensor(
                getattr(a, "params", None)):
            return dataclasses.replace(a, params=a.params.to(dev))
        return a
    return functools.partial(fn.func, *(move(a) for a in fn.args),
                             **fn.keywords)


def _blockdiag6(Hb, K):
    out = torch.zeros((K, 6, K, 6), dtype=Hb.dtype, device=Hb.device)
    idx = torch.arange(K, device=Hb.device)
    out[idx, :, idx, :] = Hb
    return out.reshape(6 * K, 6 * K)


def distributed_bundle_adjust(
        mesh, project_fn, project_jac_fn,
        R_cw, t_cw, fixed,          # (K,3,3), (K,3), (K,): replicated
        X, lm_mask,                 # (n_local*Mb, 3), (n_local*Mb,): sharded
        obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # (n_local*Ob, ...)
        n_iters: int = 10, init_lambda: float = 1e-4,
        obs_ur=None, bf=None, assembly: str = "dense", n_cg: int = 60,
        wide_fov: bool = False):
    """LM-damped Schur-complement BA over ``mesh``.

    The sharded inputs are this process's local shards, concatenated:
    equal blocks along axis 0, each observation in its landmark's shard,
    ``obs_lm`` holding indices into the shard's own landmark block
    (``shard_ba_problem`` builds them).  Poses are replicated.  Returns
    (R_cw, t_cw, X, chi2): the poses on the first local device, X and the
    per-observation chi2 as the concatenated local shards, on that device
    too."""
    if assembly not in ASSEMBLIES:
        raise ValueError(f"distributed_bundle_adjust: unknown assembly "
                         f"{assembly!r}")
    dev0 = mesh.devices[0]
    R_all = torch.as_tensor(R_cw).to(dev0)
    t_all = torch.as_tensor(t_cw).to(dev0)
    fixed = torch.as_tensor(fixed).to(dev0)
    K = R_all.shape[0]
    dt = R_all.dtype

    def split(a):
        """The local shards' equal blocks of a, each on its device."""
        a = torch.as_tensor(a)
        b = a.shape[0] // mesh.n_local
        return [a[i * b:(i + 1) * b].to(d) for i, d in enumerate(mesh.devices)]

    names = ("X", "lmm", "op", "ol", "uv", "lev", "om")
    shards = [dict(zip(names, blocks)) for blocks in zip(*map(split, (
        X, lm_mask, obs_pose, obs_lm, obs_uv, obs_level, obs_mask)))]
    urs = [None] * mesh.n_local if obs_ur is None else split(obs_ur)
    for s, dev, ur in zip(shards, mesh.devices, urs):
        s.update(dev=dev, ur=ur, op=s["op"].long(), ol=s["ol"].long(),
                 proj=_on(project_fn, dev), jac=_on(project_jac_fn, dev),
                 inv_sigma2=robust.octave_inv_sigma2(s["lev"]))
        mono = torch.tensor(robust.CHI2_MONO, dtype=dt, device=dev)
        s["gate"] = mono if ur is None else torch.where(
            ur >= 0, torch.tensor(robust.CHI2_STEREO, dtype=dt, device=dev),
            mono)
        s["delta"] = torch.sqrt(s["gate"])
        # The segment sums' orders, fixed once per solve (None on the CPU).
        Mb = s["X"].shape[0]
        s["plans"] = (segment_plan(K, s["op"]), segment_plan(Mb, s["ol"]))
        if assembly != "pcg":
            s["chunks"] = _chunks(K, s["op"], s["ol"], Mb, Mb if assembly
                                  == "dense" else CHUNK)

    def compute(s, R, t, X_blk):
        R, t = R.to(s["dev"]), t.to(s["dev"])
        r, J_pose, J_point, p = residual_and_jacobians(
            s["jac"], s["proj"], R[s["op"]], t[s["op"]], X_blk[s["ol"]],
            s["uv"], ur_obs=s["ur"], bf=bf)
        chi2 = torch.sum(r * r, dim=-1) * s["inv_sigma2"]
        valid = s["om"] * s["lmm"][s["ol"]] * robust.cheirality(p, wide_fov)
        w = s["inv_sigma2"] * valid * robust.huber_weight(chi2, s["delta"])
        rho = torch.where(chi2 <= s["gate"], chi2,
                          2 * s["delta"] * torch.sqrt(torch.clamp(
                              chi2, min=1e-12)) - s["gate"])
        return r, J_pose, J_point, w, chi2, torch.sum(rho * valid)

    eye3 = torch.eye(3, dtype=dt, device=dev0)
    eye6 = torch.eye(6, dtype=dt, device=dev0)
    fixd = fixed.repeat_interleave(6)
    Xs = [s["X"] for s in shards]
    lam = torch.tensor(init_lambda, dtype=dt, device=dev0)
    cost = mesh.psum([compute(s, R_all, t_all, Xb)[5]
                      for s, Xb in zip(shards, Xs)])
    free = 1.0 - fixed
    for _ in range(n_iters):
        Hpp_p, bp_p, loc = [], [], []
        for s, Xb in zip(shards, Xs):
            r, J_pose, J_point, w, _, _ = compute(s, R_all, t_all, Xb)
            op, ol, Mb = s["op"], s["ol"], Xb.shape[0]
            pp, lp = s["plans"]
            Jp = J_pose * free.to(s["dev"])[op][:, None, None]
            Hpp_p.append(segment_sum(K, op, torch.einsum("nia,n,nib->nab",
                                                         Jp, w, Jp), pp))
            bp_p.append(segment_sum(K, op, torch.einsum("nia,n,ni->na",
                                                        Jp, w, r), pp))
            Hll = segment_sum(Mb, ol, torch.einsum("nia,n,nib->nab", J_point,
                                                   w, J_point), lp)
            bl = segment_sum(Mb, ol, torch.einsum("nia,n,ni->na", J_point, w,
                                                  r), lp)
            E = torch.einsum("nia,n,nib->nab", Jp, w, J_point)   # (O, 6, 3)
            lam_s = lam.to(s["dev"])
            e3 = eye3.to(s["dev"])
            # Padding landmarks have Hll = 0: lam I keeps their block
            # invertible, and lm_mask zeroes their update.
            Hll_d = Hll + lam_s * (e3[None] + _diag(Hll, 3))
            Hll_inv = inv_nan(Hll_d) * s["lmm"][:, None, None]
            loc.append((Hll_inv, bl, E))
        Hpp = mesh.psum(Hpp_p)
        bp = mesh.psum(bp_p)
        Hpp_d = Hpp + lam * (eye6[None] + _diag(Hpp, 6))

        if assembly == "pcg":
            dp = _schur_pcg(Hpp_d, bp, [h for h, _, _ in loc],
                            [b for _, b, _ in loc], [e for _, _, e in loc],
                            [s["op"] for s in shards],
                            [s["ol"] for s in shards], fixed, n_cg,
                            [s["plans"] for s in shards], psum_fn=mesh.psum)
        else:
            S_p, rhs_p = [], []
            for s, (Hll_inv, bl, E) in zip(shards, loc):
                S_i, rhs_i = _reduced_part(K, s["chunks"], Hll_inv, bl, E)
                S_p.append(S_i)
                rhs_p.append(rhs_i)
            S = mesh.psum(S_p) + _blockdiag6(Hpp_d, K)
            # bp is reduced already: it enters once, after the reduction.
            rhs = mesh.psum(rhs_p) - bp.reshape(6 * K)
            S = S * (1 - fixd)[:, None] * (1 - fixd)[None, :] + torch.diag(fixd)
            dp = solve_nan(S, rhs).reshape(K, 6)

        dR, dtr = exp_se3(dp)
        R_new, t_new = se3_compose(dR, dtr, R_all, t_all)
        X_new = []
        for s, Xb, (Hll_inv, bl, E) in zip(shards, Xs, loc):
            dps = dp.to(s["dev"])
            Wtdp = segment_sum(Xb.shape[0], s["ol"],
                               torch.einsum("nab,na->nb", E, dps[s["op"]]),
                               s["plans"][1])
            dl = -torch.einsum("mab,mb->ma", Hll_inv, bl + Wtdp)
            X_new.append(Xb + dl * s["lmm"][:, None])
        cost_new = mesh.psum([compute(s, R_new, t_new, Xb)[5]
                              for s, Xb in zip(shards, X_new)])
        accept = cost_new < cost
        R_all = torch.where(accept, R_new, R_all)
        t_all = torch.where(accept, t_new, t_all)
        Xs = [torch.where(accept.to(Xb.device), Xn, Xb)
              for Xb, Xn in zip(Xs, X_new)]
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e3))
        cost = torch.where(accept, cost_new, cost)
    chi2 = [compute(s, R_all, t_all, Xb)[4] for s, Xb in zip(shards, Xs)]
    return (R_all, t_all, torch.cat([Xb.to(dev0) for Xb in Xs]),
            torch.cat([c.to(dev0) for c in chi2]))


def _chunks(K, op, ol, Mb, chunk):
    """Per landmark chunk of one shard: (c0, c, cell, inside, plan), the
    cross block's cell of each observation (clamped into the chunk),
    whether it lies in the chunk, and the cells' segment plan.  Built once
    per solve."""
    out = []
    for c0 in range(0, Mb, chunk):
        c = min(chunk, Mb - c0)
        local = ol - c0
        cell = op * c + torch.clamp(local, 0, c - 1)
        out.append((c0, c, cell, (local >= 0) & (local < c),
                    segment_plan(K * c, cell)))
    return out


def _reduced_part(K, chunks, Hll_inv, bl, E):
    """One shard's part of the reduced camera system: -sum W Hll^-1 W^T
    and sum W Hll^-1 bl over its landmarks, one chunk of ``_chunks`` at a
    time (the (K, c, 6, 3) cross block).  An observation outside the chunk
    adds a zero block (the reference's scatter with mode="drop")."""
    S = torch.zeros((6 * K, 6 * K), dtype=E.dtype, device=E.device)
    rhs = torch.zeros(6 * K, dtype=E.dtype, device=E.device)
    for c0, c, cell, inside, plan in chunks:
        W = segment_sum(K * c, cell, E * inside[:, None, None].to(E.dtype),
                        plan).reshape(K, c, 6, 3)
        Wi = torch.einsum("kmab,mbc->kmac", W, Hll_inv[c0:c0 + c])
        S = S - torch.einsum("kmac,lmbc->kalb", Wi, W).reshape(6 * K, 6 * K)
        rhs = rhs + torch.einsum("kmab,mb->ka", Wi,
                                 bl[c0:c0 + c]).reshape(6 * K)
    return S, rhs


def shard_ba_problem(n_shards, X, lm_mask, obs_pose, obs_lm, obs_uv,
                     obs_level, obs_mask, obs_ur=None):
    """Host partitioner (numpy only): round-robin landmarks into equal
    blocks, route each observation to its landmark's shard, convert obs_lm
    to indices into the shard's block, and pad every shard to a common
    size.

    Returns (X, lm_mask, obs_pose, obs_lm, obs_uv, obs_level, obs_mask,
    [obs_ur], dev_of_lm, local_of_lm, Mb, obs_slot): the sharded arrays as
    the concatenation of every shard's block, landmark j at row
    ``dev_of_lm[j] * Mb + local_of_lm[j]``, and ``obs_slot`` the caller's
    index of each sharded observation (-1 for padding)."""
    M = X.shape[0]
    Mb = -(-M // n_shards)
    dev_of_lm = np.arange(M) % n_shards
    local_of_lm = np.arange(M) // n_shards

    X_sh = np.zeros((n_shards, Mb, 3), X.dtype)
    lmm_sh = np.zeros((n_shards, Mb), lm_mask.dtype)
    for d in range(n_shards):
        sel = dev_of_lm == d
        X_sh[d, : sel.sum()] = X[sel]
        lmm_sh[d, : sel.sum()] = lm_mask[sel]

    dev_of_obs = dev_of_lm[obs_lm]
    per_dev = [np.nonzero(dev_of_obs == d)[0] for d in range(n_shards)]
    Ob = max(max(len(p) for p in per_dev), 1)
    op_sh = np.zeros((n_shards, Ob), obs_pose.dtype)
    ol_sh = np.zeros((n_shards, Ob), obs_lm.dtype)
    ouv_sh = np.zeros((n_shards, Ob, 2), obs_uv.dtype)
    olev_sh = np.zeros((n_shards, Ob), obs_level.dtype)
    om_sh = np.zeros((n_shards, Ob), obs_mask.dtype)
    our_sh = np.full((n_shards, Ob), -1.0, np.float32)
    obs_slot = np.full((n_shards, Ob), -1, np.int64)
    for d, idx in enumerate(per_dev):
        k = len(idx)
        op_sh[d, :k] = obs_pose[idx]
        ol_sh[d, :k] = local_of_lm[obs_lm[idx]]
        ouv_sh[d, :k] = obs_uv[idx]
        olev_sh[d, :k] = obs_level[idx]
        om_sh[d, :k] = obs_mask[idx]
        obs_slot[d, :k] = idx
        if obs_ur is not None:
            our_sh[d, :k] = obs_ur[idx]
    out = [X_sh.reshape(-1, 3), lmm_sh.reshape(-1), op_sh.reshape(-1),
           ol_sh.reshape(-1), ouv_sh.reshape(-1, 2), olev_sh.reshape(-1),
           om_sh.reshape(-1)]
    if obs_ur is not None:
        out.append(our_sh.reshape(-1))
    out += [dev_of_lm, local_of_lm, Mb, obs_slot.reshape(-1)]
    return tuple(out)
