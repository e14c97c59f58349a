"""Segment sums in a fixed order.

The solvers assemble their normal equations by scatter-adding per-edge
blocks into per-pose, per-landmark and dense blocks: the reference's
``jnp.zeros(...).at[idx].add(vals)`` (``solvers/local_ba.py``,
``pose_graph.py``, ``inertial_ba.py``, ``parallel/dist_ba.py``) and the
BoW tf-idf vector.  In float arithmetic such a sum depends on the order of
its additions.  On the CPU, ``index_add_`` and ``index_put_(accumulate=
True)`` add in input order, as XLA does, so a run gives the same bits
every time.  On CUDA ``index_add_`` adds with atomics in whatever order
the threads run, so two runs of one session drift apart by rounding that
the solvers amplify (``index_put_`` sorts its indices first, but torch
promises neither order).

Here the order depends only on the index and the values:

- ``SegmentPlan(n, idx)`` takes a stable argsort of ``idx`` once and splits
  every segment into pieces of at most ``C = ceil(sqrt(O))`` consecutive
  sorted entries (O = len(idx)), with the piece and segment offsets;
- ``SegmentPlan.sum(vals)`` gathers ``vals`` in sorted order and reduces
  each piece, then each segment's pieces, with ``torch.segment_reduce``
  over those offsets (a loop or a segmented block reduction per output
  element: no atomics).  Two levels keep each output's serial chain
  short for segments as long as a pose's observations.  The shapes
  depend only on ``n`` and ``O``, so the plan needs no host sync.

A plan depends only on the index, so a solver builds one per index per
solve and reuses it across its LM iterations.  ``segment_sum`` and
``put_add_`` take the fixed order for tensors on the card and keep
``index_add_`` / ``index_put_`` on the CPU, where the order is fixed
already (and the CPU bits stay what they were).  Indices must lie in
``[0, n)``; the sums are of floating-point values.
"""

import math

import torch


def _fixed_order(t):
    """Whether sums of tensors on t's device take the plan's order."""
    return t.device.type == "cuda"


class SegmentPlan:
    """The fixed order of summing rows of values into ``n`` segments by
    ``idx`` (O,).  Build once per index, call ``sum`` per set of values."""

    def __init__(self, n, idx):
        idx = idx.reshape(-1).long()
        dev = idx.device
        self.n = n = int(n)
        self.size = O = idx.numel()
        self.perm = torch.argsort(idx, stable=True)
        if n == 0:
            return
        keys = idx[self.perm]
        start = torch.searchsorted(
            keys, torch.arange(n + 1, dtype=torch.int64, device=dev))
        count = start[1:] - start[:-1]
        C = max(1, math.isqrt(max(O - 1, 0)) + 1)
        pieces = (count + C - 1) // C
        pend = torch.cumsum(pieces, 0)
        # At most n + O // C pieces: piece p belongs to segment s_of_p
        # (== n past the last piece, whose offsets all sit at the end).
        p = torch.arange(n + O // C, dtype=torch.int64, device=dev)
        s_of_p = torch.searchsorted(pend, p, right=True)
        s = torch.clamp(s_of_p, max=n - 1)
        first = start[s] + (p - (pend[s] - pieces[s])) * C
        end = start[n:]
        self.piece_offsets = torch.cat(
            [torch.where(s_of_p < n, first, end), end])
        self.segment_offsets = torch.cat(
            [torch.zeros(1, dtype=torch.int64, device=dev), pend])

    def sum(self, vals):
        """(n, *vals.shape[1:]): row s the sum of the vals[i] with
        idx[i] == s, in the plan's order on every device."""
        if vals.shape[0] != self.size:
            raise ValueError(f"SegmentPlan.sum: {vals.shape[0]} rows for a "
                             f"plan of {self.size}")
        if self.n == 0:
            return vals.new_zeros((0, *vals.shape[1:]))
        # Scalars as (O, 1): one thread per output element on CUDA, where
        # 1-D data takes a block per segment.
        v = vals[self.perm] if vals.dim() > 1 else vals[self.perm, None]
        part = torch.segment_reduce(v, "sum", offsets=self.piece_offsets,
                                    axis=0, unsafe=True)
        out = torch.segment_reduce(part, "sum", offsets=self.segment_offsets,
                                   axis=0, unsafe=True)
        return out if vals.dim() > 1 else out[:, 0]


def segment_plan(n, idx):
    """The plan ``segment_sum(n, idx, ...)`` takes on idx's device: a
    ``SegmentPlan`` on the card, None on the CPU (``index_add_``)."""
    return SegmentPlan(n, idx) if _fixed_order(idx) else None


def segment_sum(n, idx, vals, plan=None):
    """zeros((n, *vals.shape[1:])) with each vals[i] added at row idx[i],
    as the reference's ``.at[idx].add(vals)``.  On the card the additions
    follow ``plan`` (built here when None); on the CPU, ``index_add_``."""
    if not _fixed_order(vals):
        return torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype,
                           device=vals.device).index_add_(0, idx, vals)
    if plan is None:
        plan = SegmentPlan(n, idx)
    elif plan.n != n:
        raise ValueError(f"segment_sum: a plan of {plan.n} segments for n={n}")
    return plan.sum(vals)


def ravel_index(shape, indices):
    """Row-major flat index (1-D) of the broadcast ``indices`` into the
    leading dims ``shape``."""
    indices = torch.broadcast_tensors(*indices)
    flat = indices[0].long()
    for size, ix in zip(shape[1:], indices[1:]):
        flat = flat * size + ix.long()
    return flat.reshape(-1)


def put_plan(shape, indices):
    """The plan ``put_add_(target, indices, ...)`` takes on the card for a
    target of shape ``shape``; None on the CPU."""
    if not _fixed_order(indices[0]):
        return None
    lead = shape[:len(indices)]
    return SegmentPlan(math.prod(lead), ravel_index(lead, indices))


def put_add_(target, indices, vals, plan=None):
    """``target.index_put_(indices, vals, accumulate=True)`` for a
    contiguous target: on the card the indices are flattened over
    target's leading dims and vals summed into them in a fixed order.
    Returns target."""
    if not _fixed_order(vals):
        return target.index_put_(indices, vals, accumulate=True)
    k = len(indices)
    lead, rest = target.shape[:k], target.shape[k:]
    flat = target.view(-1, *rest)
    if plan is None:
        plan = SegmentPlan(flat.shape[0], ravel_index(lead, indices))
    shape = torch.broadcast_shapes(*(ix.shape for ix in indices))
    flat.add_(segment_sum(flat.shape[0], None,
                          vals.expand(*shape, *rest).reshape(-1, *rest), plan))
    return target
