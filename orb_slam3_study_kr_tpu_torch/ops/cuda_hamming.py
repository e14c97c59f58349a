"""K3: masked Hamming nearest neighbour, by rows and by columns.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_matching.py``
(``hamming_nn_pallas``), generalised to what ``match_by_descriptor``
needs: a validity mask on both sides, an optional leading batch axis on
either side, and the column argmin of the same masked matrix.  On CUDA
tensors the wrappers launch the hand-written kernel in
``csrc/hamming_nn.cu`` (one launch gives rows and columns); on CPU tensors
they run the plain version, one dense masked Hamming matrix reduced both
ways.  Semantics: a pair (i, j) counts only when ``q_valid[i] &
t_valid[j]`` and scores BIG otherwise; first-index argmin in rows and in
columns; a second-best that leaves out only the argmin index; idx 0 and
best = second = BIG for a row with no valid pair, back 0 for a column with
none.  Any Q, T >= 1.  Descriptors are (..., 256) uint8 {0,1} bits, which
the kernel reads as they are, or (..., 8) int32 words from
``cuda_matching.pack_desc``, which the wrapper unpacks first.
"""

import torch

from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import as_bits
from orb_slam3_study_kr_tpu_torch.ops.matching import BIG, _excl_min, hamming_matrix


def hamming_nn_match_plain(q_desc, q_valid, t_desc, t_valid):
    """Dense reference: q_desc (..., Q, 256) bits or (..., Q, 8) words,
    q_valid (..., Q), t_desc (..., T, 256) or (..., T, 8), t_valid (..., T);
    leading axes broadcast.  One masked matrix, reduced by rows and by
    columns.  Returns (best (..., Q) f32, second (..., Q) f32, idx (..., Q)
    int32, back (..., T) int32)."""
    dist = hamming_matrix(as_bits(q_desc), as_bits(t_desc))
    mask = q_valid[..., :, None] & t_valid[..., None, :]
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-1)                             # first index
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    second = _excl_min(d, idx, -1)
    back = torch.argmin(d, dim=-2)
    return best, second, idx.to(torch.int32), back.to(torch.int32)


def hamming_nn_plain(q_desc, q_valid, t_desc, t_valid):
    """The rows of ``hamming_nn_match_plain``: (best, second, idx)."""
    return hamming_nn_match_plain(q_desc, q_valid, t_desc, t_valid)[:3]


def _check(name, a, dev, shape, dtype):
    if a.device != dev:
        raise ValueError(f"hamming_nn: {name} on {a.device}, expected {dev}")
    if a.dtype != dtype:
        raise ValueError(f"hamming_nn: {name} is {a.dtype}, expected {dtype}")
    if tuple(a.shape) != shape:
        raise ValueError(f"hamming_nn: {name} has shape {tuple(a.shape)}, "
                         f"expected {shape}")
    if not a.is_contiguous():
        raise ValueError(f"hamming_nn: {name} is not contiguous")


def hamming_nn(q_desc, q_valid, t_desc, t_valid):
    """K3 wrapper, rows only.  q_desc (Q, 256) or (B, Q, 256) uint8 {0,1},
    or the same with (..., 8) int32 words; q_valid (Q,) or (B, Q) bool;
    t_desc (T, 256) or (B, T, 256) uint8, or words; t_valid (T,) or (B, T)
    bool.  A side without the batch axis is shared by every batch row.
    Returns (best, second, idx) of shape (Q,) when neither side is batched,
    else (B, Q).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; counts launches in ``hamming_nn.launches``."""
    if q_desc.device.type == "cpu":
        return hamming_nn_plain(q_desc, q_valid, t_desc, t_valid)
    launch, out = hamming_nn_call(q_desc, q_valid, t_desc, t_valid)
    launch()
    return out


def hamming_nn_match(q_desc, q_valid, t_desc, t_valid):
    """``hamming_nn`` plus the column output of the same launch: returns
    (best, second, idx, back), back (T,) or (B, T) int32, each target's
    first-index argmin over the queries of the masked matrix.  One K3
    launch (counted in ``hamming_nn.launches``) on CUDA tensors."""
    if q_desc.device.type == "cpu":
        return hamming_nn_match_plain(q_desc, q_valid, t_desc, t_valid)
    launch, out = hamming_nn_call(q_desc, q_valid, t_desc, t_valid,
                                  columns=True)
    launch()
    return out


def hamming_nn_call(q_desc, q_valid, t_desc, t_valid, columns=False):
    """The CUDA half of ``hamming_nn`` (``columns=True``:
    ``hamming_nn_match``): checks and allocates, and returns (launch,
    outputs); each ``launch()`` runs the kernel once into those outputs on
    the current stream (with the memset of the column keys) and counts it.
    Timing ``launch`` alone gives the kernel's own time."""
    dev = q_desc.device
    if dev.type != "cuda":
        raise ValueError(f"hamming_nn: unsupported device {dev}")
    q_batched, t_batched = q_desc.dim() == 3, t_desc.dim() == 3
    Q, T = q_desc.shape[-2], t_desc.shape[-2]
    Bq = q_desc.shape[0] if q_batched else 1
    Bt = t_desc.shape[0] if t_batched else 1
    if q_batched and t_batched and Bq != Bt:
        raise ValueError(f"hamming_nn: batch sizes differ, {Bq} and {Bt}")
    B = max(Bq, Bt)
    if Q < 1 or T < 1 or B < 1:
        raise ValueError(f"hamming_nn: empty problem B={B} Q={Q} T={T}")
    qb = (Bq,) if q_batched else ()
    tb = (Bt,) if t_batched else ()
    q_bits = as_bits(q_desc)
    t_bits = as_bits(t_desc)
    _check("q_desc", q_bits, dev, (*qb, Q, 256), torch.uint8)
    _check("q_valid", q_valid, dev, (*qb, Q), torch.bool)
    _check("t_desc", t_bits, dev, (*tb, T, 256), torch.uint8)
    _check("t_valid", t_valid, dev, (*tb, T), torch.bool)
    for name, a in (("q_desc", q_bits), ("t_desc", t_bits)):
        if a.data_ptr() % 16:
            raise ValueError(f"hamming_nn: {name} must start 16-byte aligned "
                             "(the kernel copies rows 16 bytes at a time)")
    best = torch.empty((B, Q), dtype=torch.float32, device=dev)
    second = torch.empty((B, Q), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Q), dtype=torch.int32, device=dev)
    keys = (torch.empty((B, T), dtype=torch.int64, device=dev) if columns
            else None)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    argv = (q_bits.data_ptr(), q_valid.data_ptr(), t_bits.data_ptr(),
            t_valid.data_ptr(), best.data_ptr(), second.data_ptr(),
            idx.data_ptr(), None if keys is None else keys.data_ptr(),
            B, Q, T, int(not q_batched), int(not t_batched))
    keep = (q_bits, q_valid, t_bits, t_valid, best, second, idx, keys)

    # `keep` holds the tensors whose pointers argv carries.
    def launch(keep=keep):
        err = lib.hamming_nn(*argv, torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, "hamming_nn")
        hamming_nn.launches += 1

    out = (best, second, idx)
    if columns:
        # Each key is (d << 32 | q); its low word, first in memory, is q.
        out += (keys.view(torch.int32)[..., 0::2],)
    if not (q_batched or t_batched):
        out = tuple(x[0] for x in out)
    return launch, out


hamming_nn.launches = 0
