"""K3: masked Hamming nearest neighbour.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_matching.py``
(``hamming_nn_pallas``), generalised to what ``match_by_descriptor``
needs: a validity mask on both sides and an optional leading batch axis on
either side.  On CUDA tensors ``hamming_nn`` launches the hand-written
kernel in ``csrc/hamming_nn.cu``; on CPU tensors it runs
``hamming_nn_plain``, the dense masked Hamming matrix.  Semantics: a pair
(i, j) counts only when ``q_valid[i] & t_valid[j]`` and scores BIG
otherwise; first-index argmin; a second-best that leaves out only the
argmin index; idx 0 and best = second = BIG for a row with no valid pair.
Any target count T >= 1.
"""

import torch

from orb_slam3_study_kr_tpu_torch.ops.cuda_matching import pack_desc
from orb_slam3_study_kr_tpu_torch.ops.matching import BIG, _excl_min, hamming_matrix


def hamming_nn_plain(q_desc, q_valid, t_desc, t_valid):
    """Dense reference: q_desc (..., Q, 256), q_valid (..., Q), t_desc
    (..., T, 256), t_valid (..., T); leading axes broadcast.  Returns
    (best (..., Q) f32, second (..., Q) f32, idx (..., Q) int32)."""
    dist = hamming_matrix(q_desc, t_desc)
    mask = q_valid[..., :, None] & t_valid[..., None, :]
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-1)                             # first index
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    second = _excl_min(d, idx, -1)
    return best, second, idx.to(torch.int32)


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
    """K3 wrapper.  q_desc (Q, 256) or (B, Q, 256) uint8 {0,1}, q_valid
    (Q,) or (B, Q) bool; t_desc (T, 256) or (B, T, 256) uint8, t_valid (T,)
    or (B, T) bool.  A side without the batch axis is shared by every batch
    row.  Returns (best, second, idx) of shape (Q,) when neither side is
    batched, else (B, Q).  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; counts launches in ``hamming_nn.launches``."""
    if q_desc.device.type == "cpu":
        return hamming_nn_plain(q_desc, q_valid, t_desc, t_valid)
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
    _check("q_desc", q_desc, dev, (*qb, Q, 256), torch.uint8)
    _check("q_valid", q_valid, dev, (*qb, Q), torch.bool)
    _check("t_desc", t_desc, dev, (*tb, T, 256), torch.uint8)
    _check("t_valid", t_valid, dev, (*tb, T), torch.bool)
    q_words = pack_desc(q_desc)
    t_words = pack_desc(t_desc)
    best = torch.empty((B, Q), dtype=torch.float32, device=dev)
    second = torch.empty((B, Q), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Q), dtype=torch.int32, device=dev)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.hamming_nn(q_words.data_ptr(), q_valid.data_ptr(),
                         t_words.data_ptr(), t_valid.data_ptr(),
                         best.data_ptr(), second.data_ptr(), idx.data_ptr(),
                         B, Q, T, int(not q_batched), int(not t_batched),
                         stream)
    cuda_lib.check(err, "hamming_nn")
    hamming_nn.launches += 1
    if not (q_batched or t_batched):
        return best[0], second[0], idx[0]
    return best, second, idx


hamming_nn.launches = 0
