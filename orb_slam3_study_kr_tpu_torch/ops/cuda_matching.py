"""K2: projection-gated Hamming nearest neighbour.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_matching.py``
(``gated_nn_pallas``).  On CUDA tensors ``gated_nn`` launches the
hand-written kernel in ``csrc/gated_nn.cu``; on CPU tensors it runs
``gated_nn_plain``, the dense masked Hamming matrix of the reference's jnp
path.  Semantics: first-index argmin, a second-best that leaves out only
the argmin index, BIG for gated entries, idx 0 and best = second = BIG
when every landmark is gated.  Any landmark count L >= 1.

Descriptors come either as (..., 256) uint8 {0,1} bits or as (..., 8)
int32 words from ``pack_desc``.  The kernel reads words; a caller that
matches the same descriptors more than once packs them once and passes
the words (the fused tracking rounds, the cached landmark block).
"""

import numpy as np
import torch

BIG = 1e9

_SHIFTS = {}   # device -> (32,) int32 bit positions


def _shifts(dev):
    s = _SHIFTS.get(dev)
    if s is None:
        s = _SHIFTS[dev] = torch.arange(32, dtype=torch.int32, device=dev)
    return s


def pack_desc(desc):
    """(..., 256) uint8 {0,1} -> (..., 8) int32 words.  Bit k of word w is
    bit 32 w + k (bit 31 is the sign bit), so popcount of XORed words is the
    Hamming distance.  The shifted bits are disjoint, so their int32 sum is
    their OR."""
    d = desc.reshape(*desc.shape[:-1], 8, 32).to(torch.int32)
    return torch.bitwise_left_shift(d, _shifts(desc.device)).sum(
        -1, dtype=torch.int32)


def pack_desc_np(desc):
    """pack_desc on the host: (..., 256) uint8 {0,1} numpy -> (..., 8)
    int32 numpy words, bit-identical to pack_desc (little-endian bytes of
    little-endian bit order)."""
    packed = np.packbits(np.asarray(desc, np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<i4")


def unpack_desc(words):
    """(..., 8) int32 words -> (..., 256) uint8 {0,1}: pack_desc's inverse."""
    bits = torch.bitwise_right_shift(words[..., None], _shifts(words.device))
    return (bits & 1).to(torch.uint8).reshape(*words.shape[:-1], 256)


def is_words(desc):
    return desc.dtype == torch.int32 and desc.shape[-1] == 8


def as_words(desc):
    """Descriptors as (..., 8) int32 words: words pass through, (..., 256)
    uint8 bits are packed."""
    if is_words(desc):
        return desc
    if desc.dtype == torch.uint8 and desc.shape[-1] == 256:
        return pack_desc(desc)
    raise ValueError("descriptors must be (..., 256) uint8 bits or (..., 8) "
                     f"int32 words, got shape {tuple(desc.shape)} dtype "
                     f"{desc.dtype}")


def as_bits(desc):
    """Descriptors as (..., 256) uint8 bits (words are unpacked)."""
    return unpack_desc(desc) if is_words(desc) else desc


def gated_nn_plain(q_desc, q_uv, q_level, q_valid,
                   t_desc, t_uv, t_radius, t_level, t_valid, level_slack=1):
    """Dense reference: q_* (..., N, ...), t_desc (L, 256) bits or (L, 8)
    words, t_* (..., L, ...).  Returns (best (..., N) f32, second (..., N)
    f32, idx (..., N) int32)."""
    qf = as_bits(q_desc).to(torch.float32)
    tf = as_bits(t_desc).to(torch.float32)
    dot = torch.matmul(tf, qf.transpose(-1, -2))          # (..., L, N)
    dist = tf.sum(-1)[..., :, None] + qf.sum(-1)[..., None, :] - 2.0 * dot
    d_uv = torch.abs(t_uv[..., :, None, :] - q_uv[..., None, :, :])
    r = t_radius[..., :, None]
    lvl = q_level[..., None, :] - t_level[..., :, None]
    mask = ((d_uv[..., 0] <= r) & (d_uv[..., 1] <= r)
            & (lvl >= -level_slack) & (lvl <= level_slack)
            & t_valid[..., :, None] & q_valid[..., None, :])
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-2)                          # first index
    best = torch.gather(d, -2, idx[..., None, :])[..., 0, :]
    L = d.shape[-2]
    excl = torch.arange(L, device=d.device)[:, None] == idx[..., None, :]
    second = torch.where(excl, torch.full_like(d, BIG), d).min(dim=-2).values
    return best, second, idx.to(torch.int32)


def _check(name, a, dev, shape, dtype):
    if a.device != dev:
        raise ValueError(f"gated_nn: {name} on {a.device}, expected {dev}")
    if tuple(a.shape) != shape:
        raise ValueError(f"gated_nn: {name} has shape {tuple(a.shape)}, "
                         f"expected {shape}")
    if dtype is not None and a.dtype != dtype:
        raise ValueError(f"gated_nn: {name} is {a.dtype}, expected {dtype}")


def gated_nn(q_desc, q_uv, q_level, q_valid,
             t_desc, t_uv, t_radius, t_level, t_valid, level_slack=1):
    """K2 wrapper.  q_desc (B?, N, 256) uint8 or (B?, N, 8) int32 words,
    q_uv (B?, N, 2) f32, q_level (B?, N) int, q_valid (B?, N) bool; t_desc
    (L, 256) uint8 or (L, 8) int32 words, shared across the batch; t_uv (B?,
    L, 2) f32, t_radius (B?, L) f32, t_level (B?, L) int, t_valid (B?, L)
    bool.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; counts launches in ``gated_nn.launches``."""
    if q_desc.device.type == "cpu":
        return gated_nn_plain(q_desc, q_uv, q_level, q_valid, t_desc, t_uv,
                              t_radius, t_level, t_valid, level_slack)
    launch, out = gated_nn_call(q_desc, q_uv, q_level, q_valid, t_desc, t_uv,
                                t_radius, t_level, t_valid, level_slack)
    launch()
    return out


def gated_nn_call(q_desc, q_uv, q_level, q_valid,
                  t_desc, t_uv, t_radius, t_level, t_valid, level_slack=1):
    """The CUDA half of ``gated_nn``: checks, packs and allocates, and
    returns (launch, (best, second, idx)); each ``launch()`` runs the
    kernel once into those outputs on the current stream and counts it.
    Timing ``launch`` alone gives the kernel's own time."""
    dev = q_desc.device
    if dev.type != "cuda":
        raise ValueError(f"gated_nn: unsupported device {dev}")
    batched = q_desc.dim() == 3
    B = q_desc.shape[0] if batched else 1
    N = q_desc.shape[-2]
    L = t_desc.shape[0]
    if L < 1 or N < 1 or B < 1:
        raise ValueError(f"gated_nn: empty problem B={B} N={N} L={L}")
    bt = (B,) if batched else ()
    q_words = as_words(q_desc)
    t_words = as_words(t_desc)
    _check("q_desc", q_words, dev, (*bt, N, 8), None)
    _check("q_uv", q_uv, dev, (*bt, N, 2), torch.float32)
    _check("q_level", q_level, dev, (*bt, N), None)
    _check("q_valid", q_valid, dev, (*bt, N), torch.bool)
    _check("t_desc", t_words, dev, (L, 8), None)
    _check("t_uv", t_uv, dev, (*bt, L, 2), torch.float32)
    _check("t_radius", t_radius, dev, (*bt, L), torch.float32)
    _check("t_level", t_level, dev, (*bt, L), None)
    _check("t_valid", t_valid, dev, (*bt, L), torch.bool)
    t_words = t_words.contiguous()
    if t_words.data_ptr() % 16:
        raise ValueError("gated_nn: t_desc words must start 16-byte aligned "
                         "(the kernel bulk-copies them)")
    ins = (q_words.contiguous(), q_uv.contiguous(),
           q_level.to(torch.int32).contiguous(), q_valid.contiguous(),
           t_words, t_uv.contiguous(), t_radius.contiguous(),
           t_level.to(torch.int32).contiguous(), t_valid.contiguous())
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    second = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N), dtype=torch.int32, device=dev)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    argv = (*[a.data_ptr() for a in ins], best.data_ptr(), second.data_ptr(),
            idx.data_ptr(), B, N, L, int(level_slack))

    # `keep` holds the tensors whose pointers argv carries.
    def launch(keep=(ins, best, second, idx)):
        err = lib.gated_nn(*argv, torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, "gated_nn")
        gated_nn.launches += 1

    if not batched:
        return launch, (best[0], second[0], idx[0])
    return launch, (best, second, idx)


gated_nn.launches = 0
