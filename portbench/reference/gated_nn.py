"""Plain reference of K2: the projection-gated Hamming nearest neighbour.

A frozen copy of the port's plain version (``ops/cuda_matching.py``
``gated_nn_plain``, the reference package's dense masked Hamming matrix):
first-index argmin over the landmarks that pass the gates (box radius,
level slack, validity), a second best that leaves out only the argmin,
BIG where every landmark is gated.  Descriptors come as (..., 256) uint8
bits or (..., 8) int32 words.  ``dtype`` is the precision of the gate
arithmetic: float32 as the configuration states, bfloat16 the control's.
"""

import torch

BIG = 1e9


def unpack(words):
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = torch.bitwise_right_shift(words[..., None], shifts)
    return (bits & 1).to(torch.uint8).reshape(*words.shape[:-1], 256)


def bits(desc):
    if desc.dtype == torch.int32 and desc.shape[-1] == 8:
        return unpack(desc)
    return desc


def gated_nn(q_desc, q_uv, q_level, q_valid, t_desc, t_uv, t_radius, t_level,
             t_valid, level_slack=1, dtype=torch.float32):
    qf = bits(q_desc).to(torch.float32)
    tf = bits(t_desc).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dot = torch.matmul(tf, qf.transpose(-1, -2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    dist = tf.sum(-1)[..., :, None] + qf.sum(-1)[..., None, :] - 2.0 * dot
    d_uv = torch.abs(t_uv.to(dtype)[..., :, None, :]
                     - q_uv.to(dtype)[..., None, :, :])
    r = t_radius.to(dtype)[..., :, None]
    lvl = q_level.long()[..., None, :] - t_level.long()[..., :, None]
    mask = ((d_uv[..., 0] <= r) & (d_uv[..., 1] <= r)
            & (lvl >= -level_slack) & (lvl <= level_slack)
            & t_valid[..., :, None] & q_valid[..., None, :])
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=-2)
    best = torch.gather(d, -2, idx[..., None, :])[..., 0, :]
    L = d.shape[-2]
    excl = torch.arange(L, device=d.device)[:, None] == idx[..., None, :]
    second = torch.where(excl, torch.full_like(d, BIG), d).min(dim=-2).values
    return best, second, idx.to(torch.int32)


def passing_pairs(q_uv, q_level, q_valid, t_uv, t_radius, t_level, t_valid,
                  level_slack=1):
    """Pairs that pass the gates: the pairs whose distance K2 computes."""
    d_uv = torch.abs(t_uv[..., :, None, :] - q_uv[..., None, :, :])
    r = t_radius[..., :, None]
    lvl = q_level.long()[..., None, :] - t_level.long()[..., :, None]
    mask = ((d_uv[..., 0] <= r) & (d_uv[..., 1] <= r)
            & (lvl >= -level_slack) & (lvl <= level_slack)
            & t_valid[..., :, None] & q_valid[..., None, :])
    return int(mask.sum())


def compare(inputs, outputs, level_slack, dtype=torch.float32):
    """Entries of (best, second, idx) that differ from the reference."""
    ref = gated_nn(*inputs, level_slack=level_slack, dtype=dtype)
    return sum(int((a.reshape(b.shape) != b).sum())
               for a, b in zip(outputs, ref))
