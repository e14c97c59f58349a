"""K2: projection-gated Hamming nearest neighbour.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_matching.py``
(``gated_nn_pallas``).  On CUDA tensors ``gated_nn`` launches the
hand-written kernel in ``csrc/gated_nn.cu``; on CPU tensors it runs
``gated_nn_plain``, the dense masked Hamming matrix of the reference's jnp
path.  Semantics: first-index argmin, a second-best that leaves out only
the argmin index, BIG for gated entries, idx 0 and best = second = BIG
when every landmark is gated.  Any landmark count L >= 1.
"""

import torch

BIG = 1e9

# Signed bit weights that pack 32 {0,1} bits into one int32 word without
# overflow (bit 31 carries -2^31), so popcount of XORed words is Hamming.
_BIT_W = [1 << k for k in range(31)] + [-(1 << 31)]


def pack_desc(desc):
    """(..., 256) uint8 {0,1} -> (..., 8) int32 bit-packed words."""
    w = torch.tensor(_BIT_W, dtype=torch.int64, device=desc.device)
    d = desc.reshape(*desc.shape[:-1], 8, 32).to(torch.int64)
    return (d * w).sum(-1).to(torch.int32).contiguous()


def gated_nn_plain(q_desc, q_uv, q_level, q_valid,
                   t_desc, t_uv, t_radius, t_level, t_valid, level_slack=1):
    """Dense reference: q_* (..., N, ...), t_desc (L, 256), t_* (..., L, ...).
    Returns (best (..., N) f32, second (..., N) f32, idx (..., N) int32)."""
    qf = q_desc.to(torch.float32)
    tf = t_desc.to(torch.float32)
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


def gated_nn(q_desc, q_uv, q_level, q_valid,
             t_desc, t_uv, t_radius, t_level, t_valid, level_slack=1):
    """K2 wrapper.  q_desc (B?, N, 256) uint8, q_uv (B?, N, 2) f32, q_level
    (B?, N) int, q_valid (B?, N) bool; t_desc (L, 256) uint8 shared across
    the batch; t_uv (B?, L, 2) f32, t_radius (B?, L) f32, t_level (B?, L)
    int, t_valid (B?, L) bool.  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; counts launches in
    ``gated_nn.launches``."""
    if q_desc.device.type == "cpu":
        return gated_nn_plain(q_desc, q_uv, q_level, q_valid, t_desc, t_uv,
                              t_radius, t_level, t_valid, level_slack)
    if q_desc.device.type != "cuda":
        raise ValueError(f"gated_nn: unsupported device {q_desc.device}")
    batched = q_desc.dim() == 3
    B = q_desc.shape[0] if batched else 1
    N = q_desc.shape[-2]
    L = t_desc.shape[0]
    if L < 1 or N < 1:
        raise ValueError(f"gated_nn: empty problem N={N} L={L}")
    dev = q_desc.device
    shapes = {
        "q_desc": (q_desc, (B, N, 256), torch.uint8),
        "q_uv": (q_uv, (B, N, 2), torch.float32),
        "q_level": (q_level, (B, N), None),
        "q_valid": (q_valid, (B, N), torch.bool),
        "t_desc": (t_desc, (L, 256), torch.uint8),
        "t_uv": (t_uv, (B, L, 2), torch.float32),
        "t_radius": (t_radius, (B, L), torch.float32),
        "t_level": (t_level, (B, L), None),
        "t_valid": (t_valid, (B, L), torch.bool),
    }
    args = {}
    for name, (a, shape, dtype) in shapes.items():
        if a.device != dev:
            raise ValueError(f"gated_nn: {name} on {a.device}, expected {dev}")
        expect = shape if (batched or name == "t_desc") else shape[1:]
        if tuple(a.shape) != expect:
            raise ValueError(f"gated_nn: {name} has shape {tuple(a.shape)}, "
                             f"expected {expect}")
        if dtype is not None and a.dtype != dtype:
            raise ValueError(f"gated_nn: {name} is {a.dtype}, expected {dtype}")
        args[name] = a.reshape(shape)
    q_words = pack_desc(args["q_desc"])
    t_words = pack_desc(args["t_desc"])
    q_lvl = args["q_level"].to(torch.int32).contiguous()
    t_lvl = args["t_level"].to(torch.int32).contiguous()
    ins = [q_words, args["q_uv"].contiguous(), q_lvl,
           args["q_valid"].contiguous(), t_words, args["t_uv"].contiguous(),
           args["t_radius"].contiguous(), t_lvl, args["t_valid"].contiguous()]
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    second = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N), dtype=torch.int32, device=dev)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gated_nn(*[a.data_ptr() for a in ins], best.data_ptr(),
                       second.data_ptr(), idx.data_ptr(), B, N, L,
                       int(level_slack), stream)
    cuda_lib.check(err, "gated_nn")
    gated_nn.launches += 1
    if not batched:
        return best[0], second[0], idx[0]
    return best, second, idx


gated_nn.launches = 0
