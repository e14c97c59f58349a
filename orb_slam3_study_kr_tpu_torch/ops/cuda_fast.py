"""K1: fused FAST score + two-threshold NMS + Gaussian blur per pyramid level.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_fast.py``.  On a CUDA
tensor ``fast_nms_blur`` launches the hand-written kernel in
``csrc/fast_nms_blur.cu`` (one launch per level); on a CPU tensor it runs
``fast_nms_blur_plain``, the same function in plain PyTorch.  Both follow
the reference's jnp-path semantics: true level width, wrapping FAST/NMS
shifts, edge-clamped blur.
"""

import ctypes

import torch

from orb_slam3_study_kr_tpu_torch.ops.orb import (
    G7, fast_score_map, gaussian_blur7, nms3x3)

_G7_C = (ctypes.c_float * 7)(*[float(v) for v in G7])


def fast_nms_blur_plain(img, th_min: float, th_ini: float):
    """(H, W) f32 level -> (s_raw, s20_nms, s7_nms, blur), all (H, W) f32."""
    s_raw = fast_score_map(img, th_min)
    s20 = torch.where(s_raw > th_ini, s_raw, torch.zeros_like(s_raw))
    return s_raw, nms3x3(s20), nms3x3(s_raw), gaussian_blur7(img)


def fast_nms_blur(img, th_min: float, th_ini: float):
    """K1 wrapper: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor.  Counts kernel launches in ``fast_nms_blur.launches``."""
    if img.device.type == "cpu":
        return fast_nms_blur_plain(img, th_min, th_ini)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms_blur: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_nms_blur: expects a contiguous (H, W) float32 "
                         f"level, got {tuple(img.shape)} {img.dtype}")
    H, W = img.shape
    if H < 7 or W < 7:
        raise ValueError(f"fast_nms_blur: level {H}x{W} is smaller than the "
                         "FAST ring")
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    outs = [torch.empty_like(img) for _ in range(4)]
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.fast_nms_blur(img.data_ptr(), *[o.data_ptr() for o in outs],
                            H, W, float(th_min), float(th_ini),
                            ctypes.addressof(_G7_C), stream)
    cuda_lib.check(err, "fast_nms_blur")
    fast_nms_blur.launches += 1
    return tuple(outs)


fast_nms_blur.launches = 0
