"""K1: fused FAST score + two-threshold NMS + Gaussian blur over a pyramid.

Counterpart of ``orb_slam3_study_kr_tpu/ops/pallas_fast.py``.  On CUDA
tensors ``fast_nms_blur_pyramid`` launches the hand-written kernel in
``csrc/fast_nms_blur.cu`` once for all levels; ``fast_nms_blur`` is the
same launch over one level.  On CPU tensors both run the plain PyTorch
version of the same function, ``fast_nms_blur_plain``, level by level.
Both follow the reference's jnp-path semantics: true level width, wrapping
FAST/NMS shifts, edge-clamped blur.
"""

import ctypes

import torch

from orb_slam3_study_kr_tpu_torch.ops.orb import (
    G7, fast_score_map, gaussian_blur7, nms3x3)

_G7_C = (ctypes.c_float * 7)(*[float(v) for v in G7])
MAX_LEVELS = 16


def fast_nms_blur_plain(img, th_min: float, th_ini: float):
    """(H, W) f32 level -> (s_raw, s20_nms, s7_nms, blur), all (H, W) f32."""
    s_raw = fast_score_map(img, th_min)
    s20 = torch.where(s_raw > th_ini, s_raw, torch.zeros_like(s_raw))
    return s_raw, nms3x3(s20), nms3x3(s_raw), gaussian_blur7(img)


def fast_nms_blur_pyramid_plain(levels, th_min: float, th_ini: float):
    """The plain version over a pyramid: per level the (4, H, W) stack of
    (s_raw, s20, s7, blur)."""
    return [torch.stack(fast_nms_blur_plain(img, th_min, th_ini))
            for img in levels]


def fast_nms_blur_pyramid(levels, th_min: float, th_ini: float):
    """K1 wrapper.  levels: a list of (H_l, W_l) float32 images on one
    device.  Returns, per level, the (4, H_l, W_l) stack of (s_raw, s20,
    s7, blur).  On CUDA: ONE kernel launch for all levels, counted in
    ``fast_nms_blur_pyramid.launches``; the levels are gathered into one
    flat arena (no copy for a single contiguous level) and each level's
    stack is a view of one (4, total) output.  On the CPU: the plain
    version."""
    if levels[0].device.type == "cpu":
        return fast_nms_blur_pyramid_plain(levels, th_min, th_ini)
    launch, maps = fast_nms_blur_pyramid_call(levels, th_min, th_ini)
    launch()
    return maps


def fast_nms_blur_pyramid_call(levels, th_min: float, th_ini: float):
    """The CUDA half of ``fast_nms_blur_pyramid``: checks, gathers the
    arena and allocates, and returns (launch, maps); each ``launch()`` runs
    the kernel once into those maps on the current stream and counts it.
    Timing ``launch`` alone gives the kernel's own time."""
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"fast_nms_blur: unsupported device {dev}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_nms_blur: {len(levels)} levels, the kernel "
                         f"takes 1..{MAX_LEVELS}")
    if th_min < 0 or th_ini < 0:
        raise ValueError("fast_nms_blur: the kernel takes thresholds >= 0, "
                         f"got {th_min}, {th_ini}")
    table, shapes, sizes = [], [], []
    off = 0
    for img in levels:
        if img.device != dev or img.dtype != torch.float32 or img.dim() != 2:
            raise ValueError("fast_nms_blur: expects (H, W) float32 levels on "
                             f"{dev}, got {tuple(img.shape)} {img.dtype} on "
                             f"{img.device}")
        H, W = img.shape
        if H < 7 or W < 7:
            raise ValueError(f"fast_nms_blur: level {H}x{W} is smaller than "
                             "the FAST ring")
        table += [off, H, W]
        shapes.append((H, W))
        sizes.append(H * W)
        off += H * W
    if off >= 2 ** 31:
        raise ValueError(f"fast_nms_blur: {off} pixels exceed int32 offsets")
    arena = (levels[0].contiguous().view(-1) if len(levels) == 1
             else torch.cat([img.reshape(-1) for img in levels]))
    out = torch.empty((4, off), dtype=torch.float32, device=dev)
    from orb_slam3_study_kr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    argv = (arena.data_ptr(), out.data_ptr(),
            (ctypes.c_int * len(table))(*table), len(levels), float(th_min),
            float(th_ini), ctypes.addressof(_G7_C))

    # `keep` holds the tensors whose pointers argv carries.
    def launch(keep=(arena, out)):
        err = lib.fast_nms_blur_pyramid(
            *argv, torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, "fast_nms_blur_pyramid")
        fast_nms_blur_pyramid.launches += 1

    maps = [part.view(4, H, W)
            for part, (H, W) in zip(out.split(sizes, dim=1), shapes)]
    return launch, maps


fast_nms_blur_pyramid.launches = 0


def fast_nms_blur(img, th_min: float, th_ini: float):
    """One (H, W) f32 level -> the (4, H, W) stack of (s_raw, s20, s7,
    blur): the single-level form of ``fast_nms_blur_pyramid`` (the same
    launch on CUDA, the plain version on the CPU)."""
    return fast_nms_blur_pyramid([img], th_min, th_ini)[0]
