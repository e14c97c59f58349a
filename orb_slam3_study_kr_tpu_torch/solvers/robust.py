"""Robust-kernel weights and chi-square gates shared by all solvers
(counterpart of ``orb_slam3_study_kr_tpu/solvers/robust.py``)."""

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5


def huber_weight(r2, delta):
    """IRLS weight for the Huber kernel given squared residual norm r2."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def octave_inv_sigma2(level, scale_factor=1.2):
    """Information weight per pyramid level: scale_factor^(-2 level)."""
    base = torch.tensor(scale_factor, dtype=torch.float32, device=level.device)
    return torch.pow(base, -2.0 * level.to(torch.float32))


def cheirality(p, wide_fov):
    """Camera points (..., 3) a solver weighs: z > 1e-3 in front of a
    pinhole camera; with ``wide_fov`` (fisheye) |p| > 1e-3, so points past
    90 degrees off-axis keep their weight."""
    if wide_fov:
        return torch.linalg.norm(p, dim=-1) > 1e-3
    return p[..., 2] > 1e-3
