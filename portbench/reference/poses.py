"""The tracked frames' poses against the seeded path.

A frame's answer is its pose.  The check compares each window frame's
motion from the frame k frames before it (the relative pose
T_i T_{i-k}^-1, which no choice of world frame changes) with the seeded
path's, as a share of the path's mean motion over k frames:

    e_i = |s t_rel,est - t_rel,true| / mean |t_rel,true|

t_rel is the move of the camera centre seen from the frame's own camera
(t_i - R_i R_{i-k}^T t_{i-k}), so a rotation error enters as it turns the
move.  k spans enough of the path that the move stands above the
tracker's frame-to-frame jitter.  s is 1 for a metric (stereo) session; a
monocular map's scale is fitted once before the window, as the ratio of
the true to the tracked move over the warm-up's posed frames, and held
over the window.
"""

import numpy as np


def relative(R_a, t_a, R_b, t_b):
    """T_b T_a^-1: the motion from pose a to pose b (world->camera)."""
    R = R_b @ R_a.T
    return R, t_b - R @ t_a


def fit_scale(poses, R_true, t_true):
    """s = |t_rel,true| / |t_rel,est| from the first to the last posed
    frame of ``poses`` (a list of (R, t) or None)."""
    posed = [i for i, p in enumerate(poses) if p is not None]
    if len(posed) < 2:
        raise ValueError("fewer than two posed frames to fit the scale")
    a, b = posed[0], posed[-1]
    te = relative(*poses[a], *poses[b])[1]
    tt = relative(R_true[a], t_true[a], R_true[b], t_true[b])[1]
    if np.linalg.norm(te) <= 0.0:
        raise ValueError("no tracked motion to fit the scale")
    return float(np.linalg.norm(tt) / np.linalg.norm(te))


def step_errors(poses, R_true, t_true, scale, k=1):
    """e_i for each i >= k of ``poses`` (a list of (R, t) or None for a
    frame without a pose), against the true poses; None where frame i or
    frame i - k has no pose."""
    moves = [np.linalg.norm(relative(R_true[i - k], t_true[i - k],
                                     R_true[i], t_true[i])[1])
             for i in range(k, len(poses))]
    mean_move = float(np.mean(moves))
    out = []
    for i in range(k, len(poses)):
        if poses[i] is None or poses[i - k] is None:
            out.append(None)
            continue
        te = relative(*poses[i - k], *poses[i])[1]
        tt = relative(R_true[i - k], t_true[i - k], R_true[i], t_true[i])[1]
        out.append(float(np.linalg.norm(scale * te - tt) / mean_move))
    return out
