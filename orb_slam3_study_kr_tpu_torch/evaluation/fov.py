"""How far off-axis a session's map is observed: the native-FOV check of
the fisheye sessions (observations past the bootstrap's 75-degree cone
mean the KB8 model carried them, not a virtual pinhole)."""

import numpy as np
import torch


def max_bound_theta_deg(slam):
    """The largest off-axis angle (degrees) of a keyframe observation bound
    to a landmark in ``slam``'s active map, from the tracker's bearing
    rays."""
    m, cfg = slam.atlas.active_map, slam.tracker.cfg
    best = 0.0
    for kf in np.nonzero(m.kf_valid)[0]:
        sel = m.kf_kp_lm[kf] != -1
        if sel.any():
            rays = cfg.unproject_fn(torch.as_tensor(
                m.kf_kp_uv[kf][sel], device=cfg.device)).cpu().numpy()
            th = np.degrees(np.arctan2(np.linalg.norm(rays[:, :2], axis=-1),
                                       rays[:, 2]))
            best = max(best, float(th.max()))
    return best
