"""3-D map rendering (the reference's src/MapDrawer.cc).

Counterpart of ``orb_slam3_study_kr_tpu/viz/map_drawer.py``.

MapDrawer::DrawMapPoints / DrawKeyFrames / DrawCurrentCamera semantics,
rendered with matplotlib (Agg backend, headless): landmarks as a point
cloud, keyframes as camera frusta, covisibility-graph edges, the current
camera highlighted, and the frame trajectory.  Returns a figure or writes
a PNG; no GUI required.
"""

import numpy as np


def _require_mpl():
    """matplotlib.pyplot on the headless Agg backend, imported on first use
    (importing this module needs no matplotlib)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("MapDrawer and SessionViewer render with matplotlib, "
                          "which is not installed; FrameDrawer needs only "
                          "numpy") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _frustum_segments(R_cw, t_cw, scale=0.05):
    """Line segments of a small camera frustum in world coords
    (MapDrawer::DrawKeyFrames' w/h/z box)."""
    w, h, z = 1.0 * scale, 0.75 * scale, 0.6 * scale
    pts_c = np.array([
        [0, 0, 0], [w, h, z], [-w, h, z], [-w, -h, z], [w, -h, z]],
        np.float32)
    pts_w = (pts_c - t_cw) @ R_cw  # R^T (p - t)
    o, a, b, c, d = pts_w
    return [(o, a), (o, b), (o, c), (o, d), (a, b), (b, c), (c, d), (d, a)]


class MapDrawer:
    """Renders the SoA map state."""

    def __init__(self, slam_map=None, frustum_scale=0.05):
        self.map = slam_map
        self.frustum_scale = frustum_scale

    def draw(self, slam_map=None, current_pose=None, trajectory=None,
             show_covisibility=True, elev=-75, azim=-90, ax=None):
        """Render to a matplotlib 3-D axes; returns the figure.

        current_pose: (R_cw, t_cw) highlighted in green.
        trajectory: (T, 3) world camera centers polyline.
        """
        plt = _require_mpl()
        m = slam_map if slam_map is not None else self.map
        if ax is None:
            fig = plt.figure(figsize=(7, 7))
            ax = fig.add_subplot(111, projection="3d")
        else:
            fig = ax.figure

        # Landmarks (MapDrawer::DrawMapPoints; black = map, red = local).
        lm = m.lm_pos[m.lm_valid]
        if lm.size:
            ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=1, c="0.3",
                       depthshade=False, linewidths=0)

        # Keyframe frusta (blue) + covisibility edges (green, weight>=100
        # like the reference's graph drawing threshold scaled down).
        kfs = np.nonzero(m.kf_valid)[0]
        for k in kfs:
            for p, q in _frustum_segments(m.kf_R[k], m.kf_t[k],
                                          self.frustum_scale):
                ax.plot([p[0], q[0]], [p[1], q[1]], [p[2], q[2]],
                        c="tab:blue", lw=0.6)
        if show_covisibility and kfs.size:
            centers = {int(k): -m.kf_R[k].T @ m.kf_t[k] for k in kfs}
            for k in kfs:
                nb, w = m.covisibility(int(k), min_shared=30)
                for j, wj in zip(nb, w):
                    if j <= k:
                        continue
                    p, q = centers[int(k)], centers[int(j)]
                    ax.plot([p[0], q[0]], [p[1], q[1]], [p[2], q[2]],
                            c="tab:green", lw=0.4, alpha=0.5)

        if trajectory is not None and len(trajectory):
            tr = np.asarray(trajectory)
            ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], c="tab:orange", lw=1.2)

        if current_pose is not None:
            R, t = current_pose
            for p, q in _frustum_segments(R, t, self.frustum_scale * 1.5):
                ax.plot([p[0], q[0]], [p[1], q[1]], [p[2], q[2]],
                        c="tab:red", lw=1.2)

        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((1, 1, 1))
        for s in (ax.set_xlabel, ax.set_ylabel, ax.set_zlabel):
            s("")
        return fig

    def save(self, path, **kw):
        plt = _require_mpl()
        fig = self.draw(**kw)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
