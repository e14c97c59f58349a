"""Offline session viewer (the reference's src/Viewer.cc).

Counterpart of ``orb_slam3_study_kr_tpu/viz/viewer.py``.

The reference Viewer is a thread pacing a Pangolin window at camera fps with
menu toggles (follow camera, localization mode, step-by-step).  Headless
equivalent: a recorder attached to the SlamSystem that, every `stride`
frames, composes the FrameDrawer overlay and the MapDrawer view into one
dashboard PNG under an output directory — the artifacts a user inspects
instead of a window.
"""

import os

from orb_slam3_study_kr_tpu_torch.viz.frame_drawer import FrameDrawer
from orb_slam3_study_kr_tpu_torch.viz.map_drawer import MapDrawer, _require_mpl


class SessionViewer:
    def __init__(self, system, out_dir, stride=5, follow_camera=True):
        self.system = system
        self.out_dir = out_dir
        self.stride = max(int(stride), 1)
        self.follow_camera = follow_camera  # recenters the map view
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer()
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, img, frame):
        """Call once per tracked frame (Viewer::Run's per-iteration body)."""
        i = self.count
        self.count += 1
        if i % self.stride:
            return None
        plt = _require_mpl()

        overlay = self.frame_drawer.draw(
            img, frame, state=self.system.state, stats=self.system.stats())

        m = self.system.atlas.active_map
        rows = self.system.trajectory()
        traj = rows[:, 1:4] if len(rows) else None
        cur = ((frame.R_cw, frame.t_cw)
               if frame is not None and frame.R_cw is not None else None)

        fig = plt.figure(figsize=(13, 6))
        ax_im = fig.add_subplot(1, 2, 1)
        ax_im.imshow(overlay)
        ax_im.set_axis_off()
        ax3d = fig.add_subplot(1, 2, 2, projection="3d")
        self.map_drawer.draw(m, current_pose=cur, trajectory=traj, ax=ax3d)
        if self.follow_camera and cur is not None:
            c = -cur[0].T @ cur[1]
            r = 1.5
            ax3d.set_xlim(c[0] - r, c[0] + r)
            ax3d.set_ylim(c[1] - r, c[1] + r)
            ax3d.set_zlim(c[2] - r, c[2] + r)
        path = os.path.join(self.out_dir, f"frame_{i:05d}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
