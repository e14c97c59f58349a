"""Headless visualization (the reference's src/{FrameDrawer,MapDrawer,Viewer}.cc).

The reference renders live Pangolin/OpenCV windows; the port provides the
same observability surface as headless renderers that return or write
images:

- FrameDrawer: per-frame 2-D overlay (keypoints, tracked matches, state text)
  as an (H, W, 3) uint8 array — FrameDrawer::DrawFrame semantics.
- MapDrawer: 3-D map rendering (landmarks, keyframe frusta, covisibility
  graph, current camera, trajectory) to a matplotlib figure / PNG —
  MapDrawer::Draw* semantics; matplotlib is imported on first use.
- SessionViewer: per-frame recording driver that composes both into a
  dashboard image per frame (Viewer::Run's role, without a window).
"""

from orb_slam3_study_kr_tpu_torch.viz.frame_drawer import FrameDrawer
from orb_slam3_study_kr_tpu_torch.viz.map_drawer import MapDrawer
from orb_slam3_study_kr_tpu_torch.viz.viewer import SessionViewer

__all__ = ["FrameDrawer", "MapDrawer", "SessionViewer"]
