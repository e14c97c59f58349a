"""Pose-only and bundle-adjustment solvers."""

from orb_slam3_study_kr_tpu_torch.solvers.pose_opt import optimize_pose
from orb_slam3_study_kr_tpu_torch.solvers.local_ba import bundle_adjust
