"""Trajectory evaluation: RMS ATE after Horn alignment, with optional scale
correction for monocular, and the off-axis reach of a fisheye map."""

from orb_slam3_study_kr_tpu_torch.evaluation.ate import align_horn, ate_rmse, associate
from orb_slam3_study_kr_tpu_torch.evaluation.fov import max_bound_theta_deg
