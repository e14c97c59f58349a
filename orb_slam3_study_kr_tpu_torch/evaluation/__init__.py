"""Trajectory evaluation: RMS ATE after Horn alignment, with optional scale
correction for monocular."""

from orb_slam3_study_kr_tpu_torch.evaluation.ate import align_horn, ate_rmse, associate
