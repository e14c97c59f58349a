"""Camera models (pinhole with rad-tan distortion) and two-view init."""

from orb_slam3_study_kr_tpu_torch.cameras import pinhole
