"""Tracking (monocular, rectified stereo, RGB-D), local mapping, the
background mapping worker and the session API."""

from orb_slam3_study_kr_tpu_torch.pipeline.system import SlamSystem, SystemConfig
