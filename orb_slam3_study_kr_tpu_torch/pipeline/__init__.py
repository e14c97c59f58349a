"""Tracking, local mapping and the session API (monocular route)."""

from orb_slam3_study_kr_tpu_torch.pipeline.system import SlamSystem, SystemConfig
