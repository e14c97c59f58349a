"""Cross-cutting utilities: profiling."""

from orb_slam3_study_kr_tpu_torch.utils.profiling import StageTimers
