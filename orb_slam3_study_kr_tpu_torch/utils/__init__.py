"""Cross-cutting utilities: profiling and device resolution."""

from orb_slam3_study_kr_tpu_torch.utils.device import resolve_device
from orb_slam3_study_kr_tpu_torch.utils.profiling import (DEFAULT_TIMERS,
                                                         StageTimers)
