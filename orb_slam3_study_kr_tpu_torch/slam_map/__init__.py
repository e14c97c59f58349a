"""Map data model: keyframes, landmarks, observations, covisibility, Atlas
(numpy structure-of-array tables, copied from the reference package)."""

from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState, Atlas
