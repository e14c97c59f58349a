"""Camera models (pinhole with rad-tan distortion, Kannala-Brandt KB8
fisheye), their dispatch and two-view init."""

from orb_slam3_study_kr_tpu_torch.cameras import kb8, pinhole
from orb_slam3_study_kr_tpu_torch.cameras.camera import (
    Camera, CameraKind, make_kb8, make_pinhole, project, project_jac,
    unproject)
