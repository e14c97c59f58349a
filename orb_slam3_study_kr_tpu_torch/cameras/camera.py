"""A camera: its model, intrinsics and image size, with the model dispatch.

Counterpart of ``orb_slam3_study_kr_tpu/cameras/camera.py`` (the
reference's GeometricCamera virtuals).  A plain dataclass whose params
tensor lives on an explicit device; ``project`` / ``unproject`` /
``project_jac`` pick the model's module by ``kind``.
"""

import enum
from dataclasses import dataclass

import torch

from orb_slam3_study_kr_tpu_torch.cameras import kb8, pinhole
from orb_slam3_study_kr_tpu_torch.utils.device import resolve_device

N_PARAMS = 9  # [fx, fy, cx, cy, d0..d4]: one layout for both models


class CameraKind(str, enum.Enum):
    PINHOLE = "pinhole"
    KB8 = "kb8"


@dataclass(frozen=True)
class Camera:
    params: torch.Tensor  # (N_PARAMS,) float32
    kind: CameraKind = CameraKind.PINHOLE
    width: int = 752
    height: int = 480

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    @property
    def K(self):
        p = self.params
        z = torch.zeros_like(p[0])
        return torch.stack([torch.stack([p[0], z, p[2]]),
                            torch.stack([z, p[1], p[3]]),
                            torch.stack([z, z, torch.ones_like(p[0])])])


def _params(values, device):
    return torch.tensor(values, dtype=torch.float32,
                        device=resolve_device(device, "Camera device"))


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                 width=752, height=480, device="cuda"):
    return Camera(params=_params([fx, fy, cx, cy, k1, k2, p1, p2, k3], device),
                  kind=CameraKind.PINHOLE, width=width, height=height)


def make_kb8(fx, fy, cx, cy, k1, k2, k3, k4, width=512, height=512,
             device="cuda"):
    return Camera(params=_params([fx, fy, cx, cy, k1, k2, k3, k4, 0.0], device),
                  kind=CameraKind.KB8, width=width, height=height)


_MODULES = {CameraKind.PINHOLE: pinhole, CameraKind.KB8: kb8}


def project(cam: Camera, pts):
    return _MODULES[cam.kind].project(cam.params, pts)


def unproject(cam: Camera, uv):
    return _MODULES[cam.kind].unproject(cam.params, uv)


def project_jac(cam: Camera, pts):
    return _MODULES[cam.kind].project_jac(cam.params, pts)
