"""Lie groups on torch tensors (SO3, SE3, Sim3)."""

from orb_slam3_study_kr_tpu_torch.lie import so3, se3, sim3
