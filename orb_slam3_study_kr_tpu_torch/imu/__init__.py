"""Inertial measurements: preintegration, state prediction and the
inertial residual (counterpart of ``orb_slam3_study_kr_tpu/imu``)."""

from orb_slam3_study_kr_tpu_torch.imu.preintegration import (
    GRAVITY_VALUE, ImuCalib, Preintegrated, bias_corrected_deltas, gravity,
    inertial_residual, predict_state, preintegrate, preintegrate_batch)
