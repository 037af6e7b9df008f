"""Madgwick filter, IMU preintegration, the linear VI alignment and static
bias calibration (port of vislam_tpu.inertial)."""

from vislam_tpu_torch.inertial.bias import (
    calibrate_accel_bias,
    calibrate_gyro_bias,
    static_mask,
)
