"""Orientation filters (Madgwick, complementary), IMU preintegration and
dead-reckoning, static bias calibration and the linear VI alignment (port
of vislam_tpu.inertial)."""

from vislam_tpu_torch.inertial.filters import (
    complementary_scan,
    complementary_step,
    madgwick_scan,
    madgwick_step,
    orientation_from_accel,
)
from vislam_tpu_torch.inertial.bias import (
    calibrate_accel_bias,
    calibrate_gyro_bias,
    static_mask,
)
from vislam_tpu_torch.inertial.preintegration import Preintegrated, dead_reckon, preintegrate
from vislam_tpu_torch.inertial.vi_align import VIAlignment, refine_gravity, vi_align

__all__ = [
    "madgwick_step",
    "madgwick_scan",
    "complementary_step",
    "complementary_scan",
    "orientation_from_accel",
    "static_mask",
    "calibrate_gyro_bias",
    "calibrate_accel_bias",
    "Preintegrated",
    "preintegrate",
    "dead_reckon",
    "VIAlignment",
    "vi_align",
    "refine_gravity",
]
