"""Madgwick filter and IMU preintegration (port of vislam_tpu.inertial)."""
