"""Madgwick filter, IMU preintegration and the linear VI alignment (port of
vislam_tpu.inertial)."""
