"""Pinhole + radial-tangential camera model (port of
`vislam_tpu/calib/camera_model.py`).

`CameraCalib` stays a host-side numpy record; the projection functions
take tensors. Pixel coords are (u, v) = (col, row); normalized coords
x = (u - cx)/fx, y = (v - cy)/fy; distortion [k1, k2, p1, p2] (radtan).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """Static calibration record (host-side; arrays are plain numpy)."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple  # (k1, k2, p1, p2)
    width: int
    height: int
    # Camera -> body rigid transform (EUROC sensor.yaml T_BS for cam0).
    T_body_cam: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )
    rate_cam_hz: float = 20.0
    rate_imu_hz: float = 200.0


def distort_normalized(xn, dist):
    """Apply radtan distortion to normalized coords xn (...,2) -> (...,2)."""
    k1, k2, p1, p2 = dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xd, dist, iters: int = 8):
    """Invert radtan distortion by a fixed number of fixed-point steps."""
    k1, k2, p1, p2 = dist
    x = xd[..., 0]
    y = xd[..., 1]
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def project_points(X_cam, fx, fy, cx, cy, dist=None):
    """Camera-frame 3D points (...,3) -> pixel coords (...,2).

    Points behind the camera project to garbage; callers mask on z > 0.
    """
    z = X_cam[..., 2:3]
    safe_z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    xn = X_cam[..., :2] / safe_z
    if dist is not None:
        xn = distort_normalized(xn, dist)
    u = xn[..., 0] * fx + cx
    v = xn[..., 1] * fy + cy
    return torch.stack([u, v], dim=-1)


def unproject_pixels(uv, fx, fy, cx, cy, dist=None):
    """Pixels (...,2) -> unit-depth normalized rays (...,3) (z=1)."""
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xn = torch.stack([x, y], dim=-1)
    if dist is not None:
        xn = undistort_normalized(xn, dist)
    return torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
