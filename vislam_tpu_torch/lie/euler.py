"""Euler (roll-pitch-yaw) conversions and angle utilities (port of
`vislam_tpu/lie/euler.py`).

Convention: intrinsic Z-Y-X (yaw-pitch-roll), R = Rz(yaw) Ry(pitch) Rx(roll);
RPY vectors are laid out [roll, pitch, yaw]. Every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.quat import mat_to_quat, quat_to_mat


def rpy_to_quat(rpy):
    """[roll, pitch, yaw] (..., 3) -> quaternion [w, x, y, z]."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quat_to_rpy(q):
    """Quaternion [w, x, y, z] -> [roll, pitch, yaw], pitch clamped at the poles."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_mat(rpy):
    return quat_to_mat(rpy_to_quat(rpy))


def mat_to_rpy(R):
    return quat_to_rpy(mat_to_quat(R))


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def angle_diff(a, b):
    """Shortest signed angular difference a - b, in (-pi, pi]."""
    return wrap_angle(a - b)
