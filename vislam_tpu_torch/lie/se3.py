"""SE(3) exponential and logarithm maps on (R, t) pairs (port of
`vislam_tpu/lie/se3.py`, the part the bundle adjustments reach). Twists are
(...,6) laid out [rho(3), phi(3)]: translation first, rotation second."""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.so3 import (
    so3_exp,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
)


def se3_exp(xi):
    """Twist (...,6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), (so3_left_jacobian(phi) @ rho[..., None])[..., 0]


def se3_log(T):
    """(R, t) -> twist (...,6) [rho, phi]."""
    R, t = T
    phi = so3_log(R)
    rho = (so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)
