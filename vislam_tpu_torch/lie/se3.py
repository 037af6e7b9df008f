"""SE(3) rigid transforms as (R, t) pairs (port of `vislam_tpu/lie/se3.py`). A transform is the
tuple (R, t) with R (...,3,3) and t (...,3); twists are (...,6) laid out
[rho(3), phi(3)]: translation first, rotation second."""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.so3 import (
    so3_exp,
    so3_hat,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
)


def se3_identity(dtype=torch.float32, *, device="cuda"):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


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


def se3_compose(A, B):
    """A after B: the result maps p -> A(B(p))."""
    Ra, ta = A
    Rb, tb = B
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(T):
    R, t = T
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(T, p):
    """Apply the transform to points p (...,3) (broadcasts)."""
    R, t = T
    return (R @ p[..., None])[..., 0] + t


def se3_matrix(T):
    """(R, t) -> homogeneous 4x4 (batched)."""
    R, t = T
    bottom = torch.cat([torch.zeros_like(t[..., None, :]), torch.ones_like(t[..., None, :1])],
                       dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_from_matrix(M):
    return M[..., :3, :3], M[..., :3, 3]


def se3_adjoint(T):
    """Adjoint (...,6,6) mapping twists: Ad_T = [[R, hat(t) R], [0, R]]."""
    R, t = T
    top = torch.cat([R, so3_hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
