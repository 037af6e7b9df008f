"""SO(3) exponential map, left Jacobian and re-orthonormalization (port of
`vislam_tpu/lie/so3.py`). Non-smooth primitives receive guarded inputs, and
the small-angle Taylor branches are selected with `torch.where`."""

from __future__ import annotations

import torch

_SMALL_SQ = 1e-10   # theta^2 below this uses Taylor branches (theta < 1e-5)


def so3_hat(w):
    """(...,3) rotation vector -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _exp_coeffs(theta2):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) from theta^2."""
    small = theta2 < _SMALL_SQ
    t = torch.sqrt(torch.clamp(theta2, min=_SMALL_SQ))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(theta2, min=_SMALL_SQ))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (t - torch.sin(t)) / torch.clamp(theta2 * t, min=_SMALL_SQ))
    return a, b, c


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w):
    """Rotation vector (...,3) -> rotation matrix (...,3,3) (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _exp_coeffs(theta2)
    K = so3_hat(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): exp((w+dw)^) ~= exp((J_l dw)^) exp(w^)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _exp_coeffs(theta2)
    K = so3_hat(w)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def orthonormalize(R):
    """Project a near-rotation back onto SO(3): two Newton iterations of
    R <- R (3I - R^T R) / 2 (orthogonality error eps -> O(eps^2) each)."""
    eye = _eye_like(R)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R
