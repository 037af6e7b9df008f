"""SO(3) exponential and logarithm maps, left Jacobian and its inverse, and
re-orthonormalization (port of `vislam_tpu/lie/so3.py`). Non-smooth
primitives receive guarded inputs, and the small-angle, generic and
near-180-degree branches are all computed and selected with `torch.where`,
so `torch.func.jacfwd` and `vmap` go through every map."""

from __future__ import annotations

import math

import torch

_SMALL_SQ = 1e-10   # theta^2 below this uses Taylor branches (theta < 1e-5)
_ACOS_EPS = 1e-7


def so3_hat(w):
    """(...,3) rotation vector -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_vee(m):
    """(...,3,3) skew matrix -> (...,3) vector (inverse of so3_hat)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


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


def so3_log(R):
    """Rotation matrix (...,3,3) -> rotation vector (...,3).

    Three regimes, each computed on guarded inputs and selected:
      small:   w ~= 0.5 (1 + theta^2/6) vee(R - R^T), theta^2 from the trace
      generic: w = theta / (2 sin theta) vee(R - R^T)
      near pi: axis from the column of R + I with the largest diagonal,
               angle pi - arcsin(|antisym| / 2)
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))
    theta2_smooth = 2.0 * (1.0 - cos_theta)
    antisym = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = cos_theta > 1.0 - 1e-7          # theta < ~4.5e-4
    near_pi = cos_theta < -1.0 + 1e-6       # theta > pi - ~1.4e-3

    small_branch = antisym * (0.5 * (1.0 + theta2_smooth / 6.0))[..., None]
    generic = antisym * (theta / (2.0 * torch.sin(theta)))[..., None]

    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(B.shape[:-1] + (1,)))[..., 0]
    col_norm = torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True) + 1e-12)
    axis = col / col_norm
    sgn = torch.sign(torch.sum(axis * antisym, dim=-1, keepdim=True))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    sin_theta_pi = 0.5 * torch.sqrt(torch.sum(antisym * antisym, dim=-1) + 1e-14)
    theta_pi = math.pi - torch.arcsin(torch.clamp(sin_theta_pi, 0.0, 1.0 - _ACOS_EPS))
    pi_branch = axis * sgn * theta_pi[..., None]

    out = torch.where(small[..., None], small_branch, generic)
    return torch.where(near_pi[..., None], pi_branch, out)


def so3_left_jacobian_inv(w):
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _SMALL_SQ
    half = 0.5 * torch.sqrt(torch.clamp(theta2, min=_SMALL_SQ))
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / torch.clamp(theta2, min=_SMALL_SQ))
    K = so3_hat(w)
    return _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


def orthonormalize(R):
    """Project a near-rotation back onto SO(3): two Newton iterations of
    R <- R (3I - R^T R) / 2 (orthogonality error eps -> O(eps^2) each)."""
    eye = _eye_like(R)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R
