"""Sim(3) similarity transforms (R, t, s) acting as X -> s R X + t (port of
`vislam_tpu/lie/sim3.py`), for the 7-DoF pose graph that spreads a
monocular loop's scale error along the trajectory.

Tangent layout [rho(3), phi(3), sigma(1)]: translation, rotation,
log-scale. The small-theta and small-sigma regimes of exp's W matrix are
all computed on guarded inputs (the reference's safe denominators) and
selected with `torch.where`, so forward-mode AD at 0 sees finite tangents
in the branches it does not select.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.so3 import so3_exp, so3_hat, so3_log

_SMALL = 1e-6


def sim3_identity(dtype=torch.float32, *, device="cuda"):
    return (torch.eye(3, dtype=dtype, device=device), torch.zeros(3, dtype=dtype, device=device),
            torch.ones((), dtype=dtype, device=device))


def sim3_compose(A, B):
    """A after B: X -> A(B(X))."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return Ra @ Rb, t, sa * sb


def sim3_inverse(T):
    R, t, s = T
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0], inv_s


def sim3_apply(T, X):
    R, t, s = T
    return s[..., None] * (R @ X[..., None])[..., 0] + t


def _sim3_W(phi, sigma):
    """The W of Sim(3) exp, t = W rho (Sophus sim3.hpp::calcW):
    W = A0 I + A hat(phi) + B hat(phi)^2, the coefficients by regime of
    (theta, sigma)."""
    one = torch.ones_like(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_SMALL ** 2))
    small_theta = theta2 < _SMALL ** 2
    small_sigma = torch.abs(sigma) < _SMALL

    s_exp = torch.exp(sigma)
    safe_sigma = torch.where(small_sigma, one, sigma)
    # The scale integral A0 = (e^sigma - 1) / sigma.
    A0 = torch.where(small_sigma, 1.0 + 0.5 * sigma, (s_exp - 1.0) / safe_sigma)

    safe_theta = torch.where(small_theta, one, theta)
    sin_t = torch.sin(safe_theta)
    cos_t = torch.cos(safe_theta)
    sig2t2 = safe_sigma * safe_sigma + safe_theta * safe_theta

    # Both regular.
    a_gen = (s_exp * sin_t * safe_sigma + (1.0 - s_exp * cos_t) * safe_theta) / (
        safe_theta * sig2t2)
    b_gen = (A0 - ((s_exp * cos_t - 1.0) * safe_sigma + s_exp * sin_t * safe_theta)
             / sig2t2) / (safe_theta * safe_theta)
    # sigma small: SO(3)'s left-Jacobian coefficients.
    a_sig0 = (1.0 - cos_t) / (safe_theta * safe_theta)
    b_sig0 = (safe_theta - sin_t) / (safe_theta ** 3)
    # theta small: the series in theta.
    a_th0 = torch.where(small_sigma, 0.5 * one,
                        ((safe_sigma - 1.0) * s_exp + 1.0) / (safe_sigma ** 2))
    b_th0 = torch.where(
        small_sigma, one / 6.0,
        (s_exp * 0.5 * safe_sigma ** 2 + s_exp - 1.0 - safe_sigma * s_exp) / (safe_sigma ** 3))

    A = torch.where(small_theta, a_th0, torch.where(small_sigma, a_sig0, a_gen))
    B = torch.where(small_theta, b_th0, torch.where(small_sigma, b_sig0, b_gen))

    K = so3_hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A0[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi):
    """(...,7) [rho, phi, sigma] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return so3_exp(phi), t, torch.exp(sigma)


def sim3_log(T):
    """(R, t, s) -> (...,7) [rho, phi, sigma]."""
    R, t, s = T
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
