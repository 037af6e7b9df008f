"""Sim(3) similarity transforms (R, t, s) acting as X -> s R X + t (port of
`vislam_tpu/lie/sim3.py`), for the 7-DoF pose graph that spreads a
monocular loop's scale error along the trajectory.

Tangent layout [rho(3), phi(3), sigma(1)]: translation, rotation,
log-scale. Exp's W matrix is exact in float32 (series where the
reference's closed forms cancel; a deliberate difference from the
reference, held against its float64 W).
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.so3 import so3_exp, so3_hat, so3_log

_SMALL = 1e-6
# W's series: below max(theta, |sigma|) = _SERIES, to degree _SERIES_TERMS - 1.
_SERIES = 0.5
_SERIES_TERMS = 9


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
    W = A0 I + A hat(phi) + B hat(phi)^2 with A0, A, B the integrals over
    u in [0, 1] of e^(sigma u) times 1, sin(theta u) / theta and
    (1 - cos(theta u)) / theta^2.

    Exact in float32, unlike the reference's, whose closed forms cancel
    for theta or sigma between its switch (1e-6) and ~1e-2 (W off by up to
    ~5e-2 at sigma = 1e-6). Below `_SERIES` (max(theta, |sigma|) < 0.5) A0,
    A and B are their Taylor series in sigma and theta^2 to degree
    `_SERIES_TERMS` - 1 = 8, whose truncation moves W by at most 1.8e-8
    there (float64, against 40 terms); A0 is its series in sigma for
    |sigma| < 0.5 whatever theta. Elsewhere the
    reference's formulas, which are exact there (W within 3.0e-7 of its
    float64 value over theta, |sigma| in {0} u [1e-8, 1] and rotations near
    pi: `tests/test_torch_map_lie.py`). Every branch is computed on
    guarded inputs and selected with `torch.where`, so forward-mode AD at 0
    sees finite tangents in the branches it does not select."""
    one = torch.ones_like(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_SMALL ** 2))
    small_theta = theta2 < _SMALL ** 2
    small_sigma = torch.abs(sigma) < _SERIES
    series = small_sigma & (theta < _SERIES)

    # The series: with (sigma + i theta)^n = P_n + i theta Q_n and
    # R_n = (sigma^n - P_n) / theta^2, A0 = sum sigma^n / (n + 1)!,
    # A = sum Q_n / (n + 1)!, B = sum R_n / (n + 1)!. The terms
    # v_n = [sigma^n, P_n, Q_n, R_n] follow v_{n+1} = M v_n, one small
    # product a term (few launches on the card).
    zero = torch.zeros_like(sigma)
    M = torch.stack([torch.stack([sigma, zero, zero, zero], -1),
                     torch.stack([zero, sigma, -theta2, zero], -1),
                     torch.stack([zero, one, sigma, zero], -1),
                     torch.stack([zero, zero, one, sigma], -1)], -2)
    v = torch.stack([one, one, zero, zero], -1)[..., None]
    terms = torch.zeros_like(v)
    fact = 1.0
    for n in range(_SERIES_TERMS):
        fact *= n + 1
        terms = terms + v / fact
        v = M @ v
    A0_ser, _, A_ser, B_ser = terms[..., 0].unbind(-1)

    s_exp = torch.exp(sigma)
    safe_sigma = torch.where(small_sigma, one, sigma)
    # The scale integral A0 = (e^sigma - 1) / sigma.
    A0 = torch.where(small_sigma, A0_ser, (s_exp - 1.0) / safe_sigma)

    safe_theta = torch.where(small_theta, one, theta)
    sin_t = torch.sin(safe_theta)
    cos_t = torch.cos(safe_theta)
    sig2t2 = sigma * sigma + safe_theta * safe_theta

    # theta above the switch or sigma away from 0.
    a_gen = (s_exp * sin_t * sigma + (1.0 - s_exp * cos_t) * safe_theta) / (
        safe_theta * sig2t2)
    b_gen = (A0 - ((s_exp * cos_t - 1.0) * sigma + s_exp * sin_t * safe_theta)
             / sig2t2) / (safe_theta * safe_theta)
    # theta below the reference's switch, |sigma| >= 0.5: the limits theta -> 0.
    a_th0 = ((safe_sigma - 1.0) * s_exp + 1.0) / (safe_sigma ** 2)
    b_th0 = (s_exp * 0.5 * safe_sigma ** 2 + s_exp - 1.0 - safe_sigma * s_exp) / (safe_sigma ** 3)

    A = torch.where(series, A_ser, torch.where(small_theta, a_th0, a_gen))
    B = torch.where(series, B_ser, torch.where(small_theta, b_th0, b_gen))

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
