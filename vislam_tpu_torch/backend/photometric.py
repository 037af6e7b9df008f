"""Coarse-to-fine photometric (direct) pose alignment (port of
`vislam_tpu/backend/photometric.py`).

Points of frame i with a depth are warped by the current estimate of
T_ji = (R, t) (X_j = R X_i + t) into frame j; the intensity residuals drive
a 6-DoF Gauss-Newton update (per point the image gradient times the
projection Jacobian, twist [rho, phi], left-multiplicative), Tukey-weighted
with a MAD scale, from the coarsest level to the finest.

Every point is handled at once: bilinear samples are `torch.gather`s of
the flattened image, the normal equations one einsum each. The level loop
and the iteration loop are static Python loops (the reference's
fori_loop), and nothing reads a device value on the host: the MAD's median
is gathered at a device index, and the 6x6 solve is `torch.linalg.solve_ex`
whose failure gives NaN, so the update is dropped (the reference's
`step_ok`) and nothing raises.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from vislam_tpu_torch.frontend.pyramid import scharr_gradients
from vislam_tpu_torch.lie.se3 import se3_exp
from vislam_tpu_torch.lie.so3 import so3_hat


class PhotoResult(NamedTuple):
    R: torch.Tensor            # (3, 3) refined rotation
    t: torch.Tensor            # (3,) refined translation
    final_error: torch.Tensor  # () mean robust residual
    num_valid: torch.Tensor    # () int32 points in view at the finest level


def _bilinear(img, uv):
    """Bilinear sample of img (H, W) at uv (P, 2); returns (value, valid)."""
    H, W = img.shape
    u, v = uv[..., 0], uv[..., 1]
    valid = (u >= 0) & (u < W - 1.001) & (v >= 0) & (v < H - 1.001)
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0
    dv = v - v0
    flat = img.reshape(-1)

    def take(vi, ui):
        return torch.gather(flat, 0, vi * W + ui)

    val = (take(v0, u0) * (1 - du) * (1 - dv)
           + take(v0, u0 + 1) * du * (1 - dv)
           + take(v0 + 1, u0) * (1 - du) * dv
           + take(v0 + 1, u0 + 1) * du * dv)
    return val, valid


def _median_valid(x, n_valid):
    """Element (n_valid - 1) // 2 of x sorted (invalid entries sorted last),
    read at a device index."""
    idx = torch.div(n_valid - 1, 2, rounding_mode="floor").reshape(1)
    return torch.gather(torch.sort(x).values, 0, idx)[0]


def _tukey_weights(r, mask, c_factor: float = 4.6851):
    """Tukey biweight with a MAD scale over the valid residuals (invalid
    entries at 1e9, so they sort last and are never the median)."""
    n_valid = torch.clamp(torch.sum(mask), min=1)
    big = torch.full_like(r, 1e9)
    med = _median_valid(torch.where(mask, torch.abs(r), big), n_valid)
    mad = _median_valid(torch.where(mask, torch.abs(torch.abs(r) - med), big), n_valid)
    sigma = 1.4826 * torch.clamp(mad, min=1e-3)
    x = r / (c_factor * sigma)
    w = torch.where(torch.abs(x) < 1.0, (1.0 - x * x) ** 2, torch.zeros_like(x))
    return w * mask.to(r.dtype)


def photometric_align(pyr_i: Sequence[torch.Tensor], pyr_j: Sequence[torch.Tensor],
                      points_uv, depths, mask, R0, t0, fx: float, fy: float, cx: float,
                      cy: float, levels: Sequence[int] = (3, 2, 1, 0),
                      iters_per_level: int = 10, robust: bool = True) -> PhotoResult:
    """Direct alignment of frame j to frame i over the candidate points.

    pyr_i, pyr_j: image pyramids (level 0 first); points_uv (P, 2) level-0
    pixels of frame i with depths (P,) and mask (P,) bool; R0 (3, 3), t0
    (3,) the initial T_ji. Returns the refined (R, t), the final mean
    robust residual and the points in view at the last iteration.
    """
    dev = points_uv.device
    x = (points_uv[:, 0] - cx) / fx
    y = (points_uv[:, 1] - cy) / fy
    X_i = torch.stack([x * depths, y * depths, depths], -1)   # (P, 3)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    R, t = R0, t0
    final_err = torch.zeros((), dtype=torch.float32, device=dev)
    num_valid = torch.zeros((), dtype=torch.int32, device=dev)

    for lvl in levels:
        s = 0.5 ** lvl
        fxl, fyl, cxl, cyl = fx * s, fy * s, cx * s, cy * s
        img_i, img_j = pyr_i[lvl].float(), pyr_j[lvl].float()
        gx_j, gy_j = scharr_gradients(img_j)
        I_ref, ref_ok = _bilinear(img_i, points_uv * s)
        base_mask = mask & ref_ok
        for _ in range(iters_per_level):
            X_j = X_i @ R.T + t
            z = X_j[:, 2]
            behind = z <= 1e-3
            iz = 1.0 / torch.where(behind, torch.full_like(z, 1e-3), z)
            uvw = torch.stack([X_j[:, 0] * iz * fxl + cxl, X_j[:, 1] * iz * fyl + cyl], -1)
            I_cur, in_view = _bilinear(img_j, uvw)
            gxs, _ = _bilinear(gx_j, uvw)
            gys, _ = _bilinear(gy_j, uvw)
            ok = base_mask & in_view & ~behind
            r = (I_cur - I_ref) * ok.to(I_cur.dtype)
            w = _tukey_weights(r, ok) if robust else ok.to(r.dtype)

            # J = [gx, gy] dpi/dX_j [I | -hat(X_j)]  -> (P, 6)
            iz2 = iz * iz
            a1 = gxs * fxl * iz
            a2 = gys * fyl * iz
            a3 = -(gxs * fxl * X_j[:, 0] + gys * fyl * X_j[:, 1]) * iz2
            Jx = torch.stack([a1, a2, a3], -1)
            Jpose = torch.cat([Jx, -torch.einsum("pi,pij->pj", Jx, so3_hat(X_j))], -1)
            H = torch.einsum("p,pi,pj->ij", w, Jpose, Jpose) + 1e-4 * eye6
            b = -torch.einsum("p,pi,p->i", w, Jpose, r)
            dxi, info = torch.linalg.solve_ex(H, b)
            dxi = torch.where(info == 0, dxi, torch.full_like(dxi, float("nan")))
            dR, dt = se3_exp(dxi)
            step_ok = torch.isfinite(dxi).all()
            R = torch.where(step_ok, dR @ R, R)
            t = torch.where(step_ok, dR @ t + dt, t)
            final_err = torch.sum(w * r * r) / torch.clamp(torch.sum(w), min=1e-6)
            num_valid = torch.sum(ok).to(torch.int32)

    return PhotoResult(R=R, t=t, final_error=final_err, num_valid=num_valid)
