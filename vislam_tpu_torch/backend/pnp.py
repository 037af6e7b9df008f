"""PnP (3D-2D) pose solve by Gauss-Newton on SE(3) (port of
`vislam_tpu/backend/pnp.py`): the metric measurement of loop closures and
relocalization. All points in one fixed-shape batch, Huber weights,
degenerate rows masked; the reference's `fori_loop` is a Python loop of
`iters` steps, the 6x6 solve `solve_ex` (a failed solve keeps the pose),
so the solve makes no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.lie.se3 import se3_exp
from vislam_tpu_torch.lie.so3 import orthonormalize, so3_hat


class PnPResult(NamedTuple):
    R: torch.Tensor            # (3, 3) source -> target camera rotation
    t: torch.Tensor            # (3,)
    inlier_mask: torch.Tensor  # (N,)
    num_inliers: torch.Tensor  # () int32
    rmse: torch.Tensor         # () float32 pixel RMSE over the inliers


def pnp_gn(X, uv, mask, R0, t0, fx, fy, cx, cy, iters: int = 12, huber_px: float = 3.0,
           inlier_px: float = 5.0) -> PnPResult:
    """Minimize the Huber reprojection error of R X + t over SE(3), from
    (R0, t0). X (N, 3) source-frame points, uv (N, 2) their observations in
    the target camera, mask (N,) the valid correspondences."""

    def residuals(R, t):
        Xc = X @ R.T + t
        z = Xc[:, 2]
        ok = mask & (z > 1e-3)
        safe_z = torch.where(z > 1e-3, z, torch.full_like(z, 1e-3))
        u = fx * Xc[:, 0] / safe_z + cx
        v = fy * Xc[:, 1] / safe_z + cy
        return torch.stack([u, v], -1) - uv, Xc, ok

    R, t = R0, t0
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r, Xc, ok = residuals(R, t)
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(rn <= huber_px, torch.ones_like(rn),
                        huber_px / torch.clamp(rn, min=1e-9))
        w = w * ok.to(r.dtype)

        z = torch.where(Xc[:, 2] > 1e-3, Xc[:, 2], torch.full_like(Xc[:, 2], 1e-3))
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        A = torch.stack([torch.stack([fx * iz, zero, -fx * Xc[:, 0] * iz2], -1),
                         torch.stack([zero, fy * iz, -fy * Xc[:, 1] * iz2], -1)], dim=-2)
        J = torch.cat([A, -torch.einsum("nab,nbc->nac", A, so3_hat(Xc))], dim=-1)  # (N,2,6)
        H = torch.einsum("n,nai,naj->ij", w, J, J) + 1e-6 * eye6
        b = -torch.einsum("n,nai,na->i", w, J, r)
        dxi, info = torch.linalg.solve_ex(H, b)
        good = (info == 0) & torch.isfinite(dxi).all()
        dR, dt = se3_exp(dxi)
        R = torch.where(good, orthonormalize(dR @ R), R)
        t = torch.where(good, dR @ t + dt, t)

    r, Xc, ok = residuals(R, t)
    rn = torch.linalg.vector_norm(r, dim=-1)
    inl = ok & (rn < inlier_px)
    n = torch.sum(inl)
    rmse = torch.sqrt(torch.sum(torch.where(inl, rn * rn, torch.zeros_like(rn)))
                      / torch.clamp(n, min=1))
    return PnPResult(R=R, t=t, inlier_mask=inl, num_inliers=n.to(torch.int32), rmse=rmse)
