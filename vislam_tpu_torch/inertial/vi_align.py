"""Visual-inertial alignment: linear initialization of scale, gravity and
velocities from up-to-scale vision poses + IMU preintegration (port of
`vislam_tpu/inertial/vi_align.py`).

For keyframes k with body->world rotations R_wb_k, up-to-scale positions
pbar_k and preintegrated factors (dv_k, dp_k, dt_k) between k and k+1,

  s (pbar_{k+1} - pbar_k) = v_k dt_k + 1/2 g dt_k^2 + R_wb_k dp_k
  v_{k+1}                 = v_k + g dt_k + R_wb_k dv_k

are linear in x = [v_0..v_{K-1}, g, s]: one dense least-squares solve. The
interval rows are built by index arithmetic (one-hot slot selectors), and
the normal equations are solved with `solve_ex`: a singular system gives
non-finite values, as the reference's `jnp.linalg.solve` does, never an
exception or a host sync, and the callers' gates reject them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VIAlignment(NamedTuple):
    scale: torch.Tensor       # ()
    gravity: torch.Tensor     # (3,) world gravity vector
    velocities: torch.Tensor  # (K, 3) world-frame velocity at each keyframe
    residual: torch.Tensor    # () RMS of the stacked equations at the solution


def _interval_blocks(K: int, like: torch.Tensor):
    """(K-1, 3, 3K) selectors: I3 at the columns of slot k, and of k+1."""
    dev = like.device
    k = torch.arange(K - 1, device=dev)[:, None]
    slots = torch.arange(K, device=dev)[None, :]
    eye3 = torch.eye(3, dtype=like.dtype, device=dev)

    def kron(sel):
        return (sel.to(like.dtype)[:, None, :, None] * eye3[None, :, None, :]) \
            .reshape(K - 1, 3, 3 * K)

    return kron(slots == k), kron(slots == k + 1), eye3


def _lstsq(A_pos, A_vel, b_pos, b_vel, m):
    """Stack the masked rows, solve the normal equations; (x, rms)."""
    n = A_pos.shape[-1]
    w = m[:, None, None]
    A = (torch.cat([A_pos, A_vel], dim=1) * w).reshape(-1, n)
    b = (torch.cat([b_pos, b_vel], dim=1) * m[:, None]).reshape(-1)
    AtA = A.T @ A + 1e-8 * torch.eye(n, dtype=A.dtype, device=A.device)
    x, info = torch.linalg.solve_ex(AtA, A.T @ b)
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    r = A @ x - b
    return x, torch.sqrt(torch.mean(r * r))


def vi_align(R_wb, pbar, dv, dp, dt, mask=None) -> VIAlignment:
    """Free-gravity alignment. R_wb (K,3,3), pbar (K,3); dv, dp (K-1,3), dt
    (K-1,) per interval; mask (K-1,) valid intervals."""
    K = R_wb.shape[0]
    m = mask.to(R_wb.dtype) if mask is not None else torch.ones_like(dt)
    blk_i, blk_j, eye3 = _interval_blocks(K, R_wb)
    dtk = dt[:, None, None]
    zero = torch.zeros((K - 1, 3, 1), dtype=R_wb.dtype, device=R_wb.device)
    A_pos = torch.cat([-dtk * blk_i, -0.5 * dtk * dtk * eye3,
                       (pbar[1:] - pbar[:-1])[:, :, None]], dim=-1)
    A_vel = torch.cat([blk_j - blk_i, -dtk * eye3, zero], dim=-1)
    b_pos = torch.einsum("kij,kj->ki", R_wb[:-1], dp)
    b_vel = torch.einsum("kij,kj->ki", R_wb[:-1], dv)
    x, rms = _lstsq(A_pos, A_vel, b_pos, b_vel, m)
    return VIAlignment(scale=x[3 * K + 3], gravity=x[3 * K:3 * K + 3],
                       velocities=x[:3 * K].reshape(K, 3), residual=rms)


def refine_gravity(align: VIAlignment, g_norm: float = 9.81) -> VIAlignment:
    """Project the recovered gravity onto the known magnitude."""
    g = align.gravity
    return align._replace(
        gravity=g * (g_norm / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)))


def vi_align_fixed_gravity(R_wb, pbar, dv, dp, dt, g_w, mask=None) -> VIAlignment:
    """Alignment with the world gravity g_w (3,) known: unknowns
    [v_0..v_{K-1}, s] only (the variant the engine bootstrap applies)."""
    K = R_wb.shape[0]
    m = mask.to(R_wb.dtype) if mask is not None else torch.ones_like(dt)
    blk_i, blk_j, _ = _interval_blocks(K, R_wb)
    dtk = dt[:, None, None]
    zero = torch.zeros((K - 1, 3, 1), dtype=R_wb.dtype, device=R_wb.device)
    A_pos = torch.cat([-dtk * blk_i, (pbar[1:] - pbar[:-1])[:, :, None]], dim=-1)
    A_vel = torch.cat([blk_j - blk_i, zero], dim=-1)
    b_pos = torch.einsum("kij,kj->ki", R_wb[:-1], dp) + 0.5 * dt[:, None] * dt[:, None] * g_w
    b_vel = torch.einsum("kij,kj->ki", R_wb[:-1], dv) + dt[:, None] * g_w
    x, rms = _lstsq(A_pos, A_vel, b_pos, b_vel, m)
    return VIAlignment(scale=x[3 * K], gravity=g_w, velocities=x[:3 * K].reshape(K, 3),
                       residual=rms)
