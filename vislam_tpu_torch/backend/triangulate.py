"""Two-view triangulation (port of `vislam_tpu/backend/triangulate.py`):
the midpoint method the step and the loop measurement use, and the
homogeneous DLT."""

from __future__ import annotations

import torch


def triangulate_midpoint(rays_i, rays_j, R_ji, t_ji):
    """Midpoint triangulation in frame i.

    d_j x_j = d_i (R_ji x_i) + t_ji: solve the 2x2 normal equations for
    (d_i, d_j) per match; the point is the midpoint of the two closest
    points. R_ji (3,3), t_ji (3,) serve every ray pair, or R_ji (M,3,3),
    t_ji (M,3) give each pair its own. Returns (X_i (M,3), depth_i (M,),
    depth_j (M,), gap (M,)).

    det = ac - b^2 cancels for near-parallel rays. The reference, as XLA's
    CPU compiler builds it on a host with FMA, fuses multiply-adds there
    (det = fma(a, c, -(b b)), each 3-term dot an FMA chain); this function
    rounds each product, as the reference's compile without FMA
    (`--xla_cpu_max_isa=AVX`) does. Where det < 1e-3 the depths therefore
    differ between the reference's two compiles and this function alike.
    """
    rot = torch.einsum("...ij,...j->...i", R_ji, rays_i)
    a = torch.sum(rot * rot, -1)
    b = -torch.sum(rot * rays_j, -1)
    c = torch.sum(rays_j * rays_j, -1)
    rhs1 = -torch.sum(rot * t_ji, -1)
    rhs2 = torch.sum(rays_j * t_ji, -1)
    det = a * c - b * b
    safe_det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    d_i = (c * rhs1 - b * rhs2) / safe_det
    d_j = (a * rhs2 - b * rhs1) / safe_det

    p_on_i = d_i[:, None] * rot + t_ji
    p_on_j = d_j[:, None] * rays_j
    gap = torch.linalg.vector_norm(p_on_i - p_on_j, dim=-1)
    mid_j = 0.5 * (p_on_i + p_on_j)
    X_i = torch.einsum("...ji,...j->...i", R_ji, mid_j - t_ji)
    return X_i, d_i, d_j, gap


def triangulate_dlt(uv_i, uv_j, P_i, P_j):
    """Homogeneous DLT triangulation (cv::triangulatePoints semantics).

    uv_*: (M, 2) pixel coords; P_*: (3, 4) projection matrices. Returns
    (M, 3) points (dehomogenized). The smallest eigenvector of each A^T A
    comes from `torch.linalg.eigh`, which waits for the device on CUDA (it
    checks its solver's status on the host); no path of the port calls
    this function.
    """
    def rows(uv, P):
        return uv[:, 0:1] * P[2:3, :] - P[0:1, :], uv[:, 1:2] * P[2:3, :] - P[1:2, :]

    A = torch.stack([*rows(uv_i, P_i), *rows(uv_j, P_j)], dim=1)  # (M, 4, 4)
    _, vecs = torch.linalg.eigh(torch.einsum("mij,mik->mjk", A, A))
    Xh = vecs[..., 0]
    w = Xh[:, 3:4]
    safe_w = torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    return Xh[:, :3] / safe_w
