"""Two-view relative pose: rotation-compensated epipolar translation solve
(port of `vislam_tpu/frontend/pose.py`).

For matched rays x_i, x_j and the relative rotation R_ji, every epipolar
normal n = x_j x (R_ji x_i) is orthogonal to the translation direction t.
RANSAC draws H hypotheses t = n_a x n_b, scores all of them at once against
all M normals, and refines the winner as the smallest eigenvector of the
inlier scatter matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from vislam_tpu_torch.ops.threefry_kernel import FrameKey, draw_categorical, threefry_gumbel


class TranslationEstimate(NamedTuple):
    t_dir: torch.Tensor        # (3,) unit translation direction, frame-j coords
    inlier_mask: torch.Tensor  # (M,) bool
    num_inliers: torch.Tensor  # () int32
    score: torch.Tensor        # () float32 (inlier fraction among valid)


def epipolar_normals(rays_i, rays_j, R_ji):
    """n = x_j x (R_ji x_i), normalized; also returns |n|. rays: (M, 3)."""
    rot = rays_i @ R_ji.T
    n = torch.linalg.cross(rays_j, rot, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-12), norm[..., 0]


def epipolar_inlier_mask(rays_i, rays_j, R_ji, t_dir, thresh: float):
    """|n . t| < thresh on normalized epipolar normals."""
    n, _ = epipolar_normals(rays_i, rays_j, R_ji)
    return torch.abs(n @ t_dir) < thresh


def rotation_compensated_disparity(uv_i, uv_j, mask, R_ji, fx, fy, cx, cy):
    """Mean pixel displacement of the matches after removing the motion the
    rotation alone predicts (infinite-depth homography K R K^-1)."""
    x = (uv_i[:, 0] - cx) / fx
    y = (uv_i[:, 1] - cy) / fy
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    warped = rays @ R_ji.T
    wz = warped[:, 2]
    z = torch.clamp(wz.abs(), min=1e-9) * torch.sign(
        torch.where(wz == 0, torch.ones_like(wz), wz))
    u_pred = warped[:, 0] / z * fx + cx
    v_pred = warped[:, 1] / z * fy + cy
    d = torch.sqrt((uv_j[:, 0] - u_pred) ** 2 + (uv_j[:, 1] - v_pred) ** 2)
    w = mask.to(d.dtype)
    return torch.sum(d * w) / torch.clamp(torch.sum(w), min=1.0)


# The translation RANSAC's two draws: split(key) -> (ka, kb).
SPLIT_PATHS = ((0,), (1,))


def gumbel_noise(key: torch.Tensor, num_hyps: int, M: int):
    """(2, H, M) Gumbel noise of the translation RANSAC's two draws under
    `key` ((2,) int32 on the draws' device), as the reference draws them:
    ka, kb = split(key), then categorical(ka / kb, logits, shape=(H,)),
    which is argmax(logits + gumbel(k, (H, M))) (the Gumbel-max trick).
    `ransac_translation(key=...)` draws the same indices without the
    noise (`draw_categorical`)."""
    return threefry_gumbel(key.reshape(1, 2), None, SPLIT_PATHS, (num_hyps, M))[0]


def smallest_eigvec_sym3(S):
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3.

    Closed form, in float64, with no host sync (torch.linalg.eigh checks
    its solver status on the host): the smallest eigenvalue by the
    trigonometric formula, then the largest cross product of two rows of
    S - lambda I. The sign is arbitrary; callers orient it.
    """
    A = S.double()
    q = torch.diagonal(A).sum() / 3.0
    p1 = A[0, 1] ** 2 + A[0, 2] ** 2 + A[1, 2] ** 2
    p2 = ((A[0, 0] - q) ** 2 + (A[1, 1] - q) ** 2 + (A[2, 2] - q) ** 2
          + 2.0 * p1)
    p = torch.sqrt(p2 / 6.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Bm = (A - q * eye) / torch.clamp(p, min=1e-300)
    det = (Bm[0, 0] * (Bm[1, 1] * Bm[2, 2] - Bm[1, 2] * Bm[2, 1])
           - Bm[0, 1] * (Bm[1, 0] * Bm[2, 2] - Bm[1, 2] * Bm[2, 0])
           + Bm[0, 2] * (Bm[1, 0] * Bm[2, 1] - Bm[1, 1] * Bm[2, 0]))
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = A - lam * eye
    c = torch.stack([torch.linalg.cross(M[0], M[1], dim=-1),
                     torch.linalg.cross(M[0], M[2], dim=-1),
                     torch.linalg.cross(M[1], M[2], dim=-1)])
    cn = torch.linalg.vector_norm(c, dim=-1)
    best = torch.argmax(cn).reshape(1)
    v = c.index_select(0, best)[0] / torch.clamp(cn.index_select(0, best)[0], min=1e-300)
    # S = q I (all eigenvalues equal): every vector is an eigenvector.
    v = torch.where(p > 0, v, eye[0])
    return v.to(S.dtype)


def ransac_translation(
    rays_i,
    rays_j,
    R_ji,
    mask,
    key: Optional[torch.Tensor | FrameKey] = None,
    num_hyps: int = 512,
    thresh: float = 0.02,
    uv_i=None,
    dispersion_pow: float = 0.0,
    noise=None,
) -> TranslationEstimate:
    """Vectorized RANSAC for the translation direction.

    rays_*: (M, 3); R_ji from the IMU; mask: (M,) valid matches. The
    hypotheses come from `noise` ((2, H, M) Gumbel) or are drawn under
    `key` ((2,) int32, the reference's key: the same hypotheses; or a
    FrameKey, folded on the device), categorical(split(key)[0 | 1],
    logits, shape=(H,)) in one launch of the draw kernel.

    dispersion_pow > 0 (needs uv_i (M, 2)): score = inliers x (spatial
    std of the inlier set)^pow, which favours the spread-out static mode
    over compact clusters of independently moving points.
    """
    n, n_norm = epipolar_normals(rays_i, rays_j, R_ji)
    w = mask.float() * (n_norm > 1e-5).float()

    logits = torch.log(w + 1e-9)
    if noise is None:
        idx_a, idx_b = draw_categorical(key, SPLIT_PATHS, logits, (num_hyps,))
    else:
        idx_a = torch.argmax(logits + noise[0], dim=-1)
        idx_b = torch.argmax(logits + noise[1], dim=-1)
    t_hyp = torch.linalg.cross(n[idx_a], n[idx_b], dim=-1)  # (H, 3)
    t_norm = torch.linalg.vector_norm(t_hyp, dim=-1, keepdim=True)
    t_hyp = t_hyp / torch.clamp(t_norm, min=1e-12)
    hyp_ok = (t_norm[:, 0] > 1e-6) & (idx_a != idx_b)

    resid = torch.abs(t_hyp @ n.T)  # (H, M)
    inl_tab = (resid < thresh).float() * w[None, :]
    votes = torch.sum(inl_tab, dim=1)
    if dispersion_pow > 0.0 and uv_i is not None:
        ext = torch.stack([uv_i[:, 0].max() + 1.0, uv_i[:, 1].max() + 1.0])
        uvn = uv_i / ext
        nv = torch.clamp(votes, min=1.0)[:, None]
        mu = (inl_tab @ uvn) / nv
        second = (inl_tab @ (uvn * uvn)) / nv
        disp = torch.sqrt(torch.clamp(torch.sum(second - mu * mu, -1), min=1e-12))
        score = votes * disp ** dispersion_pow
    else:
        score = votes
    score = torch.where(hyp_ok, score, torch.full_like(score, -1.0))
    # index_select with a 1-element index: indexing by a 0-d tensor would
    # convert it to a Python int, a host sync.
    t_best = t_hyp.index_select(0, torch.argmax(score).reshape(1))[0]

    # Refine: smallest eigenvector of the inlier scatter sum n n^T.
    inl = (torch.abs(n @ t_best) < thresh) & (w > 0)
    wi = inl.float()
    S = torch.einsum("m,mi,mj->ij", wi, n, n)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    t_ref = smallest_eigvec_sym3(S + 1e-9 * eye)
    # Keep orientation consistent with the RANSAC winner.
    t_ref = t_ref * torch.sign(torch.sum(t_ref * t_best) + 1e-12)

    inl_ref = (torch.abs(n @ t_ref) < thresh) & (w > 0)
    num = torch.sum(inl_ref)
    valid = torch.clamp(torch.sum(w), min=1.0)
    return TranslationEstimate(
        t_dir=t_ref,
        inlier_mask=inl_ref,
        num_inliers=num.to(torch.int32),
        score=num.float() / valid,
    )


def resolve_direction_sign(rays_i, rays_j, R_ji, t_dir, inlier_mask):
    """Pick the sign of t so triangulated depths are positive: majority vote
    of the two-ray midpoint depth along x_j over the inliers."""
    rot = rays_i @ R_ji.T
    a = torch.sum(rot * rot, -1)
    b = -torch.sum(rot * rays_j, -1)
    c = torch.sum(rays_j * rays_j, -1)
    rhs1 = -torch.sum(rot * t_dir[None, :], -1)
    rhs2 = torch.sum(rays_j * t_dir[None, :], -1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    dj = (a * rhs2 - b * rhs1) / det
    w = inlier_mask.float()
    pos = torch.sum((dj > 0).float() * w)
    neg = torch.sum((dj < 0).float() * w)
    return torch.where(pos >= neg, t_dir, -t_dir)
