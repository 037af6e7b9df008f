"""Essential-matrix estimation: vectorised 8-point RANSAC and pose recovery
(port of `vislam_tpu/frontend/essential.py`), the rotation and translation
direction of vision-only runs (no IMU: KITTI).

H hypotheses are solved at once, each the smallest eigenvector of the
(9, 9) Gram matrix of 8 random correspondences, and scored against all M
matches with one (H, 9) x (9, M) product of algebraic epipolar residuals.
The winner is refit twice on its inliers, then decomposed into its 4
(R, t) candidates, of which a cheirality vote keeps one.

No host sync: torch.linalg.eigh and svd check their solver status on the
host, so neither is used. The 9x9 eigenvector is inverse iteration by
repeated squaring (`smallest_eigvec_sym`), the 3x3 SVD comes from the
closed-form symmetric eigenproblem of E^T E (`_svd3_proper`). Eigenvector
signs differ from the reference's LAPACK ones; no result depends on them
(the inlier test takes |residual|, and the candidate set of E and of -E,
or of any sign choice of the singular vectors, is the same).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from vislam_tpu_torch.lie.so3 import orthonormalize
from vislam_tpu_torch.ops.threefry_kernel import FrameKey, draw_categorical, threefry_gumbel

# Squarings of the shifted inverse in each of the two phases of
# `smallest_eigvec_sym`.
_SQUARINGS = (10, 5)


class EssentialEstimate(NamedTuple):
    R_ji: torch.Tensor         # (3, 3) rotation frame i -> frame j
    t_dir: torch.Tensor        # (3,) unit translation (frame j), scale-free
    E: torch.Tensor            # (3, 3) essential matrix (sign arbitrary)
    inlier_mask: torch.Tensor  # (M,) bool
    num_inliers: torch.Tensor  # () int32


def gumbel_hypotheses(key: torch.Tensor, num_hyps: int, M: int):
    """(H, 8, M) Gumbel noise under `key` ((2,) int32): the 8
    correspondences of each of H hypotheses, the reference's
    categorical(key, logits, shape=(H, 8)); `ransac_essential(key=...)`
    draws the same indices without the noise (`draw_categorical`)."""
    return threefry_gumbel(key.reshape(1, 2), None, ((),), (num_hyps, 8, M))[0, 0]


def _epipolar_design(rays_i, rays_j):
    """Rows kron(x_j, x_i) (M, 9) of x_j^T E x_i = 0, E row-major."""
    return (rays_j[:, :, None] * rays_i[:, None, :]).reshape(-1, 9)


def _power_by_squaring(X, squarings: int):
    """X ** (2 ** squarings), rescaled after each squaring (no overflow)."""
    for _ in range(squarings):
        X = X / torch.clamp(X.abs().amax(dim=(-2, -1), keepdim=True), min=1e-300)
        X = X @ X
    return X


def smallest_eigvec_sym(G):
    """Unit eigenvector of the smallest eigenvalue of each symmetric
    positive semi-definite (..., n, n), in float64 and without a host sync.

    Inverse iteration on all of R^n at once, in two phases. (1) X = (G + d
    I)^-1, d just above float32 round-off of G, raised to the power 2^10
    by squaring, converges to c v v^T; v is its column with the largest
    diagonal entry. (2) Shifted at v's Rayleigh quotient mu, (G - mu I)^-1
    raised to 2^5 and applied to v, which the eigenvalue nearest mu (the
    smallest) dominates however close the next one is. Where phase 2 is
    not finite (mu hit an eigenvalue exactly), phase 1's v stands. The sign
    is arbitrary.
    """
    A = G.double()
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    X, _ = torch.linalg.inv_ex(A + torch.clamp(1e-7 * tr, min=1e-30) * eye)
    X = _power_by_squaring(X, _SQUARINGS[0])
    col = torch.argmax(torch.diagonal(X, dim1=-2, dim2=-1), dim=-1)
    v = torch.gather(X, -1, col[..., None, None].expand(X.shape[:-1] + (1,)))

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-2, keepdim=True), min=1e-300)

    v = unit(v)
    mu = (v.transpose(-1, -2) @ A @ v)
    Y, _ = torch.linalg.inv_ex(A - mu * eye)
    w = unit(_power_by_squaring(Y, _SQUARINGS[1]) @ v)
    v = torch.where(torch.isfinite(w).all(dim=-2, keepdim=True), w, v)
    return v[..., 0].to(G.dtype)


def _eigvals_sym3(S):
    """Eigenvalues (ascending) of a symmetric 3x3 (float64), trigonometric form."""
    q = torch.diagonal(S).sum() / 3.0
    p1 = S[0, 1] ** 2 + S[0, 2] ** 2 + S[1, 2] ** 2
    p2 = (S[0, 0] - q) ** 2 + (S[1, 1] - q) ** 2 + (S[2, 2] - q) ** 2 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    B = (S - q * eye) / torch.clamp(p, min=1e-300)
    det = (B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
           - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
           + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0]))
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lo, 3.0 * q - hi - lo, hi


def _null_vec3(M):
    """Unit vector spanning the (near) null space of a rank-2 3x3: the
    largest cross product of two of its rows."""
    c = torch.stack([torch.linalg.cross(M[0], M[1], dim=-1),
                     torch.linalg.cross(M[0], M[2], dim=-1),
                     torch.linalg.cross(M[1], M[2], dim=-1)])
    cn = torch.linalg.vector_norm(c, dim=-1)
    best = torch.argmax(cn).reshape(1)
    return c.index_select(0, best)[0] / torch.clamp(cn.index_select(0, best)[0], min=1e-300)


def _unit_perp(a, w):
    """a made orthogonal to the unit w and normalised; where a has no part
    orthogonal to w (a degenerate pair of singular values), the largest
    cross product of w with an axis."""
    a = a - torch.dot(a, w) * w
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    alt = torch.linalg.cross(w.expand(3, 3), eye, dim=-1)
    alt = alt.index_select(0, torch.argmax(torch.linalg.vector_norm(alt, dim=-1)).reshape(1))[0]
    a = torch.where(torch.linalg.vector_norm(a) > 1e-9, a, alt)
    return a / torch.linalg.vector_norm(a)


def _svd3_proper(E):
    """E = U diag(s) V^T with U, V proper rotations (float64 in, float64
    out), from the eigenvectors of E^T E: v2 its null direction, v0 its
    largest (made orthogonal to v2), v1 = v2 x v0, u_k = E v_k normalised
    for k = 0, 1 (u1 made orthogonal to u0), u2 = u0 x u1. The last singular
    value carries the sign that makes both rotations proper; the
    decomposition's candidate poses are those of any SVD with the
    determinant fix."""
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    S = E.T @ E
    lo, _, hi = _eigvals_sym3(S)
    v2 = _null_vec3(S - lo * eye)
    v0 = _unit_perp(_null_vec3(S - hi * eye), v2)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    u0 = E @ v0
    u0 = u0 / torch.clamp(torch.linalg.vector_norm(u0), min=1e-300)
    u1 = _unit_perp(E @ v1, u0)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    return torch.stack([u0, u1, u2], -1), torch.stack([v0, v1, v2], -1)


def _decompose_essential(E, rays_i, rays_j, weights):
    """The 4 (R, t) candidates of E and the cheirality vote: the candidate
    with the most weighted matches of positive midpoint depth in both
    views (the first one on a tie)."""
    U, V = _svd3_proper(E.double())
    u0, u1, u2 = U.unbind(-1)
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], by columns
    # (a constant matrix made from Python numbers would be a blocking copy).
    R1 = (torch.stack([u1, -u0, u2], -1) @ V.T).to(E.dtype)
    R2 = (torch.stack([-u1, u0, u2], -1) @ V.T).to(E.dtype)
    t = u2.to(E.dtype)
    cands_R = torch.stack([R1, R1, R2, R2])      # (4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t])         # (4, 3)

    rot = torch.einsum("cij,mj->cmi", cands_R, rays_i)   # (4, M, 3): R rays_i
    a = torch.sum(rot * rot, -1)
    b = -torch.sum(rot * rays_j[None], -1)
    c = torch.sum(rays_j * rays_j, -1)[None]
    rhs1 = -torch.sum(rot * cands_t[:, None, :], -1)
    rhs2 = torch.sum(rays_j[None] * cands_t[:, None, :], -1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    d_i = (c * rhs1 - b * rhs2) / det
    d_j = (a * rhs2 - b * rhs1) / det
    votes = torch.sum(((d_i > 0) & (d_j > 0)).to(weights.dtype) * weights[None], -1)
    best = torch.argmax(votes).reshape(1)
    return cands_R.index_select(0, best)[0], cands_t.index_select(0, best)[0]


def ransac_essential(
    rays_i,
    rays_j,
    mask,
    key: Optional[torch.Tensor | FrameKey] = None,
    num_hyps: int = 256,
    thresh: float = 0.01,
    uv_i=None,
    dispersion_pow: float = 0.0,
    noise=None,
) -> EssentialEstimate:
    """Two-view relative pose from correspondences alone.

    rays_*: (M, 3) unit camera rays; mask: (M,) valid matches; the
    hypotheses come from `noise` ((H, 8, M) Gumbel) or are drawn under
    `key` ((2,) int32, the reference's key, or a FrameKey) in one launch
    of the draw kernel. thresh is on the algebraic residual |x_j^T E x_i| with
    ||E||_F = sqrt(2). dispersion_pow > 0 (with uv_i (M, 2)): score =
    inliers x (spatial std of the inliers)^pow.
    """
    A = _epipolar_design(rays_i, rays_j)  # (M, 9)
    w = mask.float()

    # Hypotheses: 8 weighted-random matches each.
    logits = torch.log(w + 1e-9)
    if noise is None:
        idx = draw_categorical(key, ((),), logits, (num_hyps, 8))[0]   # (H, 8)
    else:
        idx = torch.argmax(logits + noise, dim=-1)
    A_h = A[idx]                                          # (H, 8, 9)
    G = torch.einsum("hki,hkj->hij", A_h, A_h)
    e_h = smallest_eigvec_sym(G)                          # (H, 9)
    e_h = e_h * (math.sqrt(2.0) / torch.clamp(
        torch.linalg.vector_norm(e_h, dim=-1, keepdim=True), min=1e-12))

    # Score every hypothesis: (H, 9) x (9, M).
    resid = torch.abs(e_h @ A.T)
    inl_tab = (resid < thresh).float() * w[None, :]
    votes = torch.sum(inl_tab, dim=1)
    if dispersion_pow > 0.0 and uv_i is not None:
        ext = torch.stack([uv_i[:, 0].max() + 1.0, uv_i[:, 1].max() + 1.0])
        uvn = uv_i / ext
        nv = torch.clamp(votes, min=1.0)[:, None]
        mu = (inl_tab @ uvn) / nv
        second = (inl_tab @ (uvn * uvn)) / nv
        disp = torch.sqrt(torch.clamp(torch.sum(second - mu * mu, -1), min=1e-12))
        votes = votes * disp ** dispersion_pow
    e_fit = e_h.index_select(0, torch.argmax(votes).reshape(1))[0]

    # Two refits on the inliers.
    eye9 = torch.eye(9, dtype=A.dtype, device=A.device)
    for _ in range(2):
        wi = ((torch.abs(A @ e_fit) < thresh) & mask).float()
        G_full = torch.einsum("m,mi,mj->ij", wi, A, A)
        e_fit = smallest_eigvec_sym(G_full + 1e-9 * eye9)
        e_fit = e_fit * (math.sqrt(2.0) / torch.clamp(torch.linalg.vector_norm(e_fit),
                                                      min=1e-12))
    inl = (torch.abs(A @ e_fit) < thresh) & mask
    E = e_fit.reshape(3, 3)

    R, t = _decompose_essential(E, rays_i, rays_j, inl.float())
    return EssentialEstimate(
        R_ji=orthonormalize(R),
        t_dir=t,
        E=E,
        inlier_mask=inl,
        num_inliers=torch.sum(inl).to(torch.int32),
    )
