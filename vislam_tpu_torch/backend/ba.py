"""Sliding-window bundle adjustment: Levenberg-Marquardt with a Schur
complement (port of `vislam_tpu/backend/ba.py`).

Fixed shapes throughout: a (W, L) observation table with a boolean mask,
batched einsums for every Jacobian block, the block-diagonal landmark
system inverted in closed form, the reduced (6W, 6W) camera system solved
by Cholesky. The LM loop runs a fixed `iters` steps with accept/reject
damping selected by `torch.where`; no value on the device steers Python.

The reference's `jnp.linalg.cholesky` of a matrix that is not positive
definite gives NaN, so the candidate's cost is NaN and the step is
rejected. `cholesky_ex` instead reports `info > 0` beside a partial factor:
the solve's result is set to NaN wherever `info != 0`, which keeps the
reference's reject without a host check.

Landmark-sharded mode (`group`, the reference's `axis_name`): each rank
holds a contiguous shard of the landmarks, its Hpp, bp, S and rhs are
partial sums over that shard, and one `all_reduce` sums them over the
process group (`parallel/dist_ba.py`); the (6W, 6W) solve then runs
replicated on every rank and the back-substitution stays local.

Pose convention: world->camera, X_c = R X_w + t; perturbations are
left-multiplicative se3 twists [rho, phi]: (R, t) <- exp(dxi) (R, t).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from vislam_tpu_torch.lie.se3 import se3_exp
from vislam_tpu_torch.lie.so3 import so3_hat


class BAProblem(NamedTuple):
    """Static observation data for one window."""

    obs_uv: torch.Tensor    # (W, L, 2) pixel observations
    obs_mask: torch.Tensor  # (W, L) bool
    fx: float
    fy: float
    cx: float
    cy: float


class BAState(NamedTuple):
    """Optimizable state."""

    R: torch.Tensor  # (W, 3, 3) world->camera rotations
    t: torch.Tensor  # (W, 3)    world->camera translations
    X: torch.Tensor  # (L, 3)    world landmarks


def reprojection_residuals(state: BAState, prob: BAProblem):
    """r (W, L, 2) and camera-frame points Xc (W, L, 3)."""
    Xc = torch.einsum("wij,lj->wli", state.R, state.X) + state.t[:, None, :]
    z = Xc[..., 2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u = prob.fx * Xc[..., 0] / safe_z + prob.cx
    v = prob.fy * Xc[..., 1] / safe_z + prob.cy
    return torch.stack([u, v], -1) - prob.obs_uv, Xc


def _huber_weights(r, mask, delta):
    """Per-observation Huber IRLS weight (1 inside, delta/|r| outside)."""
    rn = torch.linalg.vector_norm(r, dim=-1)
    w = torch.where(rn <= delta, torch.ones_like(rn), delta / torch.clamp(rn, min=1e-9))
    return w * mask.to(r.dtype)


def _huber_cost(rn, delta):
    return torch.where(rn <= delta, 0.5 * rn * rn, delta * (rn - 0.5 * delta))


def robust_cost(state: BAState, prob: BAProblem, delta: float):
    r, Xc = reprojection_residuals(state, prob)
    m = prob.obs_mask & (Xc[..., 2] > 1e-3)
    return torch.sum(_huber_cost(torch.linalg.vector_norm(r, dim=-1), delta) * m.to(r.dtype))


def build_normal_equations(state: BAState, prob: BAProblem, delta: float):
    """All LM blocks in one batched shot: (Hpp (W,6,6), Hpl (W,L,6,3),
    Hll (L,3,3), bp (W,6), bl (L,3), cost)."""
    r, Xc = reprojection_residuals(state, prob)
    mask = prob.obs_mask & (Xc[..., 2] > 1e-3)
    w = _huber_weights(r, mask, delta)

    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    # A = d(pi)/d(Xc): (W, L, 2, 3)
    A = torch.stack([torch.stack([prob.fx * iz, zero, -prob.fx * x * iz2], -1),
                     torch.stack([zero, prob.fy * iz, -prob.fy * y * iz2], -1)], dim=-2)
    # J_pose = A [I | -hat(Xc)]: (W, L, 2, 6); J_land = A R: (W, L, 2, 3)
    Jp = torch.cat([A, -torch.einsum("wlab,wlbc->wlac", A, so3_hat(Xc))], dim=-1)
    Jl = torch.einsum("wlab,wbc->wlac", A, state.R)

    wr = w[..., None] * r
    Hpp = torch.einsum("wl,wlai,wlaj->wij", w, Jp, Jp)
    Hll = torch.einsum("wl,wlai,wlaj->lij", w, Jl, Jl)
    Hpl = torch.einsum("wl,wlai,wlaj->wlij", w, Jp, Jl)
    bp = -torch.einsum("wlai,wla->wi", Jp, wr)
    bl = -torch.einsum("wlai,wla->li", Jl, wr)
    cost = torch.sum(_huber_cost(torch.linalg.vector_norm(r, dim=-1), delta)
                     * mask.to(r.dtype))
    return Hpp, Hpl, Hll, bp, bl, cost


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det), ridge-guarded."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    safe = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], dim=-2)
    return adj / safe[..., None, None]


def all_reduce_sum(t, group):
    """t summed over the ranks of `group`: a process group, or a sequence
    of groups summed over in turn (the axes of a mesh, as a psum over a
    tuple of axes); t itself when group is None. t is not modified."""
    if group is None:
        return t
    t = t.clone()
    for g in (group if isinstance(group, (tuple, list)) else (group,)):
        dist.all_reduce(t, group=g)
    return t


def reduce_landmarks(Hpp, Hpl, Hll, bp, bl, lam, group=None):
    """Eliminate the landmark block: the reduced camera system (S (W,W,6,6)
    with the damped Hpp on its diagonal, rhs (W,6)) and Hll^-1. With
    `group` (see `all_reduce_sum`) the landmarks are this rank's shard:
    Hpp, bp, S and the rhs correction are summed over the group in one
    all_reduce before the damping; Hll^-1 stays the shard's."""
    W = Hpp.shape[0]
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_inv = _inv3x3(Hll + (lam * dll + 1e-5)[..., None] * eye3[None])
    Awl = torch.einsum("wlij,ljk->wlik", Hpl, Hll_inv)
    S = -torch.einsum("wlik,vljk->wvij", Awl, Hpl)
    rhs_corr = torch.einsum("wlik,lk->wi", Awl, bl)
    if group is not None:
        parts = (Hpp, bp, S, rhs_corr)
        summed = all_reduce_sum(torch.cat([x.reshape(-1) for x in parts]), group)
        Hpp, bp, S, rhs_corr = [x.reshape(p.shape) for x, p in zip(
            summed.split([p.numel() for p in parts]), parts)]
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + (lam * dpp + 1e-8)[..., None] * eye6[None]
    on_diag = torch.eye(W, dtype=torch.bool, device=Hpp.device)[:, :, None, None]
    S = S + torch.where(on_diag, Hpp_d[:, None], torch.zeros_like(S))
    return S, bp - rhs_corr, Hll_inv


def back_substitute_landmarks(Hpl, Hll_inv, bl, dxi):
    """dX_l = Hll^-1 (bl - sum_w Hpl^T dxi_w)."""
    corr = torch.einsum("wlij,wi->lj", Hpl, dxi)
    return torch.einsum("lij,lj->li", Hll_inv, bl - corr)


def cholesky_solve_or_nan(A, b):
    """x = A^-1 b by Cholesky of the symmetrized A (as `jnp.linalg.cholesky`
    symmetrizes its input); NaN wherever the factorization failed (the
    reference's NaN from a matrix that is not positive definite)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.T))
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def schur_solve(Hpp, Hpl, Hll, bp, bl, lam, fix_first: int = 1, fixed_mask=None,
                group=None):
    """Damped Schur-complement solve: (dxi (W,6), dX (L,3)). fixed_mask (W,)
    gauge-fixes arbitrary poses; else the first `fix_first` are fixed.
    With `group` the landmarks are this rank's shard (`reduce_landmarks`):
    dxi is the group's, dX the shard's."""
    W = Hpp.shape[0]
    S, rhs, Hll_inv = reduce_landmarks(Hpp, Hpl, Hll, bp, bl, lam, group)
    Sm = S.transpose(1, 2).reshape(W * 6, W * 6)
    rm = rhs.reshape(W * 6)
    dev = Sm.device
    idx = torch.arange(W * 6, device=dev)
    eye = torch.eye(W * 6, dtype=Sm.dtype, device=dev)
    if fixed_mask is not None:
        free = torch.repeat_interleave(~fixed_mask, 6)
        Sm = torch.where(free[:, None] & free[None, :], Sm, torch.zeros_like(Sm))
        Sm = Sm + eye * torch.where(free, 0.0, 1.0)[:, None]
        rm = torch.where(free, rm, torch.zeros_like(rm))
    elif int(fix_first):
        free = idx >= 6 * int(fix_first)
        Sm = torch.where(free[:, None] & free[None, :], Sm, torch.zeros_like(Sm))
        Sm = torch.where((~free)[:, None] & (idx[:, None] == idx[None, :]),
                         torch.ones_like(Sm), Sm)
        rm = torch.where(free, rm, torch.zeros_like(rm))
    dxi = cholesky_solve_or_nan(Sm + 1e-8 * eye, rm).reshape(W, 6)
    return dxi, back_substitute_landmarks(Hpl, Hll_inv, bl, dxi)


def _apply_update(state: BAState, dxi, dX) -> BAState:
    dR, dt = se3_exp(dxi)
    return BAState(R=torch.einsum("wij,wjk->wik", dR, state.R),
                   t=torch.einsum("wij,wj->wi", dR, state.t) + dt, X=state.X + dX)


def _all_finite(*xs):
    ok = torch.isfinite(xs[0]).all()
    for x in xs[1:]:
        ok = ok & torch.isfinite(x).all()
    return ok


def bundle_adjust(state: BAState, prob: BAProblem, iters: int = 8, lam0: float = 1e-3,
                  huber_delta: float = 2.0, fix_first: int = 1, fixed_mask=None):
    """LM with accept/reject damping over a fixed `iters` steps.

    Returns (state, info) with info's per-step "costs" (iters,),
    "final_cost", "initial_cost" and "lam".
    """
    dev = state.R.device
    cost0 = robust_cost(state, prob, huber_delta)
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    cost = cost0
    costs = []
    for _ in range(iters):
        Hpp, Hpl, Hll, bp, bl, _ = build_normal_equations(state, prob, huber_delta)
        dxi, dX = schur_solve(Hpp, Hpl, Hll, bp, bl, lam, fix_first, fixed_mask=fixed_mask)
        cand = _apply_update(state, dxi, dX)
        cand_cost = robust_cost(cand, prob, huber_delta)
        # A non-finite step is rejected outright (a NaN state would mask out
        # every observation and score a spurious zero cost).
        accept = _all_finite(cand_cost, dxi, dX) & (cand_cost < cost)
        state = BAState(*[torch.where(accept, a, b) for a, b in zip(cand, state)])
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), lam * 4.0)
        cost = torch.where(accept, cand_cost, cost)
        costs.append(cost)
    return state, {"costs": torch.stack(costs),
                   "final_cost": cost, "initial_cost": cost0, "lam": lam}
