"""Visual-inertial sliding-window bundle adjustment (port of
`vislam_tpu/backend/vi_ba.py`).

The vision-only window BA (`backend/ba.py`) plus preintegrated-IMU factors
between consecutive keyframes (Forster-style residuals on dR, dv, dp), the
keyframe velocities and, when the factors carry bias Jacobians, one shared
window bias (dbg, dba) regularized by a prior. The IMU Jacobians are
forward-mode autodiff (`torch.func.jacfwd`) of the (W, 9) perturbation in
the vision update's own left-multiplicative convention; the reduced
camera system grows from 6W to 9W (+ 6) and is solved by one Cholesky.

The reference's early-exit LM `while_loop` is a loop of exactly `iters`
steps whose carry freezes once `(i < iters) & (stall < 4)` turns False:
every step is computed, and `torch.where` on the still-running flag keeps
the old carry. The result is the reference's, and `iters_run` the number
of unfrozen steps, with no host read. Cholesky and solve follow
`backend/ba.py`'s rule: NaN where the factorization fails.

Body frame: R_wb = R_wc R_bc^T; the lever arm is neglected, as the engine
treats IMU displacement as camera displacement.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.func import jacfwd

from vislam_tpu_torch.backend.ba import (
    BAProblem,
    BAState,
    _all_finite,
    _apply_update,
    back_substitute_landmarks,
    build_normal_equations,
    cholesky_solve_or_nan,
    reduce_landmarks,
    robust_cost,
)
from vislam_tpu_torch.lie.se3 import se3_exp, se3_log
from vislam_tpu_torch.lie.so3 import so3_exp, so3_log


class ImuFactors(NamedTuple):
    """Preintegrated factors between consecutive window keyframes; slot w
    holds the factor (w-1) -> w and slot 0 carries valid=False. The bias
    Jacobians and the bias each factor was integrated at are optional: with
    them the BA estimates one shared window bias."""

    dR: torch.Tensor      # (W, 3, 3) body rotation i->j
    dv: torch.Tensor      # (W, 3) velocity delta, frame-i body coords
    dp: torch.Tensor      # (W, 3) position delta, frame-i body coords
    dt: torch.Tensor      # (W,)
    valid: torch.Tensor   # (W,) bool
    J_R_bg: torch.Tensor = None   # (W, 3, 3)
    J_v_bg: torch.Tensor = None   # (W, 3, 3)
    J_v_ba: torch.Tensor = None   # (W, 3, 3)
    J_p_bg: torch.Tensor = None   # (W, 3, 3)
    J_p_ba: torch.Tensor = None   # (W, 3, 3)
    bg_ref: torch.Tensor = None   # (W, 3)
    ba_ref: torch.Tensor = None   # (W, 3)

    @property
    def has_bias_jacobians(self) -> bool:
        return self.J_R_bg is not None


def corrected_factors(fac: ImuFactors, bg, ba):
    """First-order bias correction of every factor to the bias (bg, ba):
    dR Exp(J_R_bg dbg), dv + J dbg, dp + J db (Forster et al. eq. 44)."""
    dbg = bg[None] - fac.bg_ref
    dba = ba[None] - fac.ba_ref
    rot = so3_exp(torch.einsum("wij,wj->wi", fac.J_R_bg, dbg))
    dR = torch.einsum("wij,wjk->wik", fac.dR, rot)
    dv = fac.dv + torch.einsum("wij,wj->wi", fac.J_v_bg, dbg) \
        + torch.einsum("wij,wj->wi", fac.J_v_ba, dba)
    dp = fac.dp + torch.einsum("wij,wj->wi", fac.J_p_bg, dbg) \
        + torch.einsum("wij,wj->wi", fac.J_p_ba, dba)
    return dR, dv, dp


def imu_residuals(R_cw, t_cw, v, fac: ImuFactors, g_w, R_bc, bg=None, ba=None):
    """(W, 9) stacked [r_R, r_v, r_p] per factor (row w: keyframes w-1 ->
    w; row 0 zero). Invalid rows are not masked here: the caller weights
    them to zero."""
    if bg is not None and fac.has_bias_jacobians:
        fdR, fdv, fdp = corrected_factors(fac, bg, ba)
    else:
        fdR, fdv, fdp = fac.dR, fac.dv, fac.dp
    R_wb = torch.einsum("wji,kj->wik", R_cw, R_bc)
    p = -torch.einsum("wji,wj->wi", R_cw, t_cw)
    Ri, Rj = R_wb[:-1], R_wb[1:]
    dt = fac.dt[1:, None]
    dv_w = v[1:] - v[:-1] - g_w[None] * dt
    dp_w = p[1:] - p[:-1] - v[:-1] * dt - 0.5 * g_w[None] * dt * dt
    E = torch.einsum("wji,wjk->wik", fdR[1:], torch.einsum("wji,wjk->wik", Ri, Rj))
    r = torch.cat([so3_log(E), torch.einsum("wji,wj->wi", Ri, dv_w) - fdv[1:],
                   torch.einsum("wji,wj->wi", Ri, dp_w) - fdp[1:]], dim=-1)
    return torch.cat([torch.zeros_like(r[:1]), r], dim=0)


def _imu_weights(fac: ImuFactors, w_rot, w_vel, w_pos):
    """(W, 9) precisions w/dt per residual component, zero where invalid."""
    dt = torch.clamp(fac.dt, min=1e-3)
    m = fac.valid.to(torch.float32)
    return torch.cat([(w / dt * m)[:, None].expand(-1, 3)
                      for w in (w_rot, w_vel, w_pos)], dim=-1)


def imu_cost(R_cw, t_cw, v, fac, g_w, R_bc, w_rot, w_vel, w_pos, bg=None, ba=None):
    r = imu_residuals(R_cw, t_cw, v, fac, g_w, R_bc, bg=bg, ba=ba)
    return 0.5 * torch.sum(_imu_weights(fac, w_rot, w_vel, w_pos) * r * r)


def _perturbed(R_cw, t_cw, delta):
    dR, dt_ = se3_exp(delta[:, :6])
    return (torch.einsum("wij,wjk->wik", dR, R_cw),
            torch.einsum("wij,wj->wi", dR, t_cw) + dt_)


def _imu_normal_equations(R_cw, t_cw, v, fac, g_w, R_bc, w_rot, w_vel, w_pos):
    """Gauss-Newton blocks of the IMU factors over the (W, 9) perturbation
    [se3 twist | dv]: (H (W,9,W,9), b (W,9))."""
    W = R_cw.shape[0]
    w = _imu_weights(fac, w_rot, w_vel, w_pos).reshape(W * 9)

    def r_of(delta):
        R_new, t_new = _perturbed(R_cw, t_cw, delta)
        return imu_residuals(R_new, t_new, v + delta[:, 6:], fac, g_w, R_bc)

    zero = torch.zeros((W, 9), dtype=torch.float32, device=R_cw.device)
    r0 = r_of(zero).reshape(W * 9)
    J = jacfwd(r_of)(zero).reshape(W * 9, W * 9)
    Jw = (J * w[:, None]).T
    return (Jw @ J).reshape(W, 9, W, 9), -(Jw @ r0).reshape(W, 9)


def _add_diag(A, d):
    return A + torch.diag_embed(d)


def _gauge(A, b, free):
    """Zero the fixed rows and columns, identity on their diagonal."""
    A = torch.where(free[:, None] & free[None, :], A, torch.zeros_like(A))
    A = _add_diag(A, torch.where(free, 0.0, 1.0))
    return A, torch.where(free, b, torch.zeros_like(b))


def solve_vi_system(S, rhs, H_imu, b_imu, lam, fixed_mask):
    """Solve the (9W) camera+velocity system: S (W,W,6,6) / rhs (W,6) the
    damped vision reduced system, H_imu (W,9,W,9) / b_imu (W,9) the IMU
    blocks; fixed_mask (W,) gauge-fixes poses (velocities stay free).
    Returns (dxi (W,6), dv (W,3))."""
    W = S.shape[0]
    A = H_imu + F.pad(S.permute(0, 2, 1, 3), (0, 3, 0, 0, 0, 3))
    b = b_imu + F.pad(rhs, (0, 3))
    Am = A.reshape(W * 9, W * 9)
    bm = b.reshape(W * 9)
    is_vel = (torch.arange(W * 9, device=S.device) % 9) >= 6
    # Velocity damping floor: velocities no factor observes stay SPD.
    Am = _add_diag(Am, torch.where(is_vel, lam + 1e-4, torch.zeros_like(lam)))
    Am, bm = _gauge(Am, bm, torch.repeat_interleave(~fixed_mask, 9) | is_vel)
    eye = torch.eye(W * 9, dtype=Am.dtype, device=Am.device)
    d = cholesky_solve_or_nan(Am + 1e-8 * eye, bm).reshape(W, 9)
    return d[:, :6], d[:, 6:]


def _imu_normal_equations_bias(R_cw, t_cw, v, fac, g_w, R_bc, w_rot, w_vel, w_pos,
                               bg, ba, bg0, ba0, w_bg_prior, w_ba_prior):
    """GN blocks over the (9W + 6) perturbation [poses+velocities | dbg dba]
    at the bias (bg, ba), with the prior centred at (bg0, ba0): (H (N,N),
    b (N,)), N = 9W + 6."""
    W = R_cw.shape[0]
    N = W * 9 + 6
    dev = R_cw.device
    wf = torch.cat([_imu_weights(fac, w_rot, w_vel, w_pos).reshape(-1),
                    torch.full((3,), w_bg_prior, dtype=torch.float32, device=dev),
                    torch.full((3,), w_ba_prior, dtype=torch.float32, device=dev)])

    def r_of(theta):
        delta = theta[:W * 9].reshape(W, 9)
        db = theta[W * 9:]
        R_new, t_new = _perturbed(R_cw, t_cw, delta)
        bg_c, ba_c = bg + db[:3], ba + db[3:]
        r_imu = imu_residuals(R_new, t_new, v + delta[:, 6:], fac, g_w, R_bc,
                              bg=bg_c, ba=ba_c)
        return torch.cat([r_imu.reshape(-1), bg_c - bg0, ba_c - ba0])

    zero = torch.zeros((N,), dtype=torch.float32, device=dev)
    r0 = r_of(zero)
    J = jacfwd(r_of)(zero)
    Jw = (J * wf[:, None]).T
    return Jw @ J, -(Jw @ r0)


def prior_residual(R0_cw, t0_cw, v0, lin_R, lin_t, lin_v):
    """(9,) residual of window slot 0 against its marginalization prior:
    [se3_log(T0 T_lin^-1) | v0 - v_lin]."""
    dR = R0_cw @ lin_R.T
    return torch.cat([se3_log((dR, t0_cw - dR @ lin_t)), v0 - lin_v])


def marginal_info_slot1(H_imu, prior_H, lam):
    """Schur-eliminate window slot 0 from (slot-0 prior + IMU factor 0->1)
    onto slot 1: the (9,9) information an evicted keyframe bequeaths."""
    A = H_imu[:18, :18].reshape(2, 9, 2, 9)
    H00 = A[0, :, 0, :] + prior_H + (lam + 1e-6) * torch.eye(9, device=H_imu.device)
    H01 = A[0, :, 1, :]
    sol, info = torch.linalg.solve_ex(H00, H01)
    sol = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
    return A[1, :, 1, :] - H01.T @ sol


def solve_vi_system_bias(S, rhs, H_imu, b_imu, lam, fixed_mask):
    """Solve the (9W + 6) camera+velocity+bias system: solve_vi_system with
    a trailing shared-bias block, always free. Returns (dxi, dv, db)."""
    W = S.shape[0]
    N = W * 9 + 6
    dev = S.device
    A = H_imu + F.pad(F.pad(S.permute(0, 2, 1, 3), (0, 3, 0, 0, 0, 3)).reshape(W * 9, W * 9),
                      (0, 6, 0, 6))
    b = b_imu + F.pad(F.pad(rhs, (0, 3)).reshape(-1), (0, 6))
    didx = torch.arange(N, device=dev)
    is_vel = (didx < W * 9) & ((didx % 9) >= 6)
    is_bias = didx >= W * 9
    A = _add_diag(A, torch.where(is_vel | is_bias, lam + 1e-4, torch.zeros_like(lam)))
    free = torch.cat([torch.repeat_interleave(~fixed_mask, 9),
                      torch.ones((6,), dtype=torch.bool, device=dev)]) | is_vel
    A, b = _gauge(A, b, free)
    d = cholesky_solve_or_nan(A + 1e-8 * torch.eye(N, dtype=A.dtype, device=dev), b)
    dp = d[:W * 9].reshape(W, 9)
    return dp[:, :6], dp[:, 6:], d[W * 9:]


def vi_bundle_adjust(state: BAState, prob: BAProblem, v, fac: ImuFactors, g_w, R_bc,
                     iters: int = 10, lam0: float = 1e-3, huber_delta: float = 2.0,
                     w_rot: float = 1e4, w_vel: float = 1e2, w_pos: float = 1e2,
                     fixed_mask=None, bg0=None, ba0=None, w_bg_prior: float = 1e3,
                     w_ba_prior: float = 1e3, prior_H=None, prior_lin=None,
                     compute_marginal: bool = False):
    """LM over poses, velocities, landmarks and, when the factors carry bias
    Jacobians and (bg0, ba0) are given, a shared window bias.

    fixed_mask (W,) bool: gauge-fixed poses (default: pose 0 only). prior_H
    (9,9) + prior_lin (R_cw, t_cw, v) add a marginalization prior on slot 0;
    compute_marginal also returns info["marg_H"] / info["marg_lin"], the
    information slot 0 would bequeath to slot 1 if evicted now.

    Returns ((BAState, v), info), or ((BAState, v, bg, ba), info) when the
    bias is estimated; info holds "final_cost", "initial_cost", "lam" and
    "iters_run".
    """
    W = state.R.shape[0]
    dev = state.R.device
    if fixed_mask is None:
        fixed_mask = torch.arange(W, device=dev) == 0
    est_bias = fac.has_bias_jacobians and bg0 is not None
    use_prior = prior_H is not None

    def total_cost(st, vv, bias):
        c = robust_cost(st, prob, huber_delta)
        if est_bias:
            bg, ba = bias[:3], bias[3:]
            c = c + imu_cost(st.R, st.t, vv, fac, g_w, R_bc, w_rot, w_vel, w_pos,
                             bg=bg, ba=ba)
            c = c + 0.5 * (w_bg_prior * torch.sum((bg - bg0) ** 2)
                           + w_ba_prior * torch.sum((ba - ba0) ** 2))
        else:
            c = c + imu_cost(st.R, st.t, vv, fac, g_w, R_bc, w_rot, w_vel, w_pos)
        if use_prior:
            r0 = prior_residual(st.R[0], st.t[0], vv[0], *prior_lin)
            c = c + 0.5 * r0 @ (prior_H @ r0)
        return c

    def lm_step(st, vv, bias, lam, cost):
        Hpp, Hpl, Hll, bp, bl, _ = build_normal_equations(st, prob, huber_delta)
        S, rhs, Hll_inv = reduce_landmarks(Hpp, Hpl, Hll, bp, bl, lam)
        if est_bias:
            H_imu, b_imu = _imu_normal_equations_bias(
                st.R, st.t, vv, fac, g_w, R_bc, w_rot, w_vel, w_pos,
                bias[:3], bias[3:], bg0, ba0, w_bg_prior, w_ba_prior)
            if use_prior:
                r0 = prior_residual(st.R[0], st.t[0], vv[0], *prior_lin)
                H_imu = H_imu + F.pad(prior_H, (0, H_imu.shape[1] - 9, 0, H_imu.shape[0] - 9))
                b_imu = b_imu + F.pad(-prior_H @ r0, (0, b_imu.shape[0] - 9))
            dxi, dv, db = solve_vi_system_bias(S, rhs, H_imu, b_imu, lam, fixed_mask)
        else:
            H_imu, b_imu = _imu_normal_equations(st.R, st.t, vv, fac, g_w, R_bc,
                                                 w_rot, w_vel, w_pos)
            if use_prior:
                r0 = prior_residual(st.R[0], st.t[0], vv[0], *prior_lin)
                H_imu = H_imu + F.pad(prior_H[None, :, None, :],
                                      (0, 0, 0, W - 1, 0, 0, 0, W - 1))
                b_imu = b_imu + F.pad((-prior_H @ r0)[None], (0, 0, 0, W - 1))
            dxi, dv = solve_vi_system(S, rhs, H_imu, b_imu, lam, fixed_mask)
            db = torch.zeros((6,), dtype=torch.float32, device=dev)
        dX = back_substitute_landmarks(Hpl, Hll_inv, bl, dxi)
        cand = _apply_update(st, dxi, dX)
        cand_v, cand_bias = vv + dv, bias + db
        cand_cost = total_cost(cand, cand_v, cand_bias)
        accept = _all_finite(cand_cost, dxi, dv, db, dX) & (cand_cost < cost)

        def sel(a, b):
            return torch.where(accept, a, b)

        return (BAState(*[sel(a, b) for a, b in zip(cand, st)]), sel(cand_v, vv),
                sel(cand_bias, bias),
                torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), lam * 4.0),
                sel(cand_cost, cost))

    bias0 = torch.cat([bg0, ba0]) if est_bias else \
        torch.zeros((6,), dtype=torch.float32, device=dev)
    cost0 = total_cost(state, v, bias0)

    # The reference's early-exit loop: it stops after 4 consecutive steps
    # without a 1e-3 relative improvement; a rejected step during the
    # initial lambda ramp (nothing accepted yet, lam < 1) does not count.
    carry = (state, v, bias0, torch.full((), lam0, dtype=torch.float32, device=dev), cost0)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    accepted_any = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        running = stall < 4
        prev_lam, prev_cost = carry[3], carry[4]
        new = lm_step(*carry)
        new_lam, new_cost = new[3], new[4]
        improved = (prev_cost - new_cost) > 1e-3 * (torch.abs(new_cost) + 1e-12)
        rejected = new_lam > prev_lam
        free_ramp = rejected & (prev_lam < 1.0) & ~accepted_any
        new_stall = torch.where(improved, torch.zeros_like(stall),
                                torch.where(free_ramp, stall, stall + 1))

        def keep(a, b):
            return torch.where(running, a, b)

        carry = (BAState(*[keep(a, b) for a, b in zip(new[0], carry[0])]),
                 *[keep(a, b) for a, b in zip(new[1:], carry[1:])])
        i = i + running.to(torch.int32)
        stall = keep(new_stall, stall)
        accepted_any = keep(accepted_any | ~rejected, accepted_any)
    state, v, bias, lam, cost = carry
    info = {"final_cost": cost, "initial_cost": cost0, "lam": lam, "iters_run": i}
    if compute_marginal:
        # Before the first eviction slot 0 is the hard-fixed gauge, whose
        # equivalent information is a strong identity prior.
        Hi_f, _ = _imu_normal_equations(state.R, state.t, v, fac, g_w, R_bc,
                                        w_rot, w_vel, w_pos)
        pH = prior_H if use_prior else torch.zeros((9, 9), dtype=torch.float32, device=dev)
        pH = torch.where(torch.trace(pH) > 1e-6, pH,
                         1e4 * torch.eye(9, dtype=torch.float32, device=dev))
        marg = marginal_info_slot1(Hi_f.reshape(W * 9, W * 9), pH, 1e-6)
        info["marg_H"] = 0.5 * (marg + marg.T)
        info["marg_lin"] = (state.R[1], state.t[1], v[1])
    if est_bias:
        return (state, v, bias[:3], bias[3:]), info
    return (state, v), info
