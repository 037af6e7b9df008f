"""GT-free visual-inertial bootstrap: the linear VI alignment
(`inertial/vi_align.py`) applied to the engine's keyframe window (port of
`vislam_tpu/engine/bootstrap.py`, whose docstrings give the measured
reasons behind each gate).

Every outcome is a `torch.where` on fixed shapes: the fit is untrustworthy
(state unchanged, retried at a later promotion), the current state is
consistent with the window's IMU factors (healthy: `vi_aligned` latches,
and `vi_engaged` once the window is excited enough or the run was
bootstrapped), or it is inconsistent and the fit explains the window
decisively better (re-anchor scale and velocities; velocity only once
`vi_aligned`). The engine runs it on every frame and keeps its result
only where the reference's cond would have run it.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.engine.state import EngineState
from vislam_tpu_torch.inertial.vi_align import vi_align, vi_align_fixed_gravity


def _current_state_residual(R_wb, p, v_win, dv, dp, dt, g_w, mask):
    """RMS kinematic residual of the current window state (s = 1, stored
    velocities) against the IMU factors: the model-comparison baseline."""
    m = mask.to(p.dtype)[:, None]
    dtk = dt[:, None]
    Rdp = torch.einsum("kij,kj->ki", R_wb[:-1], dp)
    Rdv = torch.einsum("kij,kj->ki", R_wb[:-1], dv)
    e_p = (p[1:] - p[:-1] - v_win[:-1] * dtk - 0.5 * g_w[None] * dtk * dtk - Rdp) * m
    e_v = (v_win[1:] - v_win[:-1] - g_w[None] * dtk - Rdv) * m
    n = torch.clamp(torch.sum(m) * 6.0, min=1.0)
    return torch.sqrt((torch.sum(e_p * e_p) + torch.sum(e_v * e_v)) / n)


def vi_align_window(state: EngineState, R_bc, gravity: float,
                    min_factors: int = 4,
                    scale_bounds=(0.02, 50.0),
                    max_gravity_err: float = 1.5,
                    min_gravity_cos: float = 0.94,
                    min_excitation: float = 0.5,
                    resid_floor: float = 0.007,
                    resid_ratio: float = 1.6,
                    engage_min_excitation: float = 1.5) -> EngineState:
    """Attempt the linear alignment on the current window; returns the new
    state. R_bc: the camera->body rotation, a (3, 3) tensor on the state's
    device."""
    win = state.window
    W = win.valid.shape[0]
    dev = win.R_cw.device

    # Body->world rotations and camera (= body) positions per slot.
    R_wb = torch.einsum("wji,kj->wik", win.R_cw, R_bc)
    p = -torch.einsum("wji,wj->wi", win.R_cw, win.t_cw)
    # The fit runs on the consistently scaled shadow positions; the health
    # check stays on the real state.
    p_sh = state.shadow_win_p

    # Interval k -> k+1 uses the factor stored at slot k+1.
    mask = win.imu_valid[1:] & win.valid[1:] & win.valid[:-1]
    # (0, 0, -g) built on the device: no host->device copy inside a step.
    g_w = torch.eye(3, dtype=torch.float32, device=dev)[2] * -gravity
    dv, dp, dt = win.imu_dv[1:], win.imu_dp[1:], win.imu_dt[1:]

    align = vi_align_fixed_gravity(R_wb, p_sh, dv, dp, dt, g_w, mask=mask)
    check = vi_align(R_wb, p_sh, dv, dp, dt, mask=mask)

    # Excitation: spread of the IMU-integrated cumulative velocity.
    m_f = mask.to(torch.float32)[:, None]
    dVk = (torch.einsum("kij,kj->ki", R_wb[:-1], dv) + g_w[None] * dt[:, None]) * m_f
    V = torch.cumsum(torch.cat([torch.zeros((1, 3), device=dev), dVk], 0), dim=0)
    w_slot = torch.cat([torch.ones((1,), device=dev), mask.to(torch.float32)])
    V_mean = torch.sum(V * w_slot[:, None], 0) / torch.clamp(torch.sum(w_slot), min=1.0)
    excitation = torch.max(torch.linalg.vector_norm(V - V_mean, dim=-1) * w_slot)

    # Model comparison: current state vs fit.
    r_cur = _current_state_residual(R_wb, p, win.v_w, dv, dp, dt, g_w, mask)
    r_fit = align.residual

    s = align.scale
    g = check.gravity
    g_norm = torch.linalg.vector_norm(g)
    g_cos = -g[2] / torch.clamp(g_norm, min=1e-6)
    n_fac = torch.sum(mask)
    trustworthy = ((n_fac >= min_factors) & (excitation >= min_excitation)
                   & torch.isfinite(s) & (s > scale_bounds[0]) & (s < scale_bounds[1])
                   & (torch.abs(g_norm - gravity) < max_gravity_err)
                   & (g_cos > min_gravity_cos)
                   & torch.all(torch.isfinite(align.velocities))
                   & torch.isfinite(r_fit) & torch.isfinite(r_cur))
    healthy = ((n_fac >= min_factors) & torch.isfinite(r_cur)
               & (r_cur <= resid_floor) & (excitation >= min_excitation))
    engage = healthy & ((excitation >= engage_min_excitation)
                        | (state.bootstrap_applies > 0))
    inconsistent = (r_cur > resid_floor) & (r_fit < r_cur / resid_ratio)
    apply = trustworthy & inconsistent
    apply_full = apply & ~state.vi_aligned
    apply_vel = apply & (~state.vi_aligned | (r_cur > 2.0 * resid_floor))

    # Re-anchor on the scaled shadow geometry: early applies (window not yet
    # rolled far) at the trajectory origin, late ones at the real slot 0.
    early = state.kf_count <= (W + 2)
    p0 = torch.where(early, state.origin_p_wc, p[0])
    p_sh0 = torch.where(early, state.shadow_origin_p, p_sh[0])
    p_new = p0 + s * (p_sh - p_sh0)
    t_cw_new = -torch.einsum("wij,wj->wi", win.R_cw, p_new)
    # Velocities only where an adjacent interval constrained them.
    adj = torch.cat([mask[:1], mask[1:] | mask[:-1], mask[-1:]])
    v_new = torch.where(adj[:, None], align.velocities, win.v_w)

    anchor = torch.clamp(win.count - 1, 0, W - 1).long().reshape(1)
    kf_p_new = p0 + s * (state.shadow_kf_p_wc - p_sh0)
    p_wc_new = p0 + s * (state.shadow_p_wc - p_sh0)
    v_anchor = v_new.index_select(0, anchor)[0]

    def sel(a, b):
        return torch.where(apply_full, a, b)

    def selv(a, b):
        return torch.where(apply_vel, a, b)

    z99 = torch.zeros((9, 9), dtype=torch.float32, device=dev)
    return state._replace(
        window=win._replace(t_cw=sel(t_cw_new, win.t_cw), v_w=selv(v_new, win.v_w)),
        kf_p_wc=sel(kf_p_new, state.kf_p_wc),
        p_wc=sel(p_wc_new, state.p_wc),
        v_w=selv(v_anchor, state.v_w),
        marg_H=sel(z99, state.marg_H),
        marg_pend_H=sel(z99, state.marg_pend_H),
        # An apply never latches; only a healthy check does.
        vi_aligned=state.vi_aligned | healthy,
        vi_engaged=state.vi_engaged | engage,
        bootstrap_applies=state.bootstrap_applies + apply_full.to(torch.int32),
    )
