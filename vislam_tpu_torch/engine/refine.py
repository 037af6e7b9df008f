"""Sliding-window refinement: track association, triangulation and the
window (VI-)BA (port of `vislam_tpu/engine/refine.py`, every gauge of
`backend.online_gauge`: `ends`, `oldest2`, `marg`).

Tracks are anchored at the newest keyframe of the window: its K keypoint
rows are the track slots, and every window keyframe is matched directly
against it, as ONE batched call of the match kernel (`ops/match_kernel.py`,
the anchor shared by the W slots; the bf16 bank widened to float32, which
is exact). Under `run_batch_scan`'s vmap each sequence has its own anchor:
the op's vmap rule folds the B sequences into one call with a_group = W
(B anchors, B x W slots). Tracks seen in >= 2 keyframes are triangulated
from their first and last observation and refined by `backend/ba.py`
(vision only) or `backend/vi_ba.py` (with the window's IMU factors,
velocities and bias).

Every gather is an index_select or gather with clamped indices, every
median is the reference's sort-and-take rule, and every BA -> state write
goes through `torch.where` on the reference's acceptance gates: the engine
runs this on every frame and keeps it only on keyframes, so a garbage
window must neither raise nor leak NaN into the kept state.
"""

from __future__ import annotations

import math

import torch

from vislam_tpu_torch.backend.ba import BAProblem, BAState, bundle_adjust
from vislam_tpu_torch.backend.triangulate import triangulate_midpoint
from vislam_tpu_torch.backend.vi_ba import ImuFactors, vi_bundle_adjust
from vislam_tpu_torch.engine.state import EngineState
from vislam_tpu_torch.frontend.match import match_descriptors
from vislam_tpu_torch.inertial.preintegration import Preintegrated, bias_correct
from vislam_tpu_torch.lie.so3 import orthonormalize, so3_exp, so3_log
from vislam_tpu_torch.utils.config import SystemConfig

GAUGES = ("ends", "oldest2", "marg")


def check_gauge(gauge: str) -> None:
    """Refuse an unknown gauge name (the reference takes any other name as
    `ends` in vision-only windows and as slot 0 fixed in VI ones)."""
    if gauge not in GAUGES:
        raise ValueError(f"backend.online_gauge={gauge!r} is not a gauge: one of {GAUGES}")


def _anchor(window):
    W = window.kp_mask.shape[0]
    return torch.clamp(window.count - 1, 0, W - 1).long().reshape(1)


def _build_tracks(window, ratio: float, mutual: bool):
    """Match every window keyframe against the newest (anchor) keyframe in
    one batched match. Returns (ptr (W, K), ok (W, K)): ptr[w, l] is the
    keypoint row in keyframe w observing anchor track l."""
    W, K = window.kp_mask.shape
    anchor = _anchor(window)
    bank = window.desc.float()
    a_desc = bank.index_select(0, anchor)[0]
    a_mask = (window.kp_mask.index_select(0, anchor)
              & window.valid.index_select(0, anchor)[:, None])[0]
    m = match_descriptors(a_desc, a_mask, bank, window.kp_mask & window.valid[:, None],
                          ratio=ratio, mutual=mutual)
    is_anchor = (torch.arange(W, device=bank.device) == anchor)[:, None]
    ptr = torch.where(is_anchor, torch.arange(K, dtype=torch.int32, device=bank.device),
                      m.idx_b)
    ok = torch.where(is_anchor, a_mask[None, :], m.mask)
    return ptr, ok


def _median_at(sorted_vals, cnt, K):
    """Element (cnt - 1) // 2 of each sorted row (the reference's median)."""
    idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, K - 1)
    return torch.gather(sorted_vals, -1, idx[..., None].long())[..., 0]


def build_window_problem(state: EngineState, cfg: SystemConfig,
                         fx: float, fy: float, cx: float, cy: float):
    """Track association + triangulation + outlier gates over the window.
    Returns (ba_state, prob, track_ok)."""
    win = state.window
    W, K = win.kp_mask.shape
    dev = win.uv.device
    be = cfg.backend

    ptr, ok = _build_tracks(win, cfg.frontend.ratio_thresh, cfg.frontend.mutual_check)
    ptr = torch.clamp(ptr, 0, K - 1).long()
    obs_uv = torch.gather(win.uv, 1, ptr[..., None].expand(W, K, 2))   # (W, K, 2)
    obs_mask = ok & win.valid[:, None]

    # Tracks need >= 2 observations, and the window >= 2 keyframes.
    track_ok = (torch.sum(obs_mask, dim=0) >= 2) & (win.count >= 2)
    obs_mask = obs_mask & track_ok[None, :]

    # Triangulate from the first and last keyframe observing each track.
    idx_w = torch.arange(W, device=dev)[:, None]
    first_w = torch.amin(torch.where(obs_mask, idx_w, W), dim=0)
    last_w = torch.amax(torch.where(obs_mask, idx_w, -1), dim=0)
    first_c = torch.clamp(first_w, 0, W - 1)
    last_c = torch.clamp(last_w, 0, W - 1)

    def rays_of(uv):
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        r = torch.stack([x, y, torch.ones_like(x)], -1)
        return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)

    def at_obs(w_c):
        return torch.gather(obs_uv, 0, w_c[None, :, None].expand(1, K, 2))[0]

    rays_i = rays_of(at_obs(first_c))
    rays_j = rays_of(at_obs(last_c))
    R_cw_f = win.R_cw.index_select(0, first_c)
    t_cw_f = win.t_cw.index_select(0, first_c)
    R_cw_l = win.R_cw.index_select(0, last_c)
    t_cw_l = win.t_cw.index_select(0, last_c)
    # Relative pose first -> last per track: T_l T_f^-1.
    R_ji = torch.einsum("kij,kmj->kim", R_cw_l, R_cw_f)
    t_ji = t_cw_l - torch.einsum("kij,kj->ki", R_ji, t_cw_f)
    X_f, d_i, d_j, gap = triangulate_midpoint(rays_i, rays_j, R_ji, t_ji)
    X_w = torch.einsum("kji,kj->ki", R_cw_f, X_f - t_cw_f)
    depth_ok = (d_i > be.min_depth) & (d_i < be.max_depth) & (d_j > be.min_depth)
    track_ok = track_ok & depth_ok & torch.isfinite(X_w).all(dim=-1)
    obs_mask = obs_mask & track_ok[None, :]

    if be.vi_factors and be.reproj_gate > 0.0:
        # Pre-BA outlier gate (VI mode only): each observation's
        # reprojection residual at the initial geometry against k x the
        # keyframe's median, floored at the fixed gate; the same for the
        # triangulation gap relative to depth.
        Xc = torch.einsum("wij,lj->wli", win.R_cw, X_w) + win.t_cw[:, None, :]
        z = Xc[..., 2]
        zs = torch.clamp(z, min=1e-6)
        pred = torch.stack([fx * Xc[..., 0] / zs + cx, fy * Xc[..., 1] / zs + cy], -1)
        err = torch.linalg.vector_norm(pred - obs_uv, dim=-1)
        inf = torch.full_like(err, float("inf"))
        cnt = torch.sum(obs_mask, dim=1)
        med = _median_at(torch.sort(torch.where(obs_mask, err, inf), dim=1).values, cnt, K)
        med = torch.where(cnt > 0, med, torch.zeros_like(med))
        gate = torch.clamp(be.reproj_gate_mad * med, min=be.reproj_gate)
        obs_mask = obs_mask & (err < gate[:, None]) & (z > 0.0)
        gap_rel = gap / torch.clamp(d_i, min=1e-6)
        gcnt = torch.sum(track_ok)
        gmed = _median_at(torch.sort(torch.where(track_ok, gap_rel, inf[0])).values, gcnt, K)
        gmed = torch.where(gcnt > 0, gmed, torch.zeros_like(gmed))
        ggate = torch.clamp(be.reproj_gate_mad * gmed, min=be.tri_gap_rel)
        track_ok = track_ok & (gap_rel < ggate) & (torch.sum(obs_mask, dim=0) >= 2)
        obs_mask = obs_mask & track_ok[None, :]

    ba_state = BAState(R=win.R_cw, t=win.t_cw,
                       X=torch.where(track_ok[:, None], X_w, torch.ones_like(X_w)))
    prob = BAProblem(obs_uv=obs_uv, obs_mask=obs_mask, fx=fx, fy=fy, cx=cx, cy=cy)
    return ba_state, prob, track_ok


def _cap(v, limit, floor=1e-9):
    """v scaled down to norm `limit` where it is longer."""
    return v * torch.clamp(limit / torch.clamp(torch.linalg.vector_norm(v), min=floor),
                           max=1.0)


def _widest_baseline_slot(win, W_idx, anchor_slot):
    """The valid slot farthest from slot 0, neither slot 0 nor the anchor
    (the first on a tie; slot 0 where there is none)."""
    p_w = -torch.einsum("kji,kj->ki", win.R_cw, win.t_cw)
    d0 = torch.linalg.vector_norm(p_w - p_w[0], dim=-1)
    cand = win.valid & (W_idx != 0) & (W_idx != anchor_slot)
    return torch.argmax(torch.where(cand, d0, torch.full_like(d0, -1.0)))


def window_ba(state: EngineState, cfg: SystemConfig, ba_state: BAState, prob: BAProblem,
              R_bc=None):
    """The window BA of refine_window on a built problem, under
    `backend.online_gauge`. Vision only: `ends` fixes slots 0, 1 and the
    newest (so does `marg`, a VI gauge), `oldest2` slot 0 and the
    widest-baseline slot. With IMU factors: `ends` fixes slot 0 and the
    newest, `oldest2` slot 0, `marg` slot 0 until the marginalization
    prior is active and no pose after that (the prior on slot 0 anchors the
    window; its pending successor is computed). Returns (refined BAState,
    velocities, bias_g, bias_a, info): the velocities are the window's own
    and the biases None where they are not estimated; info holds the LM's
    final and initial cost ("iters_run" with IMU factors; "marg_H",
    "marg_lin" under `marg`)."""
    be = cfg.backend
    check_gauge(be.online_gauge)
    win = state.window
    W = win.kp_mask.shape[0]
    dev = win.uv.device
    f32 = dict(dtype=torch.float32, device=dev)
    W_idx = torch.arange(W, device=dev)
    anchor_slot = _anchor(win)[0]
    if not be.vi_factors:
        if be.online_gauge == "oldest2":
            fixed = (W_idx == 0) | (W_idx == _widest_baseline_slot(win, W_idx, anchor_slot))
        else:
            fixed = (W_idx < 2) | (W_idx == anchor_slot)
        refined, info = bundle_adjust(ba_state, prob, iters=be.lm_iters, lam0=be.lm_lambda0,
                                      huber_delta=be.huber_delta, fixed_mask=fixed)
        return refined, win.v_w, None, None, info
    bias_kw = dict(J_R_bg=win.imu_J_R_bg, J_v_bg=win.imu_J_v_bg, J_v_ba=win.imu_J_v_ba,
                   J_p_bg=win.imu_J_p_bg, J_p_ba=win.imu_J_p_ba, bg_ref=win.imu_bg_ref,
                   ba_ref=win.imu_ba_ref) if be.estimate_bias else {}
    fac = ImuFactors(dR=win.imu_dR, dv=win.imu_dv, dp=win.imu_dp, dt=win.imu_dt,
                     valid=win.imu_valid, **bias_kw)
    g_w = torch.eye(3, **f32)[2] * -cfg.engine.gravity
    Rbc = torch.eye(3, **f32) if R_bc is None else R_bc
    fixed = W_idx == 0
    marg = {}
    if be.online_gauge == "ends":
        fixed = fixed | (W_idx == anchor_slot)
    elif be.online_gauge == "marg":
        prior_active = torch.trace(state.marg_H) > 1e-6
        fixed = fixed & ~prior_active
        marg = dict(prior_H=state.marg_H,
                    prior_lin=(state.marg_R_cw, state.marg_t_cw, state.marg_v),
                    compute_marginal=True)
    common = dict(iters=be.lm_iters, lam0=be.lm_lambda0, huber_delta=be.huber_delta,
                  w_rot=be.vi_w_rot, w_vel=be.vi_w_vel, w_pos=be.vi_w_pos,
                  fixed_mask=fixed, **marg)
    if be.estimate_bias:
        (refined, v, bg, ba), info = vi_bundle_adjust(
            ba_state, prob, win.v_w, fac, g_w, Rbc, bg0=state.bias_g, ba0=state.bias_a,
            w_bg_prior=be.vi_w_bg_prior, w_ba_prior=be.vi_w_ba_prior, **common)
        return refined, v, bg, ba, info
    (refined, v), info = vi_bundle_adjust(ba_state, prob, win.v_w, fac, g_w, Rbc, **common)
    return refined, v, None, None, info


def refine_window(state: EngineState, cfg: SystemConfig, fx: float, fy: float,
                  cx: float, cy: float, R_bc=None) -> EngineState:
    """Windowed BA over the engine's keyframe window (`window_ba`); returns
    the new state. With cfg.backend.vi_factors the window is
    visual-inertial and its velocities (and, with estimate_bias, the bias)
    refine too. R_bc: the camera->body rotation (3, 3) on the state's
    device (identity if None). The newest-keyframe, velocity and bias
    corrections feed back capped."""
    be = cfg.backend
    win = state.window
    ba_state, prob, _ = build_window_problem(state, cfg, fx, fy, cx, cy)
    refined, v_refined, bg_ref, ba_ref, info = window_ba(state, cfg, ba_state, prob, R_bc)
    slot = _anchor(win)

    # Keep the refinement only if the BA improved and is sane.
    good = (torch.isfinite(info["final_cost"])
            & (info["final_cost"] <= info["initial_cost"])
            & (torch.sum(prob.obs_mask) >= 16))
    if be.vi_factors and cfg.engine.vi_align_bootstrap and not cfg.engine.vision_rotation:
        # Two-phase: in GT-free runs the VI-BA stays inert until the
        # engagement latch or the promotion-count deadline.
        good = good & (state.vi_engaged | (state.kf_count > be.vi_two_phase_max_kfs))
    R_cw_new = orthonormalize(torch.where(good, refined.R, win.R_cw))
    t_cw_new = torch.where(good, refined.t, win.t_cw)

    # The newest keyframe's correction to the engine anchors, capped.
    R_cw_k = R_cw_new.index_select(0, slot)[0]
    t_cw_k = t_cw_new.index_select(0, slot)[0]
    kf_p_wc = state.kf_p_wc + _cap(-R_cw_k.T @ t_cw_k - state.kf_p_wc, be.max_anchor_trans)
    drot = so3_log(R_cw_k.T @ state.kf_R_wc.T)
    kf_R_wc = orthonormalize(so3_exp(_cap(drot, be.max_anchor_rot)) @ state.kf_R_wc)

    new_win = win._replace(R_cw=R_cw_new, t_cw=t_cw_new)
    v_w_state = state.v_w
    updates = {}
    if be.vi_factors:
        v_ok = good & torch.isfinite(v_refined).all()
        new_win = new_win._replace(v_w=torch.where(v_ok, v_refined, win.v_w))
        dv_anchor = v_refined.index_select(0, slot)[0] - state.v_w
        v_w_state = torch.where(v_ok, state.v_w + _cap(dv_anchor, be.max_anchor_vel),
                                state.v_w)
        if be.estimate_bias:
            # Online bias write-back, capped and dead-banded; the in-flight
            # keyframe->current factor is re-corrected to the new bias.
            b_ok = (good & torch.isfinite(bg_ref).all() & torch.isfinite(ba_ref).all()
                    & (torch.sum(win.imu_valid) >= be.bias_min_factors))
            dbg = _cap(bg_ref - state.bias_g, be.max_bias_g_step, 1e-12)
            dba = _cap(ba_ref - state.bias_a, be.max_bias_a_step, 1e-12)
            dbg = torch.where(b_ok & (torch.linalg.vector_norm(dbg) > be.bias_g_deadband),
                              dbg, torch.zeros_like(dbg))
            dba = torch.where(b_ok & (torch.linalg.vector_norm(dba) > be.bias_a_deadband),
                              dba, torch.zeros_like(dba))
            acc = bias_correct(Preintegrated(
                dR=state.kf_pre_dR, dv=state.kf_pre_dv, dp=state.kf_pre_dp,
                dt=state.kf_time, J_dR_bg=state.kf_pre_J_R_bg, J_dv_bg=state.kf_pre_J_v_bg,
                J_dv_ba=state.kf_pre_J_v_ba, J_dp_bg=state.kf_pre_J_p_bg,
                J_dp_ba=state.kf_pre_J_p_ba), dbg, dba)
            updates = dict(bias_g=state.bias_g + dbg, bias_a=state.bias_a + dba,
                           kf_pre_dR=acc.dR, kf_pre_dv=acc.dv, kf_pre_dp=acc.dp)
        if be.online_gauge == "marg":
            # The pending prior for the next eviction, discounted and
            # trace-capped, kept only where the BA was accepted.
            mH = info["marg_H"] * be.marg_discount
            tr = torch.trace(mH)
            mH = mH * torch.clamp(be.marg_max_trace / torch.clamp(tr, min=1e-9), max=1.0)
            m_ok = good & torch.isfinite(mH).all() & (tr > 0.0)
            mR, mt, mv = info["marg_lin"]
            updates.update(
                marg_pend_H=torch.where(m_ok, mH, state.marg_pend_H),
                marg_pend_R_cw=torch.where(m_ok, mR, state.marg_pend_R_cw),
                marg_pend_t_cw=torch.where(m_ok, mt, state.marg_pend_t_cw),
                marg_pend_v=torch.where(m_ok, mv, state.marg_pend_v))
    return state._replace(
        window=new_win,
        **updates,
        kf_R_wc=torch.where(good, kf_R_wc, state.kf_R_wc),
        kf_p_wc=torch.where(good, kf_p_wc, state.kf_p_wc),
        R_wc=torch.where(good, kf_R_wc, state.R_wc),
        p_wc=torch.where(good, kf_p_wc, state.p_wc),
        v_w=v_w_state,
    )


def refine_window_distributed(state: EngineState, cfg: SystemConfig, fx: float, fy: float,
                              cx: float, cy: float, mesh, axis="map", R_bc=None):
    """The window (VI-)BA with the landmarks sharded over the ranks of
    `mesh` along `axis` (run in every rank, each with the same state):
    `build_window_problem` (the window-track match, one batched match
    call), this rank's shard (`parallel/dist_ba.py::shard_problem`), the
    `ends` gauge (slot 0 and the newest fixed), `dist_vi_bundle_adjust`
    with cfg.backend.vi_factors (with the bias under estimate_bias) or
    `dist_bundle_adjust`, then the accept test on the costs. Returns
    (new_state, info): info has "costs", "initial_cost", "final_cost" and
    "accepted".

    Offline semantics, as the CLI's --dist-ba N runs it at the end of a
    sequence: an accepted refine replaces the window's poses (and
    velocities) directly and moves the live anchors to its newest pose
    (orthonormalized; no caps, nothing tracks after it). The accept test
    reads the costs on the host.
    """
    from vislam_tpu_torch.parallel.dist_ba import (
        dist_bundle_adjust,
        dist_vi_bundle_adjust,
        shard_problem,
    )

    be = cfg.backend
    win = state.window
    W = win.kp_mask.shape[0]
    ba_state, prob, _ = build_window_problem(state, cfg, fx, fy, cx, cy)
    st, pr = shard_problem(ba_state, prob, mesh, axis=axis)
    dev = st.R.device
    anchor = int(_anchor(win)[0])
    W_idx = torch.arange(W, device=dev)
    fixed = (W_idx == 0) | (W_idx == anchor)
    if be.vi_factors:
        bias_kw = dict(J_R_bg=win.imu_J_R_bg, J_v_bg=win.imu_J_v_bg, J_v_ba=win.imu_J_v_ba,
                       J_p_bg=win.imu_J_p_bg, J_p_ba=win.imu_J_p_ba, bg_ref=win.imu_bg_ref,
                       ba_ref=win.imu_ba_ref) if be.estimate_bias else {}
        fac = ImuFactors(dR=win.imu_dR, dv=win.imu_dv, dp=win.imu_dp, dt=win.imu_dt,
                         valid=win.imu_valid, **bias_kw)
        g_w = torch.eye(3, dtype=torch.float32, device=dev)[2] * -cfg.engine.gravity
        Rbc = torch.eye(3, dtype=torch.float32, device=dev) if R_bc is None else R_bc
        bias = dict(bg0=state.bias_g, ba0=state.bias_a, w_bg_prior=be.vi_w_bg_prior,
                    w_ba_prior=be.vi_w_ba_prior) if be.estimate_bias else {}
        out, info = dist_vi_bundle_adjust(
            st, pr, win.v_w, fac, g_w, Rbc, mesh, axis=axis, iters=be.lm_iters,
            lam0=be.lm_lambda0, huber_delta=be.huber_delta, w_rot=be.vi_w_rot,
            w_vel=be.vi_w_vel, w_pos=be.vi_w_pos, fixed_mask=fixed, **bias)
        refined, v_ref = out[0], out[1]
    else:
        refined, info = dist_bundle_adjust(st, pr, mesh, axis=axis, iters=be.lm_iters,
                                           lam0=be.lm_lambda0, huber_delta=be.huber_delta)
        v_ref = win.v_w
    final, initial = float(info["final_cost"]), float(info["initial_cost"])
    good = math.isfinite(final) and final <= initial
    info = dict(info, accepted=good)
    if not good:
        return state, info
    R_cw = orthonormalize(refined.R)
    new_win = win._replace(R_cw=R_cw, t_cw=refined.t, v_w=v_ref)
    R_wc = R_cw[anchor].T
    p_wc = -R_wc @ refined.t[anchor]
    return state._replace(window=new_win, kf_R_wc=R_wc, kf_p_wc=p_wc, R_wc=R_wc, p_wc=p_wc,
                          v_w=v_ref[anchor]), info
