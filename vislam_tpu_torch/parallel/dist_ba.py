"""Landmark-sharded sliding-window bundle adjustment over a process group
(port of `vislam_tpu/parallel/dist_ba.py`).

Every rank holds a contiguous shard of the landmarks and their
observations, and all the poses. Per LM iteration each rank builds the
normal-equation blocks of its shard; the reduced camera system (S, rhs)
and the pose blocks (Hpp, bp) are summed over the group in one all_reduce
(`backend/ba.py::reduce_landmarks`); every rank solves the small
replicated (6W, 6W) system (9W (+ 6) with IMU factors, whose blocks each
rank computes replicated); the landmark updates back-substitute locally.
The cost is summed over the group and the all-shards-finite flag is an
all_reduce of an int, so accept and reject are the same on every rank,
chosen by `torch.where` with no read on the host. Communication per
iteration is O(W^2) floats, independent of L.

The functions run in every rank (SPMD) on the shard `shard_problem` gave
it; `mesh` is a `DeviceMesh` and `axis` one of its axis names or a tuple
of them (("host", "map"): the sum spans both).
"""

from __future__ import annotations

import numpy as np
import torch

from vislam_tpu_torch.backend.ba import (
    BAProblem,
    BAState,
    _all_finite,
    _apply_update,
    all_reduce_sum,
    back_substitute_landmarks,
    build_normal_equations,
    reduce_landmarks,
    robust_cost,
    schur_solve,
)
from vislam_tpu_torch.backend.vi_ba import (
    ImuFactors,
    _imu_normal_equations,
    _imu_normal_equations_bias,
    imu_cost,
    solve_vi_system,
    solve_vi_system_bias,
)
from vislam_tpu_torch.parallel.mesh import axis_groups, axis_position, mesh_device


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def shard_landmarks(state: BAState, prob: BAProblem, index: int, count: int, device):
    """Shard `index` of `count` of a whole problem (numpy or tensors), on
    `device`: L padded up to a multiple of count (X with ones, observations
    zero and masked off), this shard's contiguous L / count landmarks and
    their observations, the poses whole."""
    X = _tensor(state.X, device, torch.float32)
    obs_uv = _tensor(prob.obs_uv, device, torch.float32)
    obs_mask = _tensor(prob.obs_mask, device, torch.bool)
    L = X.shape[0]
    pad = (-L) % count
    if pad:
        X = torch.cat([X, torch.ones((pad, 3), dtype=X.dtype, device=device)])
        obs_uv = torch.cat([obs_uv, obs_uv.new_zeros((obs_uv.shape[0], pad, 2))], 1)
        obs_mask = torch.cat([obs_mask, obs_mask.new_zeros((obs_mask.shape[0], pad))], 1)
    n = (L + pad) // count
    part = slice(index * n, (index + 1) * n)
    return (BAState(R=_tensor(state.R, device, torch.float32),
                    t=_tensor(state.t, device, torch.float32), X=X[part].contiguous()),
            BAProblem(obs_uv=obs_uv[:, part].contiguous(),
                      obs_mask=obs_mask[:, part].contiguous(),
                      fx=prob.fx, fy=prob.fy, cx=prob.cx, cy=prob.cy))


def shard_problem(state: BAState, prob: BAProblem, mesh, axis="map"):
    """This rank's shard of a whole problem (the same numpy arrays or
    tensors in every rank), on its device: landmarks sharded along `axis`,
    poses replicated (`shard_landmarks`)."""
    index, count = axis_position(mesh, axis)
    return shard_landmarks(state, prob, index, count, mesh_device(mesh))


def _group_finite(x, groups, count):
    """True on every rank when x is finite on every rank."""
    ok = torch.isfinite(x).all().to(torch.int32)
    return all_reduce_sum(ok, groups) == count


def dist_bundle_adjust(state: BAState, prob: BAProblem, mesh, axis="map", iters: int = 8,
                       lam0: float = 1e-3, huber_delta: float = 2.0, fix_first: bool = True):
    """The LM of `backend/ba.py::bundle_adjust` on this rank's shard (from
    `shard_problem`), `iters` steps, the first pose fixed (fix_first).
    Returns (this rank's BAState: the group's poses, its landmark shard;
    info: "costs" (iters,), "initial_cost", "final_cost" of the group)."""
    groups = axis_groups(mesh, axis)
    count = axis_position(mesh, axis)[1]

    def total_cost(st):
        return all_reduce_sum(robust_cost(st, prob, huber_delta), groups)

    cost0 = cost = total_cost(state)
    lam = torch.full((), lam0, dtype=torch.float32, device=state.R.device)
    costs = []
    for _ in range(iters):
        Hpp, Hpl, Hll, bp, bl, _ = build_normal_equations(state, prob, huber_delta)
        dxi, dX = schur_solve(Hpp, Hpl, Hll, bp, bl, lam, int(fix_first), group=groups)
        cand = _apply_update(state, dxi, dX)
        cand_cost = total_cost(cand)
        accept = (_all_finite(cand_cost, dxi) & _group_finite(dX, groups, count)
                  & (cand_cost < cost))
        state = BAState(*[torch.where(accept, a, b) for a, b in zip(cand, state)])
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), lam * 4.0)
        cost = torch.where(accept, cand_cost, cost)
        costs.append(cost)
    return state, {"costs": torch.stack(costs), "final_cost": cost, "initial_cost": cost0}


def dist_vi_bundle_adjust(state: BAState, prob: BAProblem, v, fac, g_w, R_bc, mesh,
                          axis="map", iters: int = 8, lam0: float = 1e-3,
                          huber_delta: float = 2.0, w_rot: float = 1e4, w_vel: float = 1e2,
                          w_pos: float = 1e2, fixed_mask=None, bg0=None, ba0=None,
                          w_bg_prior: float = 1e4, w_ba_prior: float = 3e3):
    """The visual-inertial window BA (`backend/vi_ba.py`) on this rank's
    landmark shard: `iters` LM steps (the reference's distributed form has
    no early exit), the IMU, velocity and, with bias Jacobians in `fac` and
    (bg0, ba0) given, shared-bias blocks computed replicated in every rank.
    fixed_mask (W,) gauge-fixes poses (default: pose 0). v, fac, g_w, R_bc,
    fixed_mask, bg0 and ba0 may be numpy or tensors.

    Returns ((BAState, v), info), or ((BAState, v, bg, ba), info) with the
    bias; info as `dist_bundle_adjust`'s.
    """
    dev = state.R.device
    groups = axis_groups(mesh, axis)
    count = axis_position(mesh, axis)[1]
    W = state.R.shape[0]
    fac = ImuFactors(*[None if x is None else
                       _tensor(x, dev, torch.bool if name == "valid" else torch.float32)
                       for name, x in zip(ImuFactors._fields, fac)])
    v, g_w, R_bc = (_tensor(x, dev, torch.float32) for x in (v, g_w, R_bc))
    fixed = torch.arange(W, device=dev) == 0 if fixed_mask is None else \
        _tensor(fixed_mask, dev, torch.bool)
    est_bias = fac.has_bias_jacobians and bg0 is not None
    bias0 = torch.cat([_tensor(bg0, dev, torch.float32), _tensor(ba0, dev, torch.float32)]) \
        if est_bias else torch.zeros((6,), dtype=torch.float32, device=dev)
    bg0_l, ba0_l = bias0[:3], bias0[3:]

    def total_cost(st, vel, bias):
        c = all_reduce_sum(robust_cost(st, prob, huber_delta), groups)
        if est_bias:
            bg, ba = bias[:3], bias[3:]
            c = c + imu_cost(st.R, st.t, vel, fac, g_w, R_bc, w_rot, w_vel, w_pos,
                             bg=bg, ba=ba)
            return c + 0.5 * (w_bg_prior * torch.sum((bg - bg0_l) ** 2)
                              + w_ba_prior * torch.sum((ba - ba0_l) ** 2))
        return c + imu_cost(st.R, st.t, vel, fac, g_w, R_bc, w_rot, w_vel, w_pos)

    st, vel, bias = state, v, bias0
    cost0 = cost = total_cost(st, vel, bias)
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(iters):
        Hpp, Hpl, Hll, bp, bl, _ = build_normal_equations(st, prob, huber_delta)
        # One collective: the shard's Schur camera system summed over the group.
        S, rhs, Hll_inv = reduce_landmarks(Hpp, Hpl, Hll, bp, bl, lam, groups)
        if est_bias:
            H_imu, b_imu = _imu_normal_equations_bias(
                st.R, st.t, vel, fac, g_w, R_bc, w_rot, w_vel, w_pos, bias[:3], bias[3:],
                bg0_l, ba0_l, w_bg_prior, w_ba_prior)
            dxi, dv, db = solve_vi_system_bias(S, rhs, H_imu, b_imu, lam, fixed)
        else:
            H_imu, b_imu = _imu_normal_equations(st.R, st.t, vel, fac, g_w, R_bc,
                                                 w_rot, w_vel, w_pos)
            dxi, dv = solve_vi_system(S, rhs, H_imu, b_imu, lam, fixed)
            db = torch.zeros((6,), dtype=torch.float32, device=dev)
        dX = back_substitute_landmarks(Hpl, Hll_inv, bl, dxi)
        cand = _apply_update(st, dxi, dX)
        cand_v, cand_b = vel + dv, bias + db
        cand_cost = total_cost(cand, cand_v, cand_b)
        accept = (_all_finite(cand_cost, dxi, dv, db) & _group_finite(dX, groups, count)
                  & (cand_cost < cost))
        st = BAState(*[torch.where(accept, a, b) for a, b in zip(cand, st)])
        vel = torch.where(accept, cand_v, vel)
        bias = torch.where(accept, cand_b, bias)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), lam * 4.0)
        cost = torch.where(accept, cand_cost, cost)
        costs.append(cost)
    info = {"costs": torch.stack(costs), "final_cost": cost, "initial_cost": cost0}
    if est_bias:
        return (st, vel, bias[:3], bias[3:]), info
    return (st, vel), info
