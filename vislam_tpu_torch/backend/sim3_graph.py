"""Sim(3) pose-graph optimization: monocular scale-drift loop correction
(port of `vislam_tpu/backend/sim3_graph.py`).

Per-edge residuals r_e = log(S_meas^-1 S_i^-1 S_j) in sim(3); their
Jacobians are forward-mode AD of the right-perturbed residual at zero,
as the reference's `vmap(jacfwd(...))`: here one `torch.func.jacfwd` over a
single (7,) perturbation that every edge receives, which gives each
edge's own (7, 7) block in 7 tangents. Dense (7N, 7N) Gauss-Newton with
node 0 fixed (frame and global scale), the damped accept/reject loop of
`backend/pose_graph.py`, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from vislam_tpu_torch.backend.pose_graph import weighted_blocks, damped_solve, scatter_blocks
from vislam_tpu_torch.lie.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from vislam_tpu_torch.lie.so3 import orthonormalize


class Sim3Graph(NamedTuple):
    R: torch.Tensor            # (N, 3, 3)
    t: torch.Tensor            # (N, 3)
    s: torch.Tensor            # (N,)
    edge_i: torch.Tensor       # (E,)
    edge_j: torch.Tensor       # (E,)
    edge_R: torch.Tensor       # (E, 3, 3) measured S_ij = S_i^-1 S_j
    edge_t: torch.Tensor       # (E, 3)
    edge_s: torch.Tensor       # (E,)
    edge_weight: torch.Tensor  # (E,)


def _edge_residual(Ti, Tj, Tm, eps_i, eps_j):
    """r = log(Tm^-1 (Ti exp(eps_i))^-1 (Tj exp(eps_j))), batched over edges."""
    Ti_p = sim3_compose(Ti, sim3_exp(eps_i))
    Tj_p = sim3_compose(Tj, sim3_exp(eps_j))
    return sim3_log(sim3_compose(sim3_inverse(Tm), sim3_compose(sim3_inverse(Ti_p), Tj_p)))


def _edge_nodes(g: Sim3Graph, R, t, s):
    ei, ej = g.edge_i.long(), g.edge_j.long()
    return (R[ei], t[ei], s[ei]), (R[ej], t[ej], s[ej]), (g.edge_R, g.edge_t, g.edge_s)


def sim3_graph_residuals(g: Sim3Graph):
    """(E, 7) sim(3) residuals of all edges."""
    Ti, Tj, Tm = _edge_nodes(g, g.R, g.t, g.s)
    z = torch.zeros((g.edge_i.shape[0], 7), dtype=g.R.dtype, device=g.R.device)
    return _edge_residual(Ti, Tj, Tm, z, z)


def edge_jacobians(Ti, Tj, Tm):
    """(r (E, 7), J_i (E, 7, 7), J_j (E, 7, 7)) at zero perturbation. An
    edge's residual depends only on its own perturbation, so the Jacobian
    with respect to one perturbation shared by all edges is every edge's
    block."""
    E = Ti[0].shape[0]
    z = torch.zeros((E, 7), dtype=Ti[0].dtype, device=Ti[0].device)
    z7 = torch.zeros(7, dtype=Ti[0].dtype, device=Ti[0].device)
    r = _edge_residual(Ti, Tj, Tm, z, z)
    Ji = jacfwd(lambda e: _edge_residual(Ti, Tj, Tm, e.expand(E, 7), z))(z7)
    Jj = jacfwd(lambda e: _edge_residual(Ti, Tj, Tm, z, e.expand(E, 7)))(z7)
    return r, Ji, Jj


def optimize_sim3_graph(g: Sim3Graph, iters: int = 12, lam0: float = 1e-4):
    """Damped GN over (R, t, s) nodes. Returns (Sim3Graph, info): info holds
    initial_cost, final_cost and costs (iters,), all on the device."""
    N = g.R.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    w = g.edge_weight

    def cost_of(R, t, s):
        r = sim3_graph_residuals(g._replace(R=R, t=t, s=s))
        return torch.sum(w[:, None] * r * r)

    def solve(R, t, s, lam):
        r, Ji, Jj = edge_jacobians(*_edge_nodes(g, R, t, s))
        H, b = scatter_blocks(N, 7, ei, ej, *weighted_blocks(w, Ji, Jj, r))
        return damped_solve(H, b, lam, 7).reshape(N, 7)

    R, t, s = g.R, g.t, g.s
    lam = torch.full((), lam0, dtype=torch.float32, device=R.device)
    cost0 = cost = cost_of(R, t, s)
    costs = []
    for _ in range(iters):
        dx = solve(R, t, s, lam)
        dR, dt, ds = sim3_exp(dx)
        R_c = orthonormalize(torch.einsum("nij,njk->nik", R, dR))
        t_c = s[:, None] * torch.einsum("nij,nj->ni", R, dt) + t
        s_c = s * ds
        cand = cost_of(R_c, t_c, s_c)
        ok = torch.isfinite(cand) & (cand < cost) & torch.isfinite(dx).all()
        R = torch.where(ok, R_c, R)
        t = torch.where(ok, t_c, t)
        s = torch.where(ok, s_c, s)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9), lam * 5.0)
        cost = torch.where(ok, cand, cost)
        costs.append(cost)
    return g._replace(R=R, t=t, s=s), {
        "initial_cost": cost0, "final_cost": cost,
        "costs": torch.stack(costs) if costs else cost0.new_zeros(0),
    }


def sim3_odometry_edges(R_seq, t_seq, s_seq, weight: float = 1.0):
    """Consecutive-node edges S_ij = S_i^-1 S_j of a node sequence: (edge_i,
    edge_j, edge_R, edge_t, edge_s, edge_weight)."""
    M = sim3_compose(sim3_inverse((R_seq[:-1], t_seq[:-1], s_seq[:-1])),
                     (R_seq[1:], t_seq[1:], s_seq[1:]))
    E = R_seq.shape[0] - 1
    ei = torch.arange(E, dtype=torch.int32, device=R_seq.device)
    return (ei, ei + 1, *M,
            torch.full((E,), weight, dtype=torch.float32, device=R_seq.device))
