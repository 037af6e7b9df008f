"""SE(3) pose-graph optimization for loop correction (port of
`vislam_tpu/backend/pose_graph.py`).

N node poses and E edges (weight 0 pads); the residual of an edge is
r_e = log(T_meas^-1 T_i^-1 T_j) in se(3). Damped Gauss-Newton with the
small-residual Jacobians J_j = I, J_i = -Ad(T_j^-1 T_i); the (6N, 6N)
normal matrix is dense (N is the keyframe count), assembled by
`index_put_(..., accumulate=True)` and solved by Cholesky, node 0 fixed.
The reference's `lax.scan` over `iters` steps is a Python loop whose
accept/reject is a `torch.where`: no value on the device steers the loop,
so the solve makes no host sync. A failed factorization gives NaN
(`backend/ba.py::cholesky_solve_or_nan`), which the step's test rejects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.backend.ba import cholesky_solve_or_nan
from vislam_tpu_torch.lie.se3 import se3_adjoint, se3_compose, se3_exp, se3_inverse, se3_log


class PoseGraph(NamedTuple):
    """Problem data. Poses are (R, t) like the BA's; an edge constrains
    T_ij = T_i^-1 T_j (node j's pose in node i's frame)."""

    R: torch.Tensor            # (N, 3, 3)
    t: torch.Tensor            # (N, 3)
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_R: torch.Tensor       # (E, 3, 3) measured relative rotations
    edge_t: torch.Tensor       # (E, 3)
    edge_weight: torch.Tensor  # (E,) residual weight (0 = padding)


def pose_graph_residuals(pg: PoseGraph):
    """(E, 6) se(3) residuals of all edges."""
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    T_ij = se3_compose(se3_inverse((pg.R[ei], pg.t[ei])), (pg.R[ej], pg.t[ej]))
    return se3_log(se3_compose(se3_inverse((pg.edge_R, pg.edge_t)), T_ij))


def scatter_blocks(n: int, d: int, ei, ej, Hii, Hjj, Hij, bi, bj):
    """The dense (n d, n d) normal matrix and (n d,) gradient of per-edge
    (E, d, d) blocks and (E, d) vectors: H[i, :, j, :] += Hij for each edge
    (and its transpose at [j, :, i, :]), accumulated in place."""
    ar = torch.arange(d, device=ei.device)
    ri = (ei[:, None] * d + ar)                 # (E, d) rows of node i
    rj = (ej[:, None] * d + ar)
    H = torch.zeros((n * d, n * d), dtype=Hii.dtype, device=Hii.device)
    b = torch.zeros(n * d, dtype=bi.dtype, device=bi.device)
    for rows, cols, blk in ((ri, ri, Hii), (rj, rj, Hjj), (ri, rj, Hij),
                            (rj, ri, Hij.transpose(-1, -2))):
        H.index_put_((rows[:, :, None].expand(blk.shape), cols[:, None, :].expand(blk.shape)),
                     blk, accumulate=True)
    b.index_put_((ri,), bi, accumulate=True)
    b.index_put_((rj,), bj, accumulate=True)
    return H, b


def damped_solve(H, b, lam, fixed: int):
    """dx = (H + diag(lam diag(H) + 1e-8))^-1 b with the first `fixed` rows
    and columns held (identity on their diagonal, zero gradient: node 0's
    gauge); NaN where the factorization fails."""
    n = H.shape[0]
    H = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
    free = torch.arange(n, device=H.device) >= fixed
    H = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
    H = H + torch.diag(torch.where(free, 0.0, 1.0).to(H.dtype))
    b = torch.where(free, b, torch.zeros_like(b))
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return cholesky_solve_or_nan(H + 1e-8 * eye, b)


def weighted_blocks(w, Ji, Jj, r):
    """The (E, d, d) blocks w Ji^T Ji, w Jj^T Jj, w Ji^T Jj and the (E, d)
    gradients -w Ji^T r, -w Jj^T r of weighted edges."""
    wj = w[:, None, None]
    Hii = wj * torch.einsum("eki,ekj->eij", Ji, Ji)
    Hjj = wj * torch.einsum("eki,ekj->eij", Jj, Jj)
    Hij = wj * torch.einsum("eki,ekj->eij", Ji, Jj)
    bi = -w[:, None] * torch.einsum("eki,ek->ei", Ji, r)
    bj = -w[:, None] * torch.einsum("eki,ek->ei", Jj, r)
    return Hii, Hjj, Hij, bi, bj


def optimize_pose_graph(pg: PoseGraph, iters: int = 10, lam0: float = 1e-4,
                        fix_first: bool = True):
    """Damped GN over all node poses. Returns (PoseGraph, info): info holds
    initial_cost, final_cost and costs (iters,), all on the device."""
    N = pg.R.shape[0]
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    w = pg.edge_weight

    def cost_of(R, t):
        r = pose_graph_residuals(pg._replace(R=R, t=t))
        return torch.sum(w[:, None] * r * r)

    def solve(R, t, lam):
        r = pose_graph_residuals(pg._replace(R=R, t=t))
        Ji = -se3_adjoint(se3_compose(se3_inverse((R[ej], t[ej])), (R[ei], t[ei])))
        Jj = torch.eye(6, dtype=R.dtype, device=R.device).expand(Ji.shape)
        H, b = scatter_blocks(N, 6, ei, ej, *weighted_blocks(w, Ji, Jj, r))
        return damped_solve(H, b, lam, 6 if fix_first else 0).reshape(N, 6)

    R, t = pg.R, pg.t
    lam = torch.full((), lam0, dtype=R.dtype, device=R.device)
    cost0 = cost = cost_of(R, t)
    costs = []
    for _ in range(iters):
        dx = solve(R, t, lam)
        dR, dt = se3_exp(dx)
        # Right-multiplicative update: T <- T exp(dx).
        R_c = torch.einsum("nij,njk->nik", R, dR)
        t_c = torch.einsum("nij,nj->ni", R, dt) + t
        cand = cost_of(R_c, t_c)
        ok = torch.isfinite(cand) & (cand < cost) & torch.isfinite(dx).all()
        R = torch.where(ok, R_c, R)
        t = torch.where(ok, t_c, t)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9), lam * 5.0)
        cost = torch.where(ok, cand, cost)
        costs.append(cost)
    return pg._replace(R=R, t=t), {
        "initial_cost": cost0, "final_cost": cost,
        "costs": torch.stack(costs) if costs else cost0.new_zeros(0),
    }


def odometry_edges(R_seq, t_seq, weight: float = 1.0):
    """Consecutive-pose edges (i, i + 1) of a trajectory: (edge_i, edge_j,
    edge_R, edge_t, edge_weight)."""
    N = R_seq.shape[0]
    ei = torch.arange(N - 1, dtype=torch.int32, device=R_seq.device)
    R_ij, t_ij = se3_compose(se3_inverse((R_seq[:-1], t_seq[:-1])), (R_seq[1:], t_seq[1:]))
    return ei, ei + 1, R_ij, t_ij, torch.full((N - 1,), weight, dtype=torch.float32,
                                              device=R_seq.device)
