"""vislam_tpu_torch against vislam_tpu: the SE(3) and Sim(3) pose graphs
(residuals, odometry edges, the damped Gauss-Newton optimizers) on the
reference tests' drifted problems (`tests/test_pose_graph.py:39`, a
24-node circle with odometry noise and one loop edge; `tests/test_sim3.py:59`,
a 20-node circle with 2% scale creep per step), with padded edges and a
forced Cholesky failure.

Tolerances. Residuals and edges: the same float32 formulas, 1e-5. The
optimizers assemble the normal matrix from the same blocks in another
order (scatter-add against XLA's) and factor it with another Cholesky, so
each step's update differs by float32 round-off amplified by the system's
conditioning: each accepted step is the same, and the final nodes agree
to 1e-5 for SE(3) (positions in metres on a 4-5 m circle, rotation
entries; measured 7.2e-7), every step's cost to 1e-5 of the initial cost
(measured 3e-9). The Sim(3) nodes are held to 1e-4 (`SIM3_TOL`, was 1e-5):
the reference's own nodes move by up to 5.2e-5 under a 1-ulp change of its
positions and edge translations (16 random sign patterns, on an AVX-512
host and with every library limited to AVX2 alike), and the port lies
1.6e-5 from it on an AVX-512 host (9.5e-7 where written); 1e-4 is that
spread times about 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsp

from test_pose_graph import _circle_trajectory
from vislam_tpu.backend import pose_graph as jpg
from vislam_tpu.backend import sim3_graph as jsg
from vislam_tpu.lie import se3 as jse3
from vislam_tpu.lie import sim3 as jsim3
from vislam_tpu_torch.backend import pose_graph as tpg
from vislam_tpu_torch.backend import sim3_graph as tsg

torch.set_num_threads(2)
GRAPH_TOL = dict(rtol=0, atol=1e-5)
SIM3_TOL = dict(rtol=0, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _drifted_circle():
    """tests/test_pose_graph.py:39's problem as numpy: GT odometry edges, a
    noisy integration, a weight-10 loop edge 23 -> 0."""
    R_gt, t_gt = _circle_trajectory(N=24)
    ei, ej, eR, et, w = [np.array(x) for x in jpg.odometry_edges(jnp.asarray(R_gt),
                                                                 jnp.asarray(t_gt))]
    rng = np.random.default_rng(0)
    R_n, t_n = [R_gt[0]], [t_gt[0]]
    for k in range(23):
        dR = Rsp.from_rotvec(rng.normal(scale=0.01, size=3)).as_matrix() @ eR[k]
        dt = et[k] + rng.normal(scale=0.02, size=3)
        R_n.append(R_n[-1] @ dR)
        t_n.append(R_n[-2] @ dt + t_n[-1])
    T_loop = [np.array(x) for x in jse3.se3_compose(
        jse3.se3_inverse((jnp.asarray(R_gt[23]), jnp.asarray(t_gt[23]))),
        (jnp.asarray(R_gt[0]), jnp.asarray(t_gt[0])))]
    return dict(R=np.array(R_n, np.float32), t=np.array(t_n, np.float32),
                ei=np.append(ei, 23).astype(np.int32), ej=np.append(ej, 0).astype(np.int32),
                eR=np.concatenate([eR, T_loop[0][None]]),
                et=np.concatenate([et, T_loop[1][None]]),
                w=np.append(w, 10.0).astype(np.float32), t_gt=t_gt)


def _pad(g, n=4):
    """n weight-0 garbage edges on node 0 (tests/test_pose_graph.py:75)."""
    return {**g, "ei": np.append(g["ei"], np.zeros(n, np.int32)),
            "ej": np.append(g["ej"], np.zeros(n, np.int32)),
            "eR": np.concatenate([g["eR"], np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))]),
            "et": np.concatenate([g["et"], np.full((n, 3), 77.0, np.float32)]),
            "w": np.append(g["w"], np.zeros(n, np.float32))}


def _pg(mod, g, to):
    return mod.PoseGraph(*[to(g[k]) for k in ("R", "t", "ei", "ej", "eR", "et", "w")])


def test_se3_odometry_edges_and_residuals_match_reference():
    g = _drifted_circle()
    j_e = jpg.odometry_edges(jnp.asarray(g["R"]), jnp.asarray(g["t"]))
    t_e = tpg.odometry_edges(_t(g["R"]), _t(g["t"]))
    for a, b in zip(t_e, j_e):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpg.pose_graph_residuals(_pg(tpg, g, _t)).numpy(),
                               np.array(jpg.pose_graph_residuals(_pg(jpg, g, jnp.asarray))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
def test_se3_pose_graph_corrects_drift_as_reference(padded):
    """15 iterations on the drifted circle: the reference's nodes and costs,
    the reference test's drift reduction; padding changes nothing."""
    g = _drifted_circle()
    g = _pad(g) if padded else g
    j_out, j_info = jpg.optimize_pose_graph(_pg(jpg, g, jnp.asarray), iters=15)
    t_out, t_info = tpg.optimize_pose_graph(_pg(tpg, g, _t), iters=15)
    c0 = float(j_info["initial_cost"])
    np.testing.assert_allclose(float(t_info["initial_cost"]), c0, rtol=1e-5)
    np.testing.assert_allclose(t_info["costs"].numpy(), np.array(j_info["costs"]),
                               rtol=0, atol=1e-5 * c0)
    np.testing.assert_allclose(t_out.t.numpy(), np.array(j_out.t), **GRAPH_TOL)
    np.testing.assert_allclose(t_out.R.numpy(), np.array(j_out.R), **GRAPH_TOL)
    assert float(t_info["final_cost"]) < 0.05 * c0
    drift_before = np.linalg.norm(g["t"] - g["t_gt"], axis=-1)
    drift_after = np.linalg.norm(t_out.t.numpy() - g["t_gt"], axis=-1)
    assert drift_after.max() < 0.5 * drift_before.max() and drift_after.mean() < 0.12


def test_failed_cholesky_gives_nan_and_keeps_poses():
    """A loop edge of negative weight makes the normal matrix indefinite:
    the solve returns NaN (no raise), every step is rejected and the nodes
    stay, as the reference's NaN from jnp.linalg.cholesky."""
    g = _drifted_circle()
    g["w"][-1] = -100.0
    H = torch.diag(torch.tensor([4.0, -1.0, 2.0]))
    assert torch.isnan(tpg.damped_solve(H, torch.ones(3), torch.tensor(1e-4), 0)).all()
    j_out, j_info = jpg.optimize_pose_graph(_pg(jpg, g, jnp.asarray), iters=3)
    t_out, t_info = tpg.optimize_pose_graph(_pg(tpg, g, _t), iters=3)
    np.testing.assert_array_equal(np.array(j_out.t), g["t"])
    np.testing.assert_array_equal(t_out.t.numpy(), g["t"])
    np.testing.assert_array_equal(t_out.R.numpy(), g["R"])
    assert float(t_info["final_cost"]) == float(t_info["initial_cost"])


def _scale_drift():
    """tests/test_sim3.py:59's problem as numpy: odometry from nodes with 2%
    scale creep per step, one metric weight-20 loop edge 19 -> 0."""
    N = 20
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    R_gt = np.stack([Rsp.from_euler("z", a + np.pi / 2).as_matrix() for a in ang]
                    ).astype(np.float32)
    t_gt = np.stack([[4 * np.cos(a), 4 * np.sin(a), 0.0] for a in ang]).astype(np.float32)
    R_n, t_n, s_n = [R_gt[0]], [t_gt[0]], [1.0]
    for k in range(N - 1):
        dR = R_gt[k].T @ R_gt[k + 1]
        dt = R_gt[k].T @ (t_gt[k + 1] - t_gt[k])
        s_now = s_n[-1] * 1.02
        R_n.append(R_n[-1] @ dR)
        t_n.append(s_now * (R_n[-2] @ dt) + t_n[-1])
        s_n.append(s_now)
    R_n, t_n = np.stack(R_n).astype(np.float32), np.stack(t_n).astype(np.float32)
    s_n = np.asarray(s_n, np.float32)
    e = [np.array(x) for x in jsg.sim3_odometry_edges(jnp.asarray(R_n), jnp.asarray(t_n),
                                                      jnp.asarray(s_n))]
    one = jnp.asarray(1.0)
    T_loop = [np.array(x) for x in jsim3.sim3_compose(
        jsim3.sim3_inverse((jnp.asarray(R_gt[N - 1]), jnp.asarray(t_gt[N - 1]), one)),
        (jnp.asarray(R_gt[0]), jnp.asarray(t_gt[0]), one))]
    return dict(R=R_n, t=t_n, s=s_n, ei=np.append(e[0], N - 1).astype(np.int32),
                ej=np.append(e[1], 0).astype(np.int32),
                eR=np.concatenate([e[2], T_loop[0][None]]),
                et=np.concatenate([e[3], T_loop[1][None]]),
                es=np.append(e[4], T_loop[2]).astype(np.float32),
                w=np.append(e[5], 20.0).astype(np.float32), t_gt=t_gt)


def _sg(mod, g, to):
    return mod.Sim3Graph(*[to(g[k]) for k in ("R", "t", "s", "ei", "ej", "eR", "et", "es", "w")])


def test_sim3_odometry_edges_and_residuals_match_reference():
    g = _scale_drift()
    t_e = tsg.sim3_odometry_edges(_t(g["R"]), _t(g["t"]), _t(g["s"]))
    j_e = jsg.sim3_odometry_edges(jnp.asarray(g["R"]), jnp.asarray(g["t"]), jnp.asarray(g["s"]))
    for a, b in zip(t_e, j_e):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsg.sim3_graph_residuals(_sg(tsg, g, _t)).numpy(),
                               np.array(jsg.sim3_graph_residuals(_sg(jsg, g, jnp.asarray))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
def test_sim3_graph_corrects_scale_drift_as_reference(padded):
    """20 iterations on the scale-drift circle: the reference's nodes (R, t,
    s) within SIM3_TOL and costs, and the reference test's bounds (end
    scale back near 1, worst position error halved)."""
    g = _scale_drift()
    if padded:
        p = _pad(g)
        g = {**p, "es": np.append(g["es"], np.ones(4, np.float32))}
    j_out, j_info = jsg.optimize_sim3_graph(_sg(jsg, g, jnp.asarray), iters=20)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        t_out, t_info = tsg.optimize_sim3_graph(_sg(tsg, g, _t), iters=20)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    c0 = float(j_info["initial_cost"])
    np.testing.assert_allclose(float(t_info["initial_cost"]), c0, rtol=1e-5)
    np.testing.assert_allclose(t_info["costs"].numpy(), np.array(j_info["costs"]),
                               rtol=0, atol=1e-5 * c0)
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(t_out, k).numpy(), np.array(getattr(j_out, k)),
                                   **SIM3_TOL)
    assert float(t_info["final_cost"]) < 0.05 * c0
    assert abs(float(t_out.s[-1]) - 1.0) < 0.1
    err = [np.linalg.norm(x - g["t_gt"], axis=-1).max() for x in (g["t"], t_out.t.numpy())]
    assert err[1] < 0.5 * err[0]
