"""vislam_tpu_torch against vislam_tpu: SO(3)/SE(3) logarithms, the window
bundle adjustments (`backend/ba.py`, `backend/vi_ba.py`) and their
conversion from the reference's trees (`utils/convert.py`).

Tolerances. The Lie maps are the same formulas on the same float32 inputs:
1e-5. The normal equations are sums of hundreds of float32 products in
another order: rtol 1e-4 / atol 1e-5 of each block's largest entry (the
blocks span eight orders of magnitude, weights up to 1e4 / dt, so an
absolute floor must scale with the block). The LM runs compare the
reference's own problem (`tests/test_vi_ba.py:80`), with and without 0.5
px of seeded noise on its observations: iterations run equal, final cost
within 1e-3 relative, poses within 1e-3 m, where the reference itself is
that stable (the VI-BA test says where it is not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from test_vi_ba import G, _window
from vislam_tpu import lie as jlie
from vislam_tpu.backend import ba as jba
from vislam_tpu.backend import vi_ba as jvi
from vislam_tpu_torch import lie as tlie
from vislam_tpu_torch.backend import ba as tba
from vislam_tpu_torch.backend import vi_ba as tvi
from vislam_tpu_torch.utils.convert import ba_from_numpy, ba_to_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rotations(rng, n=64):
    """Random rotations plus the probes: identity, 180 degrees about each
    axis and about a skew axis, just under 180, tiny angles."""
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-7, -2e-7, 5e-8]
    w[2:5] = np.pi * np.eye(3, dtype=np.float32)
    w[5] = np.pi * np.array([1, 1, 0], np.float32) / np.sqrt(2)
    w[6] = (np.pi - 1e-4) * np.array([0, 0.6, 0.8], np.float32)
    return np.array(jlie.so3_exp(jnp.asarray(w)))


@pytest.mark.parametrize("fn", ["so3_log", "so3_vee", "so3_left_jacobian_inv"])
def test_so3_maps_match_reference(rng, fn):
    R = _rotations(rng)
    x = {"so3_log": R, "so3_vee": R - np.swapaxes(R, -1, -2),
         "so3_left_jacobian_inv": rng.normal(size=(64, 3)).astype(np.float32)}[fn]
    if fn == "so3_left_jacobian_inv":
        x[0] = 0.0
        x[1] = [1e-7, 0.0, 0.0]
    np.testing.assert_allclose(getattr(tlie, fn)(_t(x)).numpy(),
                               np.asarray(getattr(jlie, fn)(jnp.asarray(x))), **TOL)


def test_so3_log_probes():
    """Zero rotation -> 0; 180 degrees -> angle pi about the axis (up to its
    sign, as the reference); log inverts exp."""
    I = np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(tlie.so3_log(_t(I)).numpy(), np.zeros(3))
    for k in range(3):
        R = 2.0 * np.outer(I[k], I[k]) - I          # 180 degrees about axis k
        w = tlie.so3_log(_t(R)).numpy()
        np.testing.assert_allclose(np.abs(w), np.pi * I[k], atol=1e-5)
        np.testing.assert_allclose(w, np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)
    w = torch.tensor([0.3, -1.2, 2.0])
    np.testing.assert_allclose(tlie.so3_log(tlie.so3_exp(w)).numpy(), w.numpy(), atol=1e-5)


def test_jacobians_through_log_and_exp_are_finite():
    """jacfwd through so3_log and se3_exp at their fixpoints (identity,
    zero twist) and at 180 degrees: finite, as the reference's grads are.
    Batched (1, ...) inputs, as the bundle adjustments differentiate them."""
    for R in (torch.eye(3), torch.diag(torch.tensor([1.0, -1.0, -1.0]))):
        J = jacfwd(tlie.so3_log)(R[None])
        assert torch.isfinite(J).all(), J
    for out in (0, 1):
        J = jacfwd(lambda x: tlie.se3_exp(x)[out])(torch.zeros(1, 6))
        assert torch.isfinite(J).all()
    for J in jacfwd(tlie.se3_log)((torch.eye(3)[None], torch.zeros(1, 3))):
        assert torch.isfinite(J).all()


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log"])
def test_se3_maps_match_reference(rng, fn):
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = [np.pi, 0.0, 0.0]
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    if fn == "se3_exp":
        Rt, tt = tlie.se3_exp(_t(xi))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), **TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL)
    else:
        np.testing.assert_allclose(tlie.se3_log((_t(Rj), _t(tj))).numpy(),
                                   np.asarray(jlie.se3_log((Rj, tj))), **TOL)


def _random_window(rng, W=6, L=48):
    """The reference test's window with every pose, velocity and landmark
    perturbed, and random IMU bias Jacobians: a problem away from its
    optimum, in both packages' trees."""
    R_cw, t_cw, v, p, X, fac, prob = _window(rng, W=W, L=L)
    dR = jlie.so3_exp(jnp.asarray(rng.normal(scale=0.02, size=(W, 3)).astype(np.float32)))
    R_cw = jnp.einsum("wij,wjk->wik", dR, R_cw)
    t_cw = t_cw + rng.normal(scale=0.05, size=(W, 3)).astype(np.float32)
    X = X + rng.normal(scale=0.1, size=X.shape).astype(np.float32)
    v = v + rng.normal(scale=0.1, size=v.shape).astype(np.float32)
    J = lambda: jnp.asarray(rng.normal(scale=0.1, size=(W, 3, 3)).astype(np.float32))
    b = lambda: jnp.asarray(rng.normal(scale=0.01, size=(W, 3)).astype(np.float32))
    fac = fac._replace(J_R_bg=J(), J_v_bg=J(), J_v_ba=J(), J_p_bg=J(), J_p_ba=J(),
                       bg_ref=b(), ba_ref=b())
    st = jba.BAState(R=R_cw, t=t_cw, X=X)
    return (st, prob, v, fac), (ba_from_numpy(_np(st), "cpu"), ba_from_numpy(_np(prob), "cpu"),
                                _t(v), ba_from_numpy(_np(fac), "cpu"))


def _close_blocks(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-5 * max(np.abs(j).max(), 1.0))


def test_ba_trees_convert_both_ways(rng):
    (st, prob, _, fac), (tst, tprob, _, tfac) = _random_window(rng)
    assert isinstance(tprob.fx, float) and tprob.obs_mask.dtype == torch.bool
    assert tfac.has_bias_jacobians and tfac.valid.dtype == torch.bool
    for tree, back in ((st, ba_to_numpy(tst)), (prob, ba_to_numpy(tprob)),
                       (fac, ba_to_numpy(tfac))):
        for a, b in zip(tree, back):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bare = ba_from_numpy(_np(fac._replace(J_R_bg=None, J_v_bg=None, J_v_ba=None, J_p_bg=None,
                                          J_p_ba=None, bg_ref=None, ba_ref=None)), "cpu")
    assert not bare.has_bias_jacobians and bare.bg_ref is None


def test_build_normal_equations_matches_reference(rng):
    (st, prob, _, _), (tst, tprob, _, _) = _random_window(rng)
    for t, j in zip(tba.build_normal_equations(tst, tprob, 2.0),
                    jba.build_normal_equations(st, prob, 2.0)):
        _close_blocks(t, j)


@pytest.mark.parametrize("gauge", ["fix_first", "ends"])
def test_schur_solve_matches_reference(rng, gauge):
    (st, prob, _, _), (tst, tprob, _, _) = _random_window(rng)
    W = st.R.shape[0]
    blocks_j = jba.build_normal_equations(st, prob, 2.0)[:5]
    blocks_t = tba.build_normal_equations(tst, tprob, 2.0)[:5]
    fixed = np.isin(np.arange(W), [0, 1, W - 1])
    kw_j = dict(fix_first=1) if gauge == "fix_first" else dict(fixed_mask=jnp.asarray(fixed))
    kw_t = dict(fix_first=1) if gauge == "fix_first" else dict(fixed_mask=torch.from_numpy(fixed))
    dxi_j, dX_j = jba.schur_solve(*blocks_j, 1e-2, **kw_j)
    dxi_t, dX_t = tba.schur_solve(*blocks_t, torch.tensor(1e-2), **kw_t)
    _close_blocks(dxi_t, dxi_j)
    _close_blocks(dX_t, dX_j)


@pytest.mark.parametrize("bias", [False, True])
def test_imu_normal_equations_match_reference(rng, bias):
    (st, _, v, fac), (tst, _, tv, tfac) = _random_window(rng)
    args_j = (st.R, st.t, v, fac, jnp.asarray(G), jnp.eye(3), 1e4, 1e2, 1e2)
    args_t = (tst.R, tst.t, tv, tfac, _t(G), torch.eye(3), 1e4, 1e2, 1e2)
    if bias:
        bj = [jnp.asarray(x) for x in (np.full(3, 0.01), np.full(3, -0.02), np.zeros(3),
                                       np.zeros(3))]
        H_j, b_j = jvi._imu_normal_equations_bias(*args_j, *bj, 1e4, 3e3)
        H_t, b_t = tvi._imu_normal_equations_bias(*args_t, *[_t(x) for x in bj], 1e4, 3e3)
    else:
        H_j, b_j = jvi._imu_normal_equations(*args_j)
        H_t, b_t = tvi._imu_normal_equations(*args_t)
    _close_blocks(H_t, H_j)
    _close_blocks(b_t, b_j)


def _scaled_problem(rng, noise_px=0.5):
    """tests/test_vi_ba.py:80: the GT window rescaled by 0.75 about pose 0
    (reprojection unchanged, IMU factors violated), with `noise_px` of
    seeded noise on the observations. Without noise the optimum's cost is
    float32 round-off (4e-8 of 6e-2), and where the LM stops there is
    round-off too: iterations run 21 against the reference's 20, measured."""
    R_cw, t_cw, v, p, X, fac, prob = _window(rng)
    prob = prob._replace(obs_uv=prob.obs_uv + jnp.asarray(
        rng.normal(scale=noise_px, size=prob.obs_uv.shape).astype(np.float32)))
    p0 = p[0]
    st = jba.BAState(R=R_cw, t=-jnp.einsum("wij,wj->wi", R_cw, p0 + 0.75 * (p - p0)),
                     X=p0 + 0.75 * (X - p0))
    return st, prob, 0.75 * v, fac


def _positions(st):
    R, t = (np.asarray(x) for x in (st.R, st.t))
    return -np.einsum("wji,wj->wi", R, t)


def _hold_lm(info_t, info_j, st_t, st_j):
    assert int(info_t.get("iters_run", 0)) == int(info_j.get("iters_run", 0))
    f_t, f_j, c0 = (float(info_t["final_cost"]), float(info_j["final_cost"]),
                    float(info_j["initial_cost"]))
    assert float(info_t["initial_cost"]) == pytest.approx(c0, rel=1e-5)
    assert f_t == pytest.approx(f_j, rel=1e-3), (f_t, f_j, c0)
    np.testing.assert_allclose(_positions(st_t), _positions(st_j), atol=1e-3)


def test_bundle_adjust_matches_reference(rng):
    st, prob, _, _ = _scaled_problem(rng)
    st = st._replace(X=st.X + jnp.asarray(rng.normal(scale=0.05, size=st.X.shape)
                                          .astype(np.float32)))
    fixed = np.arange(st.R.shape[0]) < 2
    ref, info_j = jba.bundle_adjust(st, prob, iters=12, fixed_mask=jnp.asarray(fixed))
    out, info_t = tba.bundle_adjust(ba_from_numpy(_np(st), "cpu"), ba_from_numpy(_np(prob), "cpu"),
                                    iters=12, fixed_mask=torch.from_numpy(fixed))
    assert float(info_j["final_cost"]) < 0.5 * float(info_j["initial_cost"])
    _hold_lm(info_t, info_j, out, ref)
    np.testing.assert_allclose(info_t["costs"].numpy(), np.asarray(info_j["costs"]), rtol=1e-3)


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
@pytest.mark.parametrize("bias", [False, True])
def test_vi_bundle_adjust_recovers_scale_like_reference(rng, bias, noise_px):
    """The reference test's run (25 iterations), with the bias estimated or
    not (zero bias Jacobians and prior at zero: the same problem).

    What each problem can show was measured on the reference alone, with
    its input velocities changed by 1 ulp (1e-7 relative). Noise-free, the
    optimum is exact and its position is stable (moves <= 7e-5 m), but the
    LM's stopping point is round-off (19 to 25 iterations): poses within
    1e-3 m, velocities within 1e-3 m/s, both converged. With 0.5 px of
    noise, the stopping point is stable (6 iterations, final cost within
    6e-6 relative) but the optimum is flat along the scale (moves 3.2e-3
    m): iterations equal, final cost within 1e-3 relative, poses within
    1e-2 m."""
    st, prob, v, fac = _scaled_problem(rng, noise_px)
    kw_j, kw_t = {}, {}
    if bias:
        z33 = jnp.zeros((6, 3, 3))
        fac = fac._replace(J_R_bg=z33, J_v_bg=z33, J_v_ba=z33, J_p_bg=z33, J_p_ba=z33,
                           bg_ref=jnp.zeros((6, 3)), ba_ref=jnp.zeros((6, 3)))
        kw_j = dict(bg0=jnp.zeros(3), ba0=jnp.zeros(3))
        kw_t = dict(bg0=torch.zeros(3), ba0=torch.zeros(3))
    out_j, info_j = jvi.vi_bundle_adjust(st, prob, v, fac, jnp.asarray(G), jnp.eye(3),
                                         iters=25, **kw_j)
    out_t, info_t = tvi.vi_bundle_adjust(
        ba_from_numpy(_np(st), "cpu"), ba_from_numpy(_np(prob), "cpu"), _t(v),
        ba_from_numpy(_np(fac), "cpu"), _t(G), torch.eye(3), iters=25, **kw_t)
    assert len(out_t) == len(out_j) == (4 if bias else 2)
    c0 = float(info_j["initial_cost"])
    assert float(info_t["initial_cost"]) == pytest.approx(c0, rel=1e-5)
    f_t, f_j = float(info_t["final_cost"]), float(info_j["final_cost"])
    if noise_px == 0.0:
        assert f_t < 1e-6 * c0 and f_j < 1e-6 * c0, (f_t, f_j, c0)
        np.testing.assert_allclose(_positions(out_t[0]), _positions(out_j[0]), atol=1e-3)
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-3)
    else:
        assert int(info_t["iters_run"]) == int(info_j["iters_run"])
        assert f_t == pytest.approx(f_j, rel=1e-3), (f_t, f_j)
        np.testing.assert_allclose(_positions(out_t[0]), _positions(out_j[0]), atol=1e-2)


def _spd(rng, scale_lo=1.0, scale_hi=4.0):
    """A random (9, 9) SPD information matrix, eigenvalues 10^lo .. 10^hi."""
    Q, _ = np.linalg.qr(rng.normal(size=(9, 9)))
    return ((Q * np.logspace(scale_lo, scale_hi, 9)) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("fn", ["prior_residual", "marginal_info_slot1"])
def test_marginalization_pieces_match_reference(rng, fn):
    """The slot-0 prior's residual (the same formulas: 1e-5) and the Schur
    complement a prior hands to slot 1 (a 9x9 solve on blocks of a random
    window's IMU system: the normal-equation tolerances)."""
    (st, _, v, fac), (tst, _, tv, tfac) = _random_window(rng)
    if fn == "prior_residual":
        lin = (np.array(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.3, size=3)
                                                 .astype(np.float32)))),
               rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32))
        ref = jvi.prior_residual(st.R[0], st.t[0], v[0], *map(jnp.asarray, lin))
        got = tvi.prior_residual(tst.R[0], tst.t[0], tv[0], *map(_t, lin))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    else:
        H_j, _ = jvi._imu_normal_equations(st.R, st.t, v, fac, jnp.asarray(G), jnp.eye(3),
                                           1e4, 1e2, 1e2)
        H_t, _ = tvi._imu_normal_equations(tst.R, tst.t, tv, tfac, _t(G), torch.eye(3),
                                           1e4, 1e2, 1e2)
        W = st.R.shape[0]
        pH = _spd(rng)
        ref = jvi.marginal_info_slot1(H_j.reshape(W * 9, W * 9), jnp.asarray(pH), 1e-6)
        got = tvi.marginal_info_slot1(H_t.reshape(W * 9, W * 9), _t(pH), 1e-6)
        _close_blocks(got, ref)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_vi_bundle_adjust_marginal_prior_matches_reference(rng, bias, prior):
    """The `marg` gauge's branches on the reference test's noisy problem:
    compute_marginal always, with no prior (slot 0 pinned, the marginal
    from the bootstrap's identity prior) or with a random SPD prior_H on a
    slot-0 linearisation point 5 cm / 0.02 rad / 0.05 m/s off, nothing
    pinned (the prior is the gauge; its blocks padded into either solve
    layout). The LM is held as the noisy case above (iterations equal,
    final cost 1e-3 relative, poses 1e-2 m); marg_H, a function of the
    final estimate, within 1e-3 of its largest entry, marg_lin as the
    poses."""
    st, prob, v, fac = _scaled_problem(rng, 0.5)
    kw_j, kw_t = dict(compute_marginal=True), dict(compute_marginal=True)
    if bias:
        z33 = jnp.zeros((6, 3, 3))
        fac = fac._replace(J_R_bg=z33, J_v_bg=z33, J_v_ba=z33, J_p_bg=z33, J_p_ba=z33,
                           bg_ref=jnp.zeros((6, 3)), ba_ref=jnp.zeros((6, 3)))
        kw_j.update(bg0=jnp.zeros(3), ba0=jnp.zeros(3))
        kw_t.update(bg0=torch.zeros(3), ba0=torch.zeros(3))
    if prior:
        pH = _spd(rng)
        dR = np.array(jlie.so3_exp(jnp.full((3,), 0.02 / np.sqrt(3), jnp.float32)))
        lin = (dR @ np.asarray(st.R[0]), np.asarray(st.t[0]) + 0.05 / np.sqrt(3),
               np.asarray(v[0]) + 0.05 / np.sqrt(3))
        free = np.zeros(st.R.shape[0], bool)
        kw_j.update(prior_H=jnp.asarray(pH), prior_lin=tuple(map(jnp.asarray, lin)),
                    fixed_mask=jnp.asarray(free))
        kw_t.update(prior_H=_t(pH), prior_lin=tuple(map(_t, lin)),
                    fixed_mask=torch.from_numpy(free))
    out_j, info_j = jvi.vi_bundle_adjust(st, prob, v, fac, jnp.asarray(G), jnp.eye(3),
                                         iters=25, **kw_j)
    out_t, info_t = tvi.vi_bundle_adjust(
        ba_from_numpy(_np(st), "cpu"), ba_from_numpy(_np(prob), "cpu"), _t(v),
        ba_from_numpy(_np(fac), "cpu"), _t(G), torch.eye(3), iters=25, **kw_t)
    assert len(out_t) == len(out_j) == (4 if bias else 2)
    assert int(info_t["iters_run"]) == int(info_j["iters_run"])
    c0 = float(info_j["initial_cost"])
    assert float(info_t["initial_cost"]) == pytest.approx(c0, rel=1e-5)
    f_t, f_j = float(info_t["final_cost"]), float(info_j["final_cost"])
    assert f_j < c0 and f_t == pytest.approx(f_j, rel=1e-3), (f_t, f_j, c0)
    np.testing.assert_allclose(_positions(out_t[0]), _positions(out_j[0]), atol=1e-2)
    m_j = np.asarray(info_j["marg_H"])
    assert np.isfinite(m_j).all() and np.allclose(m_j, m_j.T)
    np.testing.assert_allclose(info_t["marg_H"].numpy(), m_j, rtol=1e-3,
                               atol=1e-3 * np.abs(m_j).max())
    for x, y in zip(info_t["marg_lin"], info_j["marg_lin"]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-2)


@pytest.mark.parametrize("which", ["ba", "vi_ba"])
def test_singular_system_is_rejected_like_reference(rng, which):
    """A normal system that is not positive definite (negative damping):
    the reference's Cholesky gives NaN and every step is rejected; the
    port's cholesky_ex gives the same reject, never an exception."""
    st, prob, v, fac = _scaled_problem(rng)
    tst, tprob = ba_from_numpy(_np(st), "cpu"), ba_from_numpy(_np(prob), "cpu")
    if which == "ba":
        ref, info_j = jba.bundle_adjust(st, prob, iters=4, lam0=-1e3)
        out, info_t = tba.bundle_adjust(tst, tprob, iters=4, lam0=-1e3)
    else:
        (ref, _), info_j = jvi.vi_bundle_adjust(st, prob, v, fac, jnp.asarray(G), jnp.eye(3),
                                                iters=4, lam0=-1e3)
        (out, _), info_t = tvi.vi_bundle_adjust(tst, tprob, _t(v), ba_from_numpy(_np(fac), "cpu"),
                                                _t(G), torch.eye(3), iters=4, lam0=-1e3)
        assert int(info_t["iters_run"]) == int(info_j["iters_run"]) == 4
    assert float(info_j["final_cost"]) == float(info_j["initial_cost"])
    assert float(info_t["final_cost"]) == float(info_t["initial_cost"])
    assert float(info_t["lam"]) == pytest.approx(float(info_j["lam"]))
    np.testing.assert_array_equal(out.t.numpy(), np.asarray(st.t))
    dxi, _ = tba.schur_solve(*tba.build_normal_equations(tst, tprob, 2.0)[:5],
                             torch.tensor(-1e3))
    assert torch.isnan(dxi).all()
