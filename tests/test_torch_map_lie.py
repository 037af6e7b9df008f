"""vislam_tpu_torch against vislam_tpu: the SE(3) and Sim(3) maps the map
backend uses, and the Sim(3) pose graph's forward-mode Jacobians at zero.

Tolerances. The maps are the same float32 formulas on the same inputs, so
they agree to float32 round-off: 1e-5 absolute on unit-scale values (2e-5
relative where a 3x3 solve or a product of three transforms intervenes).
The Jacobians are forward-mode derivatives of the same residual, taken per
edge by `jax.vmap(jax.jacfwd)` and by one `torch.func.jacfwd` over a shared
perturbation: 1e-4 absolute (entries up to ~10: derivatives of logs and
exps through the 3x3 solve of sim3_log).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.backend import sim3_graph as jgraph
from vislam_tpu.lie import se3 as jse3
from vislam_tpu.lie import sim3 as jsim3
from vislam_tpu_torch.backend import sim3_graph as tgraph
from vislam_tpu_torch.lie import se3 as tse3
from vislam_tpu_torch.lie import sim3 as tsim3

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(tree):
    return [np.array(x) for x in tree]


def _twists(rng, n, dim, scale):
    """Random twists at `scale`, with the probes: zero, a tiny rotation, a
    rotation just under pi, sigma exactly 0 and tiny."""
    xi = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:6] = [1e-7, -2e-7, 5e-8]
    xi[2, 3:6] = (np.pi - 1e-3) * np.array([0.0, 0.6, 0.8])
    if dim == 7:
        xi[3, 6] = 0.0
        xi[4, 6] = 3e-7
        xi[5, 3:6] = 0.0
        xi[5, 6] = 0.4
    return xi


@pytest.mark.parametrize("fn", ["se3_compose", "se3_inverse", "se3_apply", "se3_adjoint"])
def test_se3_maps_match_reference(rng, fn):
    xi = _twists(rng, 32, 6, 0.8)
    A, B = jse3.se3_exp(jnp.asarray(xi)), jse3.se3_exp(jnp.asarray(xi[::-1].copy()))
    p = rng.normal(size=(32, 3)).astype(np.float32)
    tA, tB = [_t(x) for x in A], [_t(x) for x in B]
    j_out = {"se3_compose": lambda: jse3.se3_compose(A, B),
             "se3_inverse": lambda: jse3.se3_inverse(A),
             "se3_apply": lambda: (jse3.se3_apply(A, jnp.asarray(p)),),
             "se3_adjoint": lambda: (jse3.se3_adjoint(A),)}[fn]()
    t_out = {"se3_compose": lambda: tse3.se3_compose(tA, tB),
             "se3_inverse": lambda: tse3.se3_inverse(tA),
             "se3_apply": lambda: (tse3.se3_apply(tA, _t(p)),),
             "se3_adjoint": lambda: (tse3.se3_adjoint(tA),)}[fn]()
    for a, b in zip(t_out, _np(j_out)):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_se3_compose_inverse_round_trip(rng):
    T = tse3.se3_exp(_t(_twists(rng, 32, 6, 1.0)))
    R, t = tse3.se3_compose(T, tse3.se3_inverse(T))
    np.testing.assert_allclose(R.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("scale,dtype", [(1e-8, np.float32), (1e-5, np.float64),
                                         (0.3, np.float32), (1.2, np.float32)])
def test_sim3_exp_log_match_reference(rng, scale, dtype):
    """exp and log of the reference's regimes: theta and sigma each small
    (below 1e-6) or regular, and rotations near pi. Between 1e-6 and ~1e-2
    the reference's general-case coefficients cancel catastrophically in
    float32 (at theta ~ 2e-5, its W is off the identity by 4e-3), the
    port's series do not (`test_sim3_W_float32_matches_reference_float64`):
    there both run in float64 and agree to round-off."""
    xi = _twists(rng, 48, 7, scale).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        j_T = _np(jsim3.sim3_exp(jnp.asarray(xi)))
        j_log = np.asarray(jsim3.sim3_log(tuple(map(jnp.asarray, j_T))))
        j_W = np.asarray(jsim3._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])))
    assert j_T[0].dtype == dtype
    t_T = tsim3.sim3_exp(torch.from_numpy(xi))
    for a, b in zip(t_T, j_T):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # log of the reference's own transforms (inputs bit-identical).
    np.testing.assert_allclose(tsim3.sim3_log([torch.from_numpy(x) for x in j_T]).numpy(),
                               j_log, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tsim3._sim3_W(torch.from_numpy(xi[:, 3:6]),
                                             torch.from_numpy(xi[:, 6])).numpy(), j_W, **TOL)


def _W_grid(rng):
    """(phi, sigma) float64 over theta, |sigma| in {0} u logspace(-8, 0)
    (both signs of sigma, a random axis per pair) and theta = pi - 1e-3,
    pi - 1e-5 at every sigma."""
    mags = np.concatenate([[0.0], np.logspace(-8, 0, 33)])
    thetas = np.concatenate([mags, [np.pi - 1e-3, np.pi - 1e-5]])
    th, sg = [a.ravel() for a in np.meshgrid(thetas, np.concatenate([mags, -mags[1:]]))]
    axis = rng.normal(size=(len(th), 3))
    return axis / np.linalg.norm(axis, axis=-1, keepdims=True) * th[:, None], sg


def test_sim3_W_float32_matches_reference_float64(rng):
    """The port's float32 W against the reference's W in float64 (round-off
    ~1e-10 there) on the same float32 inputs, over the whole theta, sigma
    grid, the reference's cancelling band 1e-6..1e-2 included: within 4e-7
    (measured 2.9e-7, at sigma = 1, theta = 3.2e-4; W entries up to e:
    ~2.5 float32 ulps) beyond the reference's own truncation below its
    switch. The reference's float32 W misses by 4.6e-2 on this grid (the
    port kept its formula before the series)."""
    phi, sigma = [x.astype(np.float32).astype(np.float64) for x in _W_grid(rng)]
    with jax.enable_x64(True):
        W64 = np.asarray(jax.jit(jsim3._sim3_W)(jnp.asarray(phi), jnp.asarray(sigma)))
    W32 = tsim3._sim3_W(_t(phi), _t(sigma)).numpy()
    # Below its switch the reference drops sigma from A and B: its float64
    # W is off by up to |sigma| there (|dW/dsigma| <= 1 at theta <= pi).
    ref_trunc = np.where(np.abs(sigma) < 1e-6, np.abs(sigma), 0.0)[:, None, None]
    assert (np.abs(W32 - W64) - ref_trunc).max() <= 4e-7
    # The grid reaches the reference's cancelling band.
    W32_ref = np.asarray(jax.jit(jsim3._sim3_W)(jnp.asarray(phi, jnp.float32),
                                                jnp.asarray(sigma, jnp.float32)))
    assert np.abs(W32_ref - W64).max() > 1e-2


def test_sim3_log_exp_round_trip_float32_small_steps(rng):
    """sim3_log(sim3_exp(xi)) in float32 for rho, phi, |sigma| each in
    1e-6..1e-2 (log-uniform, random directions and signs): rho back within
    1e-6 relative (measured 1.9e-7; 2.3e-2 with the reference's W), phi
    within 1e-6 relative, sigma within 1.2e-7 absolute (the float32 ulp of
    s = e^sigma near 1; measured 5.9e-8)."""
    n = 200
    mag = 10 ** rng.uniform(-6, -2, size=(n, 3))
    axes = rng.normal(size=(n, 2, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    xi = np.concatenate([axes[:, 0] * mag[:, :1], axes[:, 1] * mag[:, 1:2],
                         (rng.choice([-1.0, 1.0], size=n) * mag[:, 2])[:, None]], -1)
    xi = xi.astype(np.float32)
    back = tsim3.sim3_log(tsim3.sim3_exp(torch.from_numpy(xi))).numpy()
    for sl in (slice(0, 3), slice(3, 6)):
        rel = np.linalg.norm(back[:, sl] - xi[:, sl], axis=-1) / np.linalg.norm(xi[:, sl], axis=-1)
        assert rel.max() <= 1e-6
    assert np.abs(back[:, 6] - xi[:, 6]).max() <= 1.2e-7


def test_sim3_compose_inverse_apply_match_reference(rng):
    xi = _twists(rng, 32, 7, 0.5)
    A = jsim3.sim3_exp(jnp.asarray(xi))
    B = jsim3.sim3_exp(jnp.asarray(xi[::-1].copy()))
    tA, tB = [_t(x) for x in _np(A)], [_t(x) for x in _np(B)]
    X = rng.normal(size=(32, 3)).astype(np.float32)
    for a, b in zip(tsim3.sim3_compose(tA, tB), _np(jsim3.sim3_compose(A, B))):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
    for a, b in zip(tsim3.sim3_inverse(tA), _np(jsim3.sim3_inverse(A))):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tsim3.sim3_apply(tA, _t(X)).numpy(),
                               np.asarray(jsim3.sim3_apply(A, jnp.asarray(X))), **TOL)
    # Round trip: T T^-1 = identity; the identity's parts.
    R, t, s = tsim3.sim3_compose(tA, tsim3.sim3_inverse(tA))
    np.testing.assert_allclose(R.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)
    for a, b in zip(tsim3.sim3_identity(device="cpu"), _np(jsim3.sim3_identity())):
        np.testing.assert_array_equal(a.numpy(), b)


def _edges(rng, E, consistent):
    """Edge transforms (Ti, Tj, Tm) as numpy: random, or Tm = Ti^-1 Tj so
    the residual is 0 and so3_log / sim3_exp / sim3_log take their
    small-angle, small-sigma branches at the linearization point."""
    Ti = _np(jsim3.sim3_exp(jnp.asarray(_twists(rng, E, 7, 0.5))))
    Tj = _np(jsim3.sim3_exp(jnp.asarray(rng.normal(size=(E, 7)).astype(np.float32) * 0.5)))
    if consistent:
        Tm = _np(jsim3.sim3_compose(jsim3.sim3_inverse(Ti), Tj))
    else:
        Tm = _np(jsim3.sim3_exp(jnp.asarray(rng.normal(size=(E, 7)).astype(np.float32) * 0.5)))
    return Ti, Tj, Tm


@pytest.mark.parametrize("consistent", [True, False], ids=["zero_residual", "generic"])
def test_sim3_edge_jacobians_at_zero_match_jax_jacfwd(rng, consistent):
    """The Jacobians of the right-perturbed edge residual at eps = 0 against
    the reference's vmap(jacfwd); finite in both regimes (the unselected
    branches' tangents stay finite)."""
    E = 16
    Ti, Tj, Tm = _edges(rng, E, consistent)
    z = jnp.zeros((E, 7))
    j_J = [np.asarray(jax.vmap(jax.jacfwd(jgraph._edge_residual, argnums=k))(
        tuple(map(jnp.asarray, Ti)), tuple(map(jnp.asarray, Tj)), tuple(map(jnp.asarray, Tm)),
        z, z)) for k in (3, 4)]
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        r, Ji, Jj = tgraph.edge_jacobians(*[[_t(x) for x in T] for T in (Ti, Tj, Tm)])
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    if consistent:
        assert np.abs(r.numpy()).max() < 1e-5
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    np.testing.assert_allclose(Ji.numpy(), j_J[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), j_J[1], rtol=1e-4, atol=1e-4)
