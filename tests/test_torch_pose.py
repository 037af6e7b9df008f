"""vislam_tpu_torch against vislam_tpu: two-view geometry (epipolar
normals, translation RANSAC fed the reference's own random draws, the
direction sign, disparity), midpoint triangulation, the closed-form 3x3
eigenvector and the nanmedian trap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu import lie as jlie
from vislam_tpu.backend.triangulate import triangulate_midpoint as j_tri
from vislam_tpu.frontend import pose as jpose
from vislam_tpu_torch.backend.triangulate import triangulate_midpoint as t_tri
from vislam_tpu_torch.engine.engine import nanmedian
from vislam_tpu_torch.frontend import pose as tpose
from vislam_tpu_torch.utils import prng

torch.set_num_threads(2)
H = 512
FX = FY = 400.0
CX, CY = 376.0, 240.0


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scene(seed, M=768, outliers=0.2, noise_px=0.5, baseline=0.2):
    """Matched unit rays of a static scene seen from two poses, with pixel
    noise, outliers and invalid rows; also the frame-i pixels."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(3, 10, M)], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.05, size=3), jnp.float32)))
    t = rng.normal(size=3)
    t = baseline * t / np.linalg.norm(t)
    Xj = X @ R.T + t

    def pix(P):
        return np.stack([FX * P[:, 0] / P[:, 2] + CX, FY * P[:, 1] / P[:, 2] + CY], -1)

    uv_i = pix(X) + rng.normal(scale=noise_px, size=(M, 2))
    uv_j = pix(Xj) + rng.normal(scale=noise_px, size=(M, 2))
    bad = rng.uniform(size=M) < outliers
    uv_j[bad] = rng.uniform([0, 0], [752, 480], (bad.sum(), 2))

    def rays(uv):
        r = np.concatenate([(uv - [CX, CY]) / [FX, FY], np.ones((M, 1))], -1)
        return (r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(np.float32)

    mask = rng.uniform(size=M) > 0.15
    return rays(uv_i), rays(uv_j), R.astype(np.float32), mask, uv_i.astype(np.float32), t


def _jax_noise(key, M):
    """The reference's Gumbel draws for ransac_translation(key): it splits
    the key and samples categorical(ka / kb, logits, shape=(H,)), i.e.
    argmax(logits + gumbel(k, (H, M)))."""
    ka, kb = jax.random.split(key)
    return np.stack([np.asarray(jax.random.gumbel(ka, (H, M))),
                     np.asarray(jax.random.gumbel(kb, (H, M)))])


def test_gumbel_noise_reproduces_jax_categorical():
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    logits = np.log(np.random.default_rng(1).uniform(size=768).astype(np.float32) + 1e-9)
    noise = _jax_noise(key, 768)
    ka, kb = jax.random.split(key)
    for k, nz in ((ka, noise[0]), (kb, noise[1])):
        ref = np.asarray(jax.random.categorical(k, jnp.asarray(logits), shape=(H,)))
        np.testing.assert_array_equal(np.argmax(logits + nz, -1), ref)


def test_port_gumbel_draws_are_seeded_and_standard():
    """The port's draws under a key are a function of the key alone, are
    the reference's (ka, kb = split(key)) to JAX's last-ulp log
    differences, and are standard Gumbel."""
    key = prng.key_tensor(prng.fold_in(prng.prng_key(5), 3), "cpu")
    a = tpose.gumbel_noise(key, H, 768)
    b = tpose.gumbel_noise(key.clone(), H, 768)
    assert a.shape == (2, H, 768) and torch.equal(a, b)
    ref = _jax_noise(jax.random.fold_in(jax.random.PRNGKey(5), 3), 768)
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-6)
    # Standard Gumbel: mean = Euler-Mascheroni constant, variance pi^2/6.
    assert abs(a.mean().item() - 0.5772) < 0.01
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.02


def test_epipolar_normals_match_reference():
    ri, rj, R, mask, uv_i, _ = _scene(0)
    tn, tnorm = tpose.epipolar_normals(_t(ri), _t(rj), _t(R))
    jn, jnorm = jpose.epipolar_normals(jnp.asarray(ri), jnp.asarray(rj), jnp.asarray(R))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ransac_with_reference_draws_matches(seed):
    """Fed the reference's Gumbel noise, the port scores the same hypotheses:
    same winner, t_dir to ~1e-4 (the 3x3 eigenvector is closed-form float64
    here, float32 eigh there), inlier counts equal up to normals whose
    residual sits within 1e-4 of the threshold."""
    ri, rj, R, mask, uv_i, t_true = _scene(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    j = jpose.ransac_translation(jnp.asarray(ri), jnp.asarray(rj), jnp.asarray(R),
                                 jnp.asarray(mask), key, num_hyps=H, thresh=0.02,
                                 uv_i=jnp.asarray(uv_i), dispersion_pow=1.25)
    t = tpose.ransac_translation(_t(ri), _t(rj), _t(R), torch.from_numpy(mask),
                                 num_hyps=H, thresh=0.02, uv_i=_t(uv_i),
                                 dispersion_pow=1.25, noise=_t(_jax_noise(key, len(ri))))
    np.testing.assert_allclose(t.t_dir.numpy(), np.asarray(j.t_dir), atol=1e-4)
    n, _ = jpose.epipolar_normals(jnp.asarray(ri), jnp.asarray(rj), jnp.asarray(R))
    near = np.abs(np.abs(np.asarray(n) @ np.asarray(j.t_dir)) - 0.02) < 1e-4
    diff = t.inlier_mask.numpy() != np.asarray(j.inlier_mask)
    assert not (diff & ~near).any()
    assert abs(int(t.num_inliers) - int(j.num_inliers)) <= int(near.sum())
    # And the solve is right: t_dir is the true direction (up to sign).
    assert abs(np.dot(t.t_dir.numpy(), t_true / np.linalg.norm(t_true))) > 0.99


def test_resolve_sign_disparity_triangulation_match_reference():
    ri, rj, R, mask, uv_i, t_true = _scene(4, outliers=0.0)
    tdir = (t_true / np.linalg.norm(t_true)).astype(np.float32)
    inl = mask
    for s in (1.0, -1.0):
        a = tpose.resolve_direction_sign(_t(ri), _t(rj), _t(R), _t(s * tdir),
                                         torch.from_numpy(inl))
        b = jpose.resolve_direction_sign(jnp.asarray(ri), jnp.asarray(rj), jnp.asarray(R),
                                         jnp.asarray(s * tdir), jnp.asarray(inl))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(a.numpy(), tdir, atol=1e-7)
    uv_j = np.random.default_rng(0).uniform(0, 700, (768, 2)).astype(np.float32)
    d_t = tpose.rotation_compensated_disparity(_t(uv_i), _t(uv_j), torch.from_numpy(mask),
                                               _t(R), FX, FY, CX, CY)
    d_j = jpose.rotation_compensated_disparity(jnp.asarray(uv_i), jnp.asarray(uv_j),
                                               jnp.asarray(mask), jnp.asarray(R),
                                               FX, FY, CX, CY)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    # Triangulation solves a 2x2 system whose determinant is the squared
    # sine of the ray angle: float32 round-off in the ray rotation is
    # amplified by 1/det. The reference, as XLA's CPU compiler builds it on
    # a host with FMA, fuses multiply-adds (det = fma(a, c, -(b b)), each
    # 3-term dot an FMA chain); the port rounds each product, as the
    # reference's own compile without FMA does. So where det < 1e-3 the
    # depths differ between the reference's two compiles and the port
    # alike. Held at rtol 1e-4 where the rays subtend more than ~2 degrees
    # (det > 1e-3), the regime the depth chain keeps.
    ri, rj, R, mask, uv_i, t_true = _scene(5, outliers=0.0, baseline=2.0)
    rot = ri.astype(np.float64) @ R.T.astype(np.float64)
    det = 1.0 - np.sum(rot * rj, -1) ** 2
    ok = det > 1e-3
    assert ok.mean() > 0.5
    tt = _t(t_true)
    for a, b in zip(t_tri(_t(ri), _t(rj), _t(R), tt),
                    j_tri(jnp.asarray(ri), jnp.asarray(rj), jnp.asarray(R),
                          jnp.asarray(t_true, jnp.float32))):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-4, atol=1e-4)


def test_smallest_eigvec_closed_form(rng):
    for _ in range(50):
        n = rng.normal(size=(40, 3))
        n[:, 2] *= rng.uniform(1e-3, 1.0)     # one small eigenvalue
        S = (n.T @ n).astype(np.float32)
        v = tpose.smallest_eigvec_sym3(torch.from_numpy(S)).numpy()
        w, V = np.linalg.eigh(S.astype(np.float64))
        assert abs(abs(np.dot(v, V[:, 0])) - 1.0) < 1e-5
    # Degenerate input: a multiple of the identity still yields a unit vector.
    v = tpose.smallest_eigvec_sym3(1e-9 * torch.eye(3))
    assert torch.isclose(torch.linalg.vector_norm(v), torch.tensor(1.0))


def test_nanmedian_averages_middle_pair_like_jnp(rng):
    """Trap: torch.nanmedian takes the lower middle value, jnp.nanmedian
    (the reference, engine.py:491) the mean of the middle pair."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert torch.nanmedian(x).item() == 2.0
    assert nanmedian(x).item() == 2.5
    assert np.isnan(nanmedian(torch.full((5,), float("nan"))).item())
    for n_valid in (0, 1, 2, 7, 12, 13, 100):
        v = rng.uniform(0.1, 3.0, 128).astype(np.float32)
        v[n_valid:] = np.nan
        rng.shuffle(v)
        want = np.asarray(jnp.nanmedian(jnp.asarray(v)))
        got = nanmedian(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)
