"""The port's copy of the reference's random stream (`utils/prng.py`) and its
draw op (`ops/threefry_kernel.py`, the plain twin on the CPU) against JAX's
own: keys bitwise, bits bitwise, Gumbel noise within one ulp of each log,
categorical draws index for index at the RANSAC's shapes, and the engine's
keys (frame, sequence, a batch's slice) as the reference derives them.

The reference runs JAX's default threefry (`jax_threefry_partitionable`
True in jax 0.9, impl threefry2x32): a test asserts both in the reference's
process, so a change of JAX's default fails here instead of drifting.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import vislam_tpu
from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu_torch.engine import batch_keys, frame_key, sequence_key
from vislam_tpu_torch.frontend.features import extract_features
from vislam_tpu_torch.frontend.match import match_descriptors
from vislam_tpu_torch.ops import threefry_kernel
from vislam_tpu_torch.ops.threefry_kernel import threefry_gumbel
from vislam_tpu_torch.utils import prng
from vislam_tpu_torch.utils.config import FrontendConfig

torch.set_num_threads(2)
SEEDS = (0, 1, 7, 2 ** 31 - 1)
H, M = 512, 768


def _jkey(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _kt(key):
    return prng.key_tensor(key, "cpu")


def test_reference_runs_partitionable_threefry():
    """The reference's process runs jax 0.9's default stream, which the
    port copies, and the reference's code sets neither flag."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert str(jax.random.key_impl(jax.random.key(0))) == "threefry2x32"
    root = pathlib.Path(vislam_tpu.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "threefry_partitionable" not in text and "prng_impl" not in text, path


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax_bitwise(seed):
    """PRNGKey, fold_in (one key and a batch of keys) and split."""
    jk, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(k, np.asarray(jax.random.key_data(jk)))
    for d in (0, 1, 7, 10 ** 6, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, d), np.asarray(jax.random.fold_in(jk, d)))
    for n in (1, 2, 8):
        np.testing.assert_array_equal(prng.split(k, n), np.asarray(jax.random.split(jk, n)))
    jks = jax.random.split(jk, 3)
    np.testing.assert_array_equal(
        prng.fold_in(prng.split(k, 3), 5),
        np.stack([np.asarray(jax.random.fold_in(jks[i], 5)) for i in range(3)]))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), data=st.integers(0, 10 ** 6), n=st.integers(1, 6))
def test_fold_in_and_split_equal_jax_anywhere(seed, data, n):
    """fold_in at any index up to 10**6, split into any n: bitwise; and the
    tensor version of the folds (`derive_keys`) equals the host's."""
    jk, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    f = prng.fold_in(k, data)
    np.testing.assert_array_equal(f, np.asarray(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(prng.split(f, n),
                                  np.asarray(jax.random.split(jax.random.fold_in(jk, data), n)))
    t = prng.derive_keys(_kt(k), [data, n]).numpy().astype(np.uint32)
    np.testing.assert_array_equal(t, prng.fold_in(f, n))


def test_prng_key_range():
    """A seed outside 32 bits and a fold outside [0, 2^32) raise; a negative
    32-bit seed wraps as JAX's does."""
    np.testing.assert_array_equal(prng.prng_key(-1),
                                  np.asarray(jax.random.key_data(jax.random.PRNGKey(-1))))
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 32)
    with pytest.raises(ValueError):
        prng.fold_in(prng.prng_key(0), -1)


@pytest.mark.parametrize("shape", [(H, M), (2, 3, 5), (7,)], ids=["ransac", "small", "odd"])
def test_random_bits_equal_jax_bitwise(shape):
    key = prng.fold_in(prng.prng_key(3), 5)
    bits = prng.random_bits(_kt(key), shape).numpy()
    assert bits.shape == shape and bits.min() >= 0 and bits.max() < 2 ** 32
    np.testing.assert_array_equal(bits.astype(np.uint32),
                                  np.asarray(jax.random.bits(_jkey(3, 5), shape)))


def test_gumbel_within_one_ulp_of_jax():
    """The uniform bitwise; each of gumbel's two logs within 1 ulp of
    JAX's on the same argument (the port's are correctly rounded, JAX's
    XLA log is not always); the noise within 1e-6 of jax.random.gumbel,
    the share that is exact printed."""
    key, jk = prng.fold_in(prng.prng_key(3), 5), _jkey(3, 5)
    tiny = np.finfo(np.float32).tiny
    u = prng.uniform(_kt(key), (H, M), prng.TINY)
    ju = np.asarray(jax.random.uniform(jk, (H, M), minval=tiny))
    np.testing.assert_array_equal(u.numpy(), ju)
    # log_f32 is the float32 rounding of the exact log.
    np.testing.assert_array_equal(prng.log_f32(u).numpy(),
                                  np.log(ju.astype(np.float64)).astype(np.float32))
    inner = np.asarray(-jnp.log(ju))
    assert (np.abs(-prng.log_f32(u).numpy() - inner) <= np.spacing(inner)).all()
    outer = np.asarray(-jnp.log(inner))
    port_outer = -prng.log_f32(torch.from_numpy(inner.copy())).numpy()
    assert (np.abs(port_outer - outer) <= np.spacing(np.abs(outer))).all()
    jg = np.asarray(jax.random.gumbel(jk, (H, M)))
    np.testing.assert_array_equal(jg, outer)      # jax's gumbel is that composition
    g = prng.gumbel(_kt(key), (H, M)).numpy()
    exact = float((g == jg).mean())
    print(f"gumbel: {exact:.4f} of {g.size} values equal to jax.random.gumbel's, "
          f"max |diff| {np.abs(g - jg).max():.3e}")
    assert np.abs(g - jg).max() <= 1e-6


@pytest.fixture(scope="module")
def match_logits():
    """log(w + 1e-9) of a real match mask: the port's default frontend on
    frames 0 and 1 of a synthetic sequence (as the RANSAC's logits)."""
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=2, n_landmarks=300, seed=0))
    fe = FrontendConfig()
    a, b = (extract_features(torch.as_tensor(seq["images"][i], dtype=torch.float32), fe)
            for i in (0, 1))
    m = match_descriptors(a.desc, a.mask, b.desc, b.mask, ratio=fe.ratio_thresh,
                          mutual=fe.mutual_check)
    w = m.mask.float()
    assert 50 < int(w.sum()) < M
    return torch.log(w + 1e-9)


@pytest.mark.parametrize("shape", [(H,), (H, 8)], ids=["translation", "essential"])
def test_categorical_equals_jax(match_logits, shape):
    """jax.random.categorical's indices at the RANSAC's shapes; an index may
    differ only where JAX's two best scores are within 2 ulp."""
    for seed, folds in ((0, (3,)), (7, (11, 7)), (2 ** 31 - 1, (0,))):
        key = prng.prng_key(seed)
        for d in folds:
            key = prng.fold_in(key, d)
        jk = _jkey(seed, *folds)
        idx = prng.categorical(_kt(key), match_logits, shape).numpy()
        ref = np.asarray(jax.random.categorical(jk, jnp.asarray(match_logits.numpy()),
                                                shape=shape))
        assert idx.shape == ref.shape == shape
        differ = idx != ref
        if differ.any():
            scores = np.sort(np.asarray(jax.random.gumbel(jk, (*shape, M)))
                             + match_logits.numpy(), -1)[..., -2:]
            gap = scores[..., 1] - scores[..., 0]
            assert (gap[differ] <= 2 * np.spacing(np.abs(scores[..., 1][differ]))).all()


def test_draw_op_folds_and_vmap(monkeypatch):
    """The draw op's twin: field (p, j) is jax.random.gumbel under
    fold_in(fold_in(keys[p], index[p]), path j) (paths of any length, the
    index optional); under torch.func.vmap one call for the whole map,
    equal to the per-entry calls."""
    keys = prng.split(prng.prng_key(9), 2)
    index = torch.tensor([4, 0], dtype=torch.int32)
    paths = [(0,), (1,), (7, 0), (7, 1), ()]
    out = threefry_gumbel(_kt(keys), index, paths, (3, 5))
    assert out.shape == (2, 5, 3, 5) and out.dtype == torch.float32
    for p in range(2):
        for j, path in enumerate(paths):
            jk = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(9), 2)[p],
                                    int(index[p]))
            for d in path:
                jk = jax.random.fold_in(jk, d)
            np.testing.assert_allclose(out[p, j].numpy(),
                                       np.asarray(jax.random.gumbel(jk, (3, 5))), atol=1e-6)
    no_index = threefry_gumbel(_kt(keys), None, [()], (3, 5))
    torch.testing.assert_close(no_index[:, 0], prng.gumbel(_kt(keys), (3, 5)), rtol=0, atol=0)

    calls = [0]
    plain = threefry_kernel.threefry_gumbel_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(threefry_kernel, "threefry_gumbel_plain", counted)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        mapped = torch.func.vmap(
            lambda k, i: threefry_gumbel(k[None], i.reshape(1), paths[:4], (3, 5))[0],
            in_dims=(0, None))(_kt(keys), index[0])
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    assert calls[0] == 1
    one = [threefry_gumbel(_kt(keys[b:b + 1]), index[:1], paths[:4], (3, 5))[0]
           for b in range(2)]
    torch.testing.assert_close(mapped, torch.stack(one), rtol=0, atol=0)
    with pytest.raises(ValueError):
        threefry_gumbel(_kt(keys), None, [(-1,)], (3,))


def test_engine_keys_are_the_references():
    """frame_key: fold_in(PRNGKey(seed), n) (VIOEngine and its scan);
    sequence_key: split(PRNGKey(seed), B)[b] for any B > b (run_batch_scan);
    batch_keys with an offset: the rows a process_local rank of the
    reference's batch runner takes (`vislam_tpu/parallel/batch_runner.py`)."""
    for seed in SEEDS:
        for n in (0, 1, 59, 10 ** 6):
            np.testing.assert_array_equal(frame_key(seed, n), np.asarray(_jkey(seed, n)))
        for b in range(4):
            for B in (b + 1, 8):
                np.testing.assert_array_equal(
                    sequence_key(seed, b), np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                                                       B)[b]))
        lo, local = 4, 2
        np.testing.assert_array_equal(
            batch_keys(seed, local, lo),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), 8))[lo:lo + local])
