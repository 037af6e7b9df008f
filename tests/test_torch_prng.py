"""The port's copy of the reference's random stream (`utils/prng.py`) and its
draw ops (`ops/threefry_kernel.py`, the plain twins on the CPU) against
JAX's own: keys bitwise, bits bitwise, Gumbel noise within one ulp of each
log, categorical draws index for index at the RANSAC's shapes (the
categorical op too), and the engine's keys (frame, sequence, a batch's
slice) as the reference derives them; the port's float32 log against its
earlier float64 series and the card kernel's copy of its table.

The reference runs JAX's default threefry (`jax_threefry_partitionable`
True in jax 0.9, impl threefry2x32): a test asserts both in the reference's
process, so a change of JAX's default fails here instead of drifting.
"""

import math
import pathlib
import re

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
from vislam_tpu_torch.ops.threefry_kernel import (FrameKey, draw_categorical,
                                                  threefry_categorical, threefry_gumbel)
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


def _series_log_f32(x):
    """The port's float32 log before the table's (kept here as the
    oracle): log(x) = e ln2 + 2 atanh(s), s = (m - 1) / (m + 1), m in
    [sqrt(1/2), sqrt(2)), 9 terms of the series in float64, rounded to
    float32."""
    m, e = torch.frexp(x.double())
    low = m < math.sqrt(0.5)
    m.mul_(low + 1.0)
    e = e - low.to(e.dtype)
    s = (m - 1.0).div_(m.add_(1.0))
    s2 = s * s
    terms = [1.0 / (2 * k + 1) for k in range(9)]
    p = torch.full_like(s, terms[-1])
    for c in terms[-2::-1]:
        p.mul_(s2).add_(c)
    return e.double().mul_(math.log(2.0)).add_(s.mul_(2.0).mul_(p)).float()


def test_log_f32_equals_the_series_and_rounds_correctly():
    """The table log (no division) against the float64 series it replaced,
    on 10^6 float32 values spanning [2^-126, 1) (the uniforms) and (0, 88]
    (the inner logs, log-spaced down to the smallest subnormal) plus the
    edges and 20000 values on each side of 1 and of 2: the same float32
    everywhere, both the float32 rounding of numpy's float64 log (so
    within half an ulp of the exact log). numpy's own float32 log is no
    oracle: its vector kernel is up to 4 ulp off on AVX-512 hosts."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    edges = np.array([2.0 ** -126, 1 - 2.0 ** -24, 1 - 2.0 ** -23, 1, 1 + 2.0 ** -23, 88,
                      np.finfo(f32).smallest_subnormal, 87.336544, 2, 0.5, math.sqrt(0.5),
                      math.sqrt(2), np.finfo(f32).max], f32)
    steps = np.arange(1, 20001, dtype=f32)
    x = np.concatenate([
        np.maximum(rng.uniform(0, 1, 500_000).astype(f32), f32(2.0 ** -126)),
        np.exp(rng.uniform(np.log(1.4e-45), np.log(88.0), 500_000)).astype(f32),
        edges, f32(1) - steps * f32(2.0 ** -24), f32(1) + steps * f32(2.0 ** -23),
        f32(2) - steps * f32(2.0 ** -23), f32(2) + steps * f32(2.0 ** -22)])
    x = x[x > 0]
    t = torch.from_numpy(x)
    new, old = prng.log_f32(t), _series_log_f32(t)
    exact = np.log(x.astype(np.float64)).astype(f32)
    assert int((new != old).sum()) == 0
    np.testing.assert_array_equal(new.numpy(), exact)
    np.testing.assert_array_equal(old.numpy(), exact)


def test_kernel_log_table_is_the_twins():
    """The card kernel's log (`ops/csrc/threefry_gumbel.cu`) holds the
    twin's table of 1/c_j and log(c_j) and its log1p coefficients, in
    order, to the bit."""
    src = (pathlib.Path(threefry_kernel.__file__).parent / "csrc" /
           "threefry_gumbel.cu").read_text()
    hexfloat = r"-?0x[0-9a-f.]+p[-+]\d+"
    table = re.search(r"kLogCentre\[kLogTable \+ 1\] = \{(.*?)\n\};", src, re.S).group(1)
    pairs = [float.fromhex(v) for v in re.findall(hexfloat, table)]
    assert pairs[1::2] == list(prng.LOG_CENTRES) and len(pairs) == 2 * (prng.LOG_TABLE_SIZE + 1)
    assert pairs[0::2] == list(prng.INV_CENTRES)
    body = re.search(r"void log_f32_n\(const float \(&x\)\[N\].*?\{(.*?)\n\}", src,
                     re.S).group(1)
    series = "".join(line for line in body.splitlines() if "q[k] = " in line)
    coefs = [float.fromhex(v) for v in re.findall(hexfloat, series)]
    assert coefs == list(prng.LOG1P_TERMS)
    ln2 = re.search(r"kLn2 = (0x[0-9a-f.]+p[-+]\d+);", src).group(1)
    assert float.fromhex(ln2) == prng.LN2
    assert prng.LOG_CENTRES[0] == 0.0 and prng.LOG_CENTRES[256] == prng.LN2
    for j in (1, 100, 255):
        assert abs(prng.LOG_CENTRES[j] - math.log1p(j / 256)) <= 2 ** -52 * math.log1p(j / 256)


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
    differ only where JAX's two best scores are within 2 ulp. The
    categorical op (the twin of the draw kernel, folding the key itself)
    gives prng.categorical's indices, the step's earlier draw (the Gumbel
    field plus the logits, then its argmax), index for index."""
    for seed, folds in ((0, (3,)), (7, (11, 7)), (2 ** 31 - 1, (0,))):
        key = prng.prng_key(seed)
        for d in folds:
            key = prng.fold_in(key, d)
        jk = _jkey(seed, *folds)
        idx = prng.categorical(_kt(key), match_logits, shape).numpy()
        base = _kt(prng.prng_key(seed))
        op = draw_categorical(FrameKey(base, None, folds[:-1]), [folds[-1:]], match_logits,
                              shape)[0]
        np.testing.assert_array_equal(op.numpy(), idx)
        ref = np.asarray(jax.random.categorical(jk, jnp.asarray(match_logits.numpy()),
                                                shape=shape))
        assert idx.shape == ref.shape == shape
        differ = idx != ref
        if differ.any():
            scores = np.sort(np.asarray(jax.random.gumbel(jk, (*shape, M)))
                             + match_logits.numpy(), -1)[..., -2:]
            gap = scores[..., 1] - scores[..., 0]
            assert (gap[differ] <= 2 * np.spacing(np.abs(scores[..., 1][differ]))).all()


@pytest.mark.parametrize("logits", ["batched", "shared"])
def test_categorical_op_folds_and_vmap(monkeypatch, logits):
    """The categorical op's twin: entry (p, j) is jax.random.categorical
    under fold_in(fold_in(keys[p], index[p]), path j) over logits[p] (or
    one shared row; paths of any length); under torch.func.vmap over keys,
    with the logits mapped as well or shared, one call for the whole map,
    equal to the per-entry calls."""
    keys = prng.split(prng.prng_key(9), 3)
    index = torch.tensor([4, 0, 2], dtype=torch.int32)
    paths = [(0,), (1,), (7, 0), ()]
    g = torch.Generator().manual_seed(1)
    lg = torch.log((torch.rand(3, 40, generator=g) < 0.5).float() + 1e-9)
    if logits == "shared":
        lg = lg[:1]
    out = threefry_categorical(_kt(keys), index, paths, lg, (6,))
    assert out.shape == (3, 4, 6) and out.dtype == torch.int64
    for p in range(3):
        for j, path in enumerate(paths):
            jk = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(9), 3)[p],
                                    int(index[p]))
            for d in path:
                jk = jax.random.fold_in(jk, d)
            ref = jax.random.categorical(jk, jnp.asarray(lg[p % lg.shape[0]].numpy()),
                                         shape=(6,))
            np.testing.assert_array_equal(out[p, j].numpy(), np.asarray(ref))

    calls = [0]
    plain = threefry_kernel.threefry_categorical_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(threefry_kernel, "threefry_categorical_plain", counted)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        if logits == "shared":
            mapped = torch.func.vmap(lambda k: draw_categorical(
                FrameKey(k, index[0], (7,)), [(0,), (1,)], lg[0], (6,)))(_kt(keys))
        else:
            mapped = torch.func.vmap(lambda k, row: draw_categorical(
                FrameKey(k, index[0], (7,)), [(0,), (1,)], row, (6,)))(_kt(keys), lg)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    assert calls[0] == 1 and mapped.shape == (3, 2, 6)
    one = [draw_categorical(FrameKey(_kt(keys[b]), index[0], (7,)), [(0,), (1,)],
                            lg[b % lg.shape[0]], (6,)) for b in range(3)]
    torch.testing.assert_close(mapped, torch.stack(one), rtol=0, atol=0)
    with pytest.raises(ValueError):
        threefry_categorical(_kt(keys), index, [(-1,)], lg, (6,))
    with pytest.raises(ValueError):
        threefry_categorical(_kt(keys), index[:2], paths, lg, (6,))


def test_draw_op_folds_and_vmap():
    """The field function (plain PyTorch, the noise fed to a step): field
    (p, j) is jax.random.gumbel under fold_in(fold_in(keys[p], index[p]),
    path j) (paths of any length, the index optional); under
    torch.func.vmap with the per-example fallback off, equal to the
    per-entry calls."""
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

    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        mapped = torch.func.vmap(
            lambda k, i: threefry_gumbel(k[None], i.reshape(1), paths[:4], (3, 5))[0],
            in_dims=(0, None))(_kt(keys), index[0])
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
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
