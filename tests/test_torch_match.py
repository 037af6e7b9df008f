"""vislam_tpu_torch against vislam_tpu: kernel 2's plain twin (distances +
row top-2 + column argmin) and match_descriptors, ungated and gated, at the
engine's shapes (K = 768 and 512, D = 128 SIFT; K = 768, D = 256 BRIEF).

Kernel 2 itself runs only on a CUDA card; chip_smoke.py holds it against
this plain twin there. Tolerances follow tests/test_ops.py: distances at
rtol 1e-4 (float32 dot products summed in another order), indices and
masks exact away from near-ties (rows whose best and second-best distance
differ by less than 1e-5 relative could legitimately swap). BRIEF distances
are exact multiples of 1/64, so there distances and indices are exact on
every row and column, the many exact ties included. A host model of the
kernel's tiled reduction (its tiles and random ones, merged in random
orders) is held against the twin and the Pallas kernel on tie-heavy,
ragged, masked and gated-out inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.frontend.match import match_descriptors as j_match
from vislam_tpu.frontend import binary_desc as jbin
from vislam_tpu.ops.match_kernel import match_top2_pallas
from vislam_tpu_torch.frontend import binary_desc as tbin
from vislam_tpu_torch.frontend.match import match_descriptors as t_match
from vislam_tpu_torch.ops import build
from vislam_tpu_torch.ops.fed_kernel import fed_evolve
from vislam_tpu_torch.ops.harris_kernel import response_nms
from vislam_tpu_torch.ops.match_kernel import match_top2, match_top2_plain

torch.set_num_threads(2)
GATE = 60.0


def _pair(K, N=None, seed=0):
    """Descriptor sets with true correspondences (B is a noisy permutation
    of A), invalid rows in both, and keypoint positions for the gate."""
    N = K if N is None else N
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, 128)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    perm = rng.permutation(K)[:N] if N <= K else rng.integers(0, K, N)
    b = a[perm] + 0.25 * rng.normal(size=(N, 128)).astype(np.float32) / np.sqrt(128)
    b = (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
    ma = rng.uniform(size=K) > 0.1
    mb = rng.uniform(size=N) > 0.1
    uv_a = rng.uniform([0, 0], [752, 480], (K, 2)).astype(np.float32)
    uv_b = (uv_a[perm] + rng.normal(scale=30.0, size=(N, 2))).astype(np.float32)
    return a, b, ma, mb, uv_a, uv_b


def _t(x):
    return torch.from_numpy(np.array(x))


def _untied(min1, min2):
    return np.abs(min2 - min1) > 1e-5 * np.maximum(min1, 1e-6)


@pytest.mark.parametrize("K", [768, 512])
@pytest.mark.parametrize("gated", [False, True])
def test_top2_twin_matches_pallas_interpret(K, gated):
    a, b, ma, mb, uv_a, uv_b = _pair(K, seed=K + gated)
    gate = dict(uv_pred=uv_a, uv_b=uv_b, gate_radius=GATE) if gated else {}
    p = match_top2_pallas(jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb),
                          interpret=True,
                          **{k: (jnp.asarray(v) if k != "gate_radius" else v)
                             for k, v in gate.items()})
    t = match_top2(_t(a), _t(ma), _t(b), _t(mb),
                   **{k: (_t(v) if k != "gate_radius" else v) for k, v in gate.items()})
    p_min1, p_min2, p_arg1, p_col = (np.asarray(x) for x in p)
    t_min1, t_min2, t_arg1, t_col = (x.numpy() for x in t)
    assert t_arg1.dtype == np.int32 and t_col.dtype == np.int32
    np.testing.assert_allclose(t_min1, p_min1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_min2, p_min2, rtol=1e-4, atol=1e-5)
    # Rows with no valid candidate (1e9 everywhere) tie trivially; both
    # sides then report column 0.
    has = p_min1 < 5e8
    ok = has & _untied(p_min1, p_min2)
    assert ok.sum() > 0.99 * has.sum()
    np.testing.assert_array_equal(t_arg1[ok], p_arg1[ok])
    np.testing.assert_array_equal(t_arg1[~has], 0)
    # Column argmin, away from near-tied columns.
    np.testing.assert_array_equal(t_col[mb], p_col[mb])


def test_top2_twin_rectangular_matches_numpy():
    """K != N (the kernel and twin take any N): numpy oracle."""
    a, b, ma, mb, uv_a, uv_b = _pair(300, N=200, seed=5)
    D = np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T, 0)
    D[~ma] = 1e9
    D[:, ~mb] = 1e9
    min1, min2, arg1, col = (x.numpy() for x in match_top2_plain(_t(a), _t(ma), _t(b), _t(mb)))
    np.testing.assert_allclose(min1, D.min(1), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(arg1[ma], D.argmin(1)[ma])
    D2 = D.copy()
    D2[np.arange(300), D.argmin(1)] = 1e9
    np.testing.assert_allclose(min2[ma], D2.min(1)[ma], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(col[mb], D.argmin(0)[mb])


def test_top2_tie_semantics():
    """First index wins; a tie at the minimum makes min2 == min1; rows with
    no valid pair give min1 = min2 = 1e9 and arg1 = 0."""
    a = np.zeros((3, 128), np.float32)
    a[:, 0] = 1.0
    b = np.zeros((4, 128), np.float32)
    b[[1, 3], 0] = 1.0
    b[[0, 2], 1] = 1.0
    ma = np.array([True, True, False])
    mb = np.ones(4, bool)
    min1, min2, arg1, col = (x.numpy() for x in match_top2_plain(_t(a), _t(ma), _t(b), _t(mb)))
    np.testing.assert_array_equal(arg1, [1, 1, 0])
    np.testing.assert_array_equal(min1[:2], [0.0, 0.0])
    np.testing.assert_array_equal(min2[:2], [0.0, 0.0])
    assert min1[2] == min2[2] == np.float32(1e9)
    np.testing.assert_array_equal(col, [0, 0, 0, 0])


@pytest.mark.parametrize("gated", [False, True])
def test_match_descriptors_matches_reference(gated):
    a, b, ma, mb, uv_a, uv_b = _pair(768, seed=11 + gated)
    gj = dict(uv_pred=jnp.asarray(uv_a), uv_b=jnp.asarray(uv_b), gate_radius=GATE) \
        if gated else {}
    gt = dict(uv_pred=_t(uv_a), uv_b=_t(uv_b), gate_radius=GATE) if gated else {}
    j = j_match(jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb),
                ratio=0.8, mutual=True, **gj)
    t = t_match(_t(a), _t(ma), _t(b), _t(mb), ratio=0.8, mutual=True, **gt)
    jm = np.asarray(j.mask)
    assert jm.sum() > 200
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.idx_b.numpy()[jm], np.asarray(j.idx_b)[jm])
    np.testing.assert_allclose(t.dist.numpy()[jm], np.asarray(j.dist)[jm], rtol=1e-4,
                               atol=1e-5)


def test_wrappers_run_the_plain_version_only_for_cpu_tensors():
    """The plain versions run because the tensor lies on the CPU, not as a
    fallback: a tensor on any other non-CUDA device raises."""
    img = torch.zeros((32, 32), device="meta")
    for det in ("shi_tomasi", "hessian", "_gradmag2"):
        with pytest.raises(ValueError, match="device"):
            response_nms(img, det)
    with pytest.raises(ValueError, match="device"):
        fed_evolve(img, torch.ones((), device="meta"), (0.1, 0.2))
    d = torch.zeros((8, 128), device="meta")
    m = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        match_top2(d, m, d, m)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the build raises (naming nvcc) and leaves nothing behind."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_BUILD", str(tmp_path / "_build"))
    for name in build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library_path(name)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(build.SOURCES)
    assert not (tmp_path / "_build").exists()


def _brief_pair(K=768, seed=0):
    """BRIEF-like descriptors (+-1/16 unit vectors) where B is A with a few
    bits flipped per row, plus duplicated rows: exact ties, many of them."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.uniform(size=(K, 256)) > 0.5, 1.0, -1.0).astype(np.float32) / 16
    a[K // 2:K // 2 + 40] = a[:40]                     # duplicate rows: column ties
    perm = rng.permutation(K)
    b = a[perm].copy()
    flips = rng.integers(0, 256, (K, 6))
    for i in range(K):
        b[i, flips[i]] *= -1.0
    b[10:30] = b[40:60]                                # duplicate columns: row ties
    ma = rng.uniform(size=K) > 0.1
    mb = rng.uniform(size=K) > 0.1
    uv_a = rng.uniform([0, 0], [752, 480], (K, 2)).astype(np.float32)
    uv_b = (uv_a[perm] + rng.normal(scale=30.0, size=(K, 2))).astype(np.float32)
    return a, b, ma, mb, uv_a, uv_b


@pytest.mark.parametrize("gated", [False, True])
def test_top2_twin_d256_exact_with_ties(gated):
    """D = 256 against the Pallas kernel in interpret mode: distances equal,
    and arg1 and colarg equal on every row and column, ties included (the
    first index wins on both sides)."""
    a, b, ma, mb, uv_a, uv_b = _brief_pair(seed=1 + gated)
    gate = dict(uv_pred=uv_a, uv_b=uv_b, gate_radius=GATE) if gated else {}
    p = match_top2_pallas(jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb),
                          interpret=True,
                          **{k: (jnp.asarray(v) if k != "gate_radius" else v)
                             for k, v in gate.items()})
    t = match_top2(_t(a), _t(ma), _t(b), _t(mb),
                   **{k: (_t(v) if k != "gate_radius" else v) for k, v in gate.items()})
    p_min1, p_min2, p_arg1, p_col = (np.asarray(x) for x in p)
    t_min1, t_min2, t_arg1, t_col = (x.numpy() for x in t)
    ties = (p_min1 == p_min2) & (p_min1 < 5e8)
    assert ties.sum() >= 8, ties.sum()
    np.testing.assert_array_equal(t_min1, p_min1)
    np.testing.assert_array_equal(t_min2, p_min2)
    np.testing.assert_array_equal(t_arg1, p_arg1)
    np.testing.assert_array_equal(t_col, p_col)
    # Distances are Hamming distances: multiples of 4/256 = 1/64.
    h = tbin.hamming_from_l2sq(t[0][ma & (p_min1 < 5e8)])
    np.testing.assert_array_equal(h.numpy() / 64.0, t_min1[ma & (p_min1 < 5e8)])
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(jbin.hamming_from_l2sq(jnp.asarray(p_min1[ma & (p_min1 < 5e8)]))))


# The tiled kernel's reduction (csrc/match_top2.cu) rests on two merges that
# are exact in any order over disjoint sets: a row's Top2 (min1, its first
# column, min2) and a column's 64-bit key (distance bits << 32 | row, whose
# minimum is the first row reaching the minimum distance). The host model
# below reduces a distance matrix over a given split into tiles: each
# tile's row Top2 from its single entries in a random order, the tiles'
# partials in a random order, and the column keys' minimum per tile, then
# across tiles. The kernel's tiles are BM x BN = 32 x 64.
BM, BN = 32, 64
_IDENT = (np.inf, np.inf, np.iinfo(np.int32).max)


def _merge(p, q):
    """The kernel's Top2 merge of two disjoint column sets, elementwise:
    the smaller (m1, first column) wins, m2 the smallest of the rest."""
    take_q = (q[0] < p[0]) | ((q[0] == p[0]) & (q[2] < p[2]))
    return (np.where(take_q, q[0], p[0]),
            np.where(take_q, np.minimum(p[0], q[1]), np.minimum(p[1], q[0])),
            np.where(take_q, q[2], p[2]))


def _edges(n, rng, step=None):
    """Tile edges over n items: every `step`, else up to 11 random cuts."""
    if step is not None:
        return np.r_[np.arange(0, n, step), n]
    cuts = rng.choice(np.arange(1, n), size=min(n - 1, 11), replace=False) if n > 1 else []
    return np.r_[0, np.sort(cuts), n].astype(int)


def _tiled_top2(d, row_edges, col_edges, rng):
    """(min1, min2, arg1, colarg) of the (K, N) float32 matrix d, reduced
    over the tiles the edges cut, in random orders."""
    K, N = d.shape
    tiles = []
    for c0, c1 in zip(col_edges[:-1], col_edges[1:]):
        part = tuple(np.full(K, v) for v in _IDENT)
        for j in c0 + rng.permutation(c1 - c0):
            part = _merge(part, (d[:, j], np.full(K, np.inf), np.full(K, j)))
        tiles.append(part)
    m = tuple(np.full(K, v) for v in _IDENT)
    for i in rng.permutation(len(tiles)):
        m = _merge(m, tiles[i])
    bits = (d.view(np.uint32) & np.uint32(0x7fffffff)).astype(np.uint64)
    key = (bits << np.uint64(32)) | np.arange(K, dtype=np.uint64)[:, None]
    colkey = np.full(N, np.iinfo(np.uint64).max, np.uint64)
    for i in rng.permutation(len(row_edges) - 1):
        colkey = np.minimum(colkey, key[row_edges[i]:row_edges[i + 1]].min(axis=0))
    return (m[0].astype(np.float32), np.minimum(m[1], np.float32(1e9)).astype(np.float32),
            m[2].astype(np.int32), (colkey & np.uint64(0xffffffff)).astype(np.int32))


def _tile_case(case):
    """Inputs of one tiled-reduction case: BRIEF-like (exact, tie-heavy)
    or SIFT-like descriptors, cut to K x N, with masked or gated-out rows."""
    if case.startswith("sift"):
        a, b, ma, mb, uv_a, uv_b = _pair(512, seed=3)
        return a, b, ma, mb, dict(uv_pred=uv_a, uv_b=uv_b, gate_radius=GATE)
    a, b, ma, mb, uv_a, uv_b = _brief_pair(seed=4)
    gate = {}
    if case == "brief_gated":
        gate = dict(uv_pred=uv_a, uv_b=uv_b, gate_radius=GATE)
    elif case.startswith("brief_ragged"):
        K, N = (int(x) for x in case.split("_")[2:])
        a, ma, uv_a, b, mb, uv_b = a[:K], ma[:K], uv_a[:K], b[:N], mb[:N], uv_b[:N]
    elif case == "brief_masked":                 # every 5th row, 7th column invalid
        ma = ma & (np.arange(768) % 5 != 0)
        mb = mb & (np.arange(768) % 7 != 0)
    elif case == "brief_no_valid_row":
        ma = np.zeros_like(ma)
    elif case == "brief_gated_out":              # every 3rd disc holds no candidate
        far = uv_a + 1000.0 * (np.arange(768) % 3 == 0)[:, None].astype(np.float32)
        gate = dict(uv_pred=far.astype(np.float32), uv_b=uv_b, gate_radius=GATE)
    return a, b, ma, mb, gate


@pytest.mark.parametrize("case", ["brief", "brief_gated", "brief_ragged_700_700",
                                  "brief_ragged_700_333", "brief_ragged_1_768",
                                  "brief_ragged_33_65", "brief_ragged_768_1", "brief_masked",
                                  "brief_no_valid_row", "brief_gated_out", "sift_gated"])
def test_tiled_reduction_matches_twin_and_pallas(case):
    """The kernel's tiled reduction (the host model above) on the distances
    of the plain twin, over the kernel's 32 x 64 tiles and over a random
    split, each in random merge orders: identical to the twin's outputs,
    and to the Pallas kernel's in interpret mode where that takes the shape
    (K = N): exactly on BRIEF, within the tests' tolerance on SIFT."""
    a, b, ma, mb, gate = _tile_case(case)
    ta, tb = _t(a), _t(b)
    d = torch.clamp((ta * ta).sum(-1, keepdim=True) + (tb * tb).sum(-1)[None]
                    - 2.0 * (ta @ tb.T), min=0.0)
    d = torch.where(_t(ma)[:, None] & _t(mb)[None], d, torch.full_like(d, 1e9))
    if gate:
        du = _t(gate["uv_pred"])[:, None, 0] - _t(gate["uv_b"])[None, :, 0]
        dv = _t(gate["uv_pred"])[:, None, 1] - _t(gate["uv_b"])[None, :, 1]
        d = torch.where(du * du + dv * dv <= GATE * GATE, d, torch.full_like(d, 1e9))
    twin = [x.numpy() for x in match_top2_plain(
        ta, _t(ma), tb, _t(mb), **{k: (_t(v) if k != "gate_radius" else v)
                                   for k, v in gate.items()})]
    K, N = d.shape
    rng = np.random.default_rng(len(case))
    for steps in ((BM, BN), (None, None)):
        tiled = _tiled_top2(d.numpy(), _edges(K, rng, steps[0]), _edges(N, rng, steps[1]), rng)
        for x, y in zip(tiled, twin):
            np.testing.assert_array_equal(x, y)
    if case in ("brief", "brief_gated"):
        ties = (twin[0] == twin[1]) & (twin[0] < 5e8)
        assert ties.sum() >= 8, ties.sum()
    if case == "brief_no_valid_row":
        np.testing.assert_array_equal(tiled[2], 0)
        np.testing.assert_array_equal(tiled[3], 0)
    if a.shape[0] != b.shape[0]:
        return
    p = [np.asarray(x) for x in match_top2_pallas(
        jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb), interpret=True,
        **{k: (jnp.asarray(v) if k != "gate_radius" else v) for k, v in gate.items()})]
    if case.startswith("brief"):
        for x, y in zip(tiled, p):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_allclose(tiled[0], p[0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tiled[1], p[1], rtol=1e-4, atol=1e-5)
        ok = (p[0] < 5e8) & _untied(p[0], p[1])
        assert ok.sum() > 100
        np.testing.assert_array_equal(tiled[2][ok], p[2][ok])
        np.testing.assert_array_equal(tiled[3][mb], p[3][mb])


def test_match_descriptors_d256_matches_reference():
    """Ratio + mutual check on BRIEF-like descriptors: the same mask and
    indices as the reference, ties and all."""
    a, b, ma, mb, _, _ = _brief_pair(seed=7)
    j = j_match(jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb),
                ratio=0.8, mutual=True)
    t = t_match(_t(a), _t(ma), _t(b), _t(mb), ratio=0.8, mutual=True)
    jm = np.asarray(j.mask)
    assert jm.sum() > 300
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.idx_b.numpy(), np.asarray(j.idx_b))
    np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))


def _window_bank(W, K, N, seed=0):
    """An anchor set A (K, 128) and a window bank of W sets (W, N, 128), each
    a noisy permutation of A (as _pair makes B), in bfloat16 as the window
    keeps them, with invalid rows; slot 1 wholly invalid (a slot not yet
    filled)."""
    rng = np.random.default_rng(seed)
    a, _, ma, _, _, _ = _pair(K, seed=seed)
    bank, masks = [], []
    for w in range(W):
        b = a[rng.permutation(K)[:N]] + 0.25 * rng.normal(size=(N, 128)) / np.sqrt(128)
        bank.append(b / np.linalg.norm(b, axis=-1, keepdims=True))
        masks.append((rng.uniform(size=N) > 0.1) & (w != 1))
    return (jnp.asarray(a, jnp.bfloat16), ma,
            jnp.asarray(np.stack(bank).astype(np.float32), jnp.bfloat16), np.stack(masks))


def _widened(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("W,K,N", [(10, 768, 768), (3, 700, 333)])
def test_batched_window_match_matches_vmapped_reference(W, K, N):
    """The window-track match of engine/refine.py: the anchor A, shared,
    against W window sets in one batched call, on the bfloat16 bank the
    reference vmaps match_descriptors over (f32 accumulation of bf16
    products; the port widens the bank to float32, which is exact). idx_b
    and mask exact on every row away from near-ties, the all-invalid slot
    matching nothing; the batched twin equals W single-pair calls."""
    import jax

    a16, ma, bank16, masks = _window_bank(W, K, N)
    ref = jax.vmap(lambda d, m: j_match(a16, jnp.asarray(ma), d, m, ratio=0.8, mutual=True))(
        bank16, jnp.asarray(masks))
    a, bank = _widened(a16), _widened(bank16)
    got = t_match(a, _t(ma), bank, _t(masks), ratio=0.8, mutual=True)
    assert got.idx_b.shape == (W, K) and got.mask.shape == (W, K)
    min1, min2, arg1, col = match_top2_plain(a, _t(ma), bank, _t(masks))
    # Rows with no candidate hold 1e9 throughout: exact on both sides.
    untied = _untied(min1.numpy(), min2.numpy()) | (min1.numpy() >= 5e8)
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(got.mask.numpy()[untied], np.asarray(ref.mask)[untied])
    sel = untied & got.mask.numpy()
    np.testing.assert_array_equal(got.idx_b.numpy()[sel], np.asarray(ref.idx_b)[sel])
    assert not got.mask[1].any() and got.mask.sum() > 0.5 * (W - 1) * min(K, N)
    for w in range(W):
        one = match_top2_plain(a, _t(ma), bank[w], _t(masks[w]))
        for x, y in zip((min1[w], min2[w]), one[:2]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(arg1[w][_t(untied[w])], one[2][_t(untied[w])])


def test_batched_twin_with_ties_equals_single_calls():
    """The shared A against Bt sets equals Bt single-pair calls on BRIEF-like
    descriptors, whose distances are exact and tie often: equal on every
    row and column, ties included."""
    rng = np.random.default_rng(4)
    Bt, K, N = 3, 96, 80
    a = (rng.integers(0, 2, (K, 256)) * 2 - 1).astype(np.float32) / 16
    b = (rng.integers(0, 2, (Bt, N, 256)) * 2 - 1).astype(np.float32) / 16
    ma, mb = rng.uniform(size=K) > 0.2, rng.uniform(size=(Bt, N)) > 0.2
    batched = match_top2_plain(_t(a), _t(ma), _t(b), _t(mb))
    for i in range(Bt):
        one = match_top2_plain(_t(a), _t(ma), _t(b[i]), _t(mb[i]))
        for x, y in zip(batched, one):
            assert torch.equal(x[i], y)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("a_group", ["1", "W", "Bt"])
def test_twin_a_group_matches_pallas_per_pair(a_group, gated):
    """The plain twin's grouped modes on Bt = 6 sets B: a_group = 1 (an A per
    pair: the per-frame match and the gated rescue of a batch of
    sequences), W = 3 (two groups of A: the window match of a batch) and
    Bt (one shared A: one sequence's window match), ungated and with the
    gate batched (uv_pred per group of A, uv_b per set). Every entry z
    equals the reference's Pallas kernel (interpret mode) on the single
    pair (A of group z // a_group, B z), exactly: BRIEF-like descriptors
    (distances multiples of 1/64, ties included)."""
    Bt, K = 6, 128
    groups = {"1": Bt, "W": 2, "Bt": 1}[a_group]
    size = Bt // groups
    rng = np.random.default_rng(groups + 10 * gated)
    pairs = [_brief_pair(K, seed=int(s)) for s in rng.integers(0, 1000, Bt)]
    a = np.stack([pairs[g * size][0] for g in range(groups)])
    ma = np.stack([pairs[g * size][2] for g in range(groups)])
    uva = np.stack([pairs[g * size][4] for g in range(groups)])
    b, mb, uvb = (np.stack([p[i] for p in pairs]) for i in (1, 3, 5))
    gate = dict(uv_pred=_t(uva), uv_b=_t(uvb), gate_radius=GATE) if gated else {}
    if a_group == "Bt":       # the shared form: A (K, D) without the group axis
        got = match_top2_plain(_t(a[0]), _t(ma[0]), _t(b), _t(mb),
                               **({**gate, "uv_pred": _t(uva[0])} if gated else {}))
    else:
        got = match_top2_plain(_t(a), _t(ma), _t(b), _t(mb), **gate)
    assert got[0].shape == (Bt, K) and got[3].shape == (Bt, K)
    for z in range(Bt):
        g = z // size
        pg = dict(uv_pred=jnp.asarray(uva[g]), uv_b=jnp.asarray(uvb[z]),
                  gate_radius=GATE) if gated else {}
        p = match_top2_pallas(jnp.asarray(a[g]), jnp.asarray(ma[g]), jnp.asarray(b[z]),
                              jnp.asarray(mb[z]), interpret=True, **pg)
        for x, y in zip(got, p):
            np.testing.assert_array_equal(x[z].numpy(), np.asarray(y))
    if gated:   # the gate left some rows without a candidate
        ungated = match_top2_plain(_t(a), _t(ma), _t(b), _t(mb))
        assert (got[0] >= 5e8).sum() > (ungated[0] >= 5e8).sum()
