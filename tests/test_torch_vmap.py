"""The vmap rules of the three kernels' custom ops (`ops/*_kernel.py`): under
torch.func.vmap each op folds the mapped dimension into the kernel's own
batch and makes ONE call, whose result equals the per-entry calls stacked.
On the CPU the op's implementation is the plain twin, so these tests hold
the rules themselves; `chip_smoke.py` holds the folded kernels against
their twins on the card. Each in_dims combination the engine produces
under `run_batch_scan` is covered (and a few it does not, which the rule
takes all the same). vmap's per-example fallback is disabled throughout.

Tolerances: the match on BRIEF-like descriptors (distances exact multiples
of 1/64) is exact against the per-entry calls; the response and FED are
exact against the op on the stacked batch, and within float32 round-off
of the per-image calls (a batched float32 convolution on the CPU may sum
in another order than a single one). For FED that round-off is held at
4e-4 (was 1e-4): the batched and per-field twins part by 1.37e-4 on some
hosts (an AVX-512 one; 4 steps on fields of 0-255), and one field's twin
moves by up to 2.06e-4 under a 1-ulp change of its input (16 random sign
patterns), so 4e-4 is that spread times about 2.
"""

import numpy as np
import pytest
import torch

from vislam_tpu_torch.ops import fed_kernel, harris_kernel, match_kernel
from vislam_tpu_torch.ops.fed_kernel import fed_evolve
from vislam_tpu_torch.ops.harris_kernel import FAMILIES, response_nms
from vislam_tpu_torch.ops.match_kernel import match_top2

torch.set_num_threads(2)
GATE = 20.0


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def _calls(monkeypatch, mod, name):
    """Count the calls of mod.<name>_plain (the op's CPU implementation)."""
    plain = getattr(mod, name + "_plain")
    count = [0]

    def counted(*a, **k):
        count[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(mod, name + "_plain", counted)
    return count


def _brief(rng, shape):
    return torch.from_numpy((rng.integers(0, 2, shape) * 2 - 1).astype(np.float32) / 16)


def _match_inputs(B, W, K=40, N=33, seed=0):
    """Per sequence b: an A (K, D) with mask and predicted positions, and W
    sets B (N, D) with masks and positions; W = 0 gives one set per
    sequence without the W axis."""
    rng = np.random.default_rng(seed)
    lead = (B, W) if W else (B,)
    a, b = _brief(rng, (B, K, 256)), _brief(rng, lead + (N, 256))
    b[..., :5, :] = a[:, None, :5] if W else a[:, :5]         # exact matches and ties
    ma = torch.from_numpy(rng.uniform(size=(B, K)) > 0.1)
    mb = torch.from_numpy(rng.uniform(size=lead + (N,)) > 0.1)
    uva = torch.from_numpy(rng.uniform(0, 60, (B, K, 2)).astype(np.float32))
    uvb = torch.from_numpy(rng.uniform(0, 60, lead + (N, 2)).astype(np.float32))
    return a, ma, b, mb, uva, uvb


def _assert_outputs_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("gated", [False, True])
def test_match_vmap_pair_per_sequence(monkeypatch, gated):
    """The per-frame match and the gated rescue of the batched step: every
    operand mapped (an A per sequence, a_group = 1): one call, equal to the
    per-sequence calls."""
    a, ma, b, mb, uva, uvb = _match_inputs(4, 0)
    gate = GATE if gated else 0.0
    calls = _calls(monkeypatch, match_kernel, "match_top2")
    got = torch.func.vmap(lambda *x: match_top2(*x, gate_radius=gate))(a, ma, b, mb, uva, uvb)
    assert calls[0] == 1
    want = [torch.stack(x) for x in zip(*[match_top2(a[i], ma[i], b[i], mb[i], uva[i], uvb[i],
                                                     gate) for i in range(4)])]
    _assert_outputs_equal(got, want)
    if gated:   # the gate excludes candidates: not the ungated result
        assert not torch.equal(got[0], torch.func.vmap(match_top2)(a, ma, b, mb)[0])


def test_match_vmap_window_per_sequence(monkeypatch):
    """The window-track match of the batched step: each sequence's anchor A
    against its own W window sets (a_group = W): one call."""
    a, ma, b, mb, _, _ = _match_inputs(3, 5)
    calls = _calls(monkeypatch, match_kernel, "match_top2")
    got = torch.func.vmap(match_top2)(a, ma, b, mb)
    assert calls[0] == 1 and got[0].shape == (3, 5, 40) and got[3].shape == (3, 5, 33)
    want = [torch.stack(x) for x in zip(*[match_top2(a[i], ma[i], b[i], mb[i])
                                          for i in range(3)])]
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("mapped", ["b_only", "a_only", "masks_only"])
def test_match_vmap_mixed_in_dims(monkeypatch, mapped):
    """Mapped and unmapped operands mixed: an unmapped A stays one A shared
    by the folded batch (a_group = the batch); an unmapped B (or A, B with
    mapped masks only) is broadcast to every entry. One call each, equal
    to the per-entry calls; a mapped dimension other than the first moves
    to the front."""
    a, ma, b, mb, uva, uvb = _match_inputs(3, 0)
    calls = _calls(monkeypatch, match_kernel, "match_top2")
    if mapped == "b_only":
        fn = torch.func.vmap(lambda bb, mm, uu: match_top2(a[0], ma[0], bb, mm, uva[0], uu, GATE),
                             in_dims=(1, 0, 0))
        got = fn(b.transpose(0, 1), mb, uvb)
        each = [(a[0], ma[0], b[i], mb[i], uva[0], uvb[i]) for i in range(3)]
    elif mapped == "a_only":
        fn = torch.func.vmap(lambda aa, mm: match_top2(aa, mm, b[0], mb[0]))
        got = fn(a, ma)
        each = [(a[i], ma[i], b[0], mb[0]) for i in range(3)]
    else:
        fn = torch.func.vmap(lambda m1, m2: match_top2(a[0], m1, b[0], m2))
        got = fn(ma, mb)
        each = [(a[0], ma[i], b[0], mb[i]) for i in range(3)]
    assert calls[0] == 1
    gate = (GATE,) if mapped == "b_only" else ()
    want = [torch.stack(x) for x in zip(*[match_top2(*e, *gate) for e in each])]
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_response_vmap_folds_into_one_call(monkeypatch, family, radius):
    """The detector on each pyramid level of the batched step, (H, W)
    mapped: one call of the op for the whole batch, equal to the op on the
    stacked (B, H, W) images, and to the per-image calls within float32
    round-off (the NMS agreeing but where round-off flips a near-tie), the
    radius-r NMS included (`_gradmag2` has none)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 255, (3, 37, 53)).astype(np.float32))
    calls = _calls(monkeypatch, harris_kernel, "response_nms")
    got = torch.func.vmap(lambda im: tuple(o for o in response_nms(im, family, radius)
                                           if o is not None))(x)
    assert calls[0] == 1
    stacked = [o for o in response_nms(x, family, radius) if o is not None]
    _assert_outputs_equal(got, stacked)
    for i in range(3):
        nms_i, resp_i = response_nms(x[i], family, radius)
        scale = resp_i.abs().max()
        assert (got[-1][i] - resp_i).abs().max() <= 1e-5 * scale
        if nms_i is not None:
            assert (torch.isneginf(got[0][i]) == torch.isneginf(nms_i)).float().mean() > 0.99


def test_fed_vmap_folds_into_one_call(monkeypatch):
    """FED in the batched nonlinear scale space: a field and a contrast k
    per sequence, both mapped (the fold gives each field its own k), and an
    unmapped k shared by all; one call each, equal to the op on the stacked
    fields, and to the per-field calls within 4e-4 (module docstring)."""
    rng = np.random.default_rng(2)
    L = torch.from_numpy(rng.uniform(0, 255, (3, 30, 41)).astype(np.float32))
    k = torch.tensor([2.0, 5.0, 11.0])
    taus = [0.1, 0.2, 0.24, 0.15]
    calls = _calls(monkeypatch, fed_kernel, "fed_evolve")
    got = torch.func.vmap(lambda f, kk: fed_evolve(f, kk, taus))(L, k)
    shared = torch.func.vmap(lambda f: fed_evolve(f, k[1], taus))(L)
    assert calls[0] == 2
    assert torch.equal(got, fed_evolve(L, k, taus))
    assert torch.equal(shared, fed_evolve(L, k[1].expand(3), taus))
    for i in range(3):
        torch.testing.assert_close(got[i], fed_evolve(L[i], k[i], taus), rtol=0, atol=4e-4)
        torch.testing.assert_close(shared[i], fed_evolve(L[i], k[1], taus), rtol=0, atol=4e-4)
    assert (got[0] - got[2]).abs().max() > 1.0    # k reached its own field
