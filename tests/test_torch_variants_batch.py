"""vislam_tpu_torch's batched sequences (`engine/batch.py::run_batch_scan`)
with the step options the reference's run_batch_scan also vmaps: vision-only
rotation (the essential solve under torch.func.vmap), oriented descriptors,
the always-on guided match, the photometric refine, and the marg and
oldest2 gauges. Every test runs with vmap's per-example fallback disabled,
so an operator without a batching rule raises instead of looping.

Tolerances, each with what was measured when written (B = 2, sequences 3
and 9):
- vision-only rotation: each entry against its unbatched run, keyframes
  and match counts equal, positions within 1e-5 m (measured 6e-8); against
  the reference's run_batch_scan on its draws (its hypothesis eigenvector
  from float64 LAPACK, as tests/test_torch_essential.py runs it), keyframes
  equal and inlier counts within 3 on every frame; the translation
  direction within 1e-3 on all but 2 of the 16 frames, and positions
  within 1e-3 m up to an entry's first frame where it is not: such a
  frame has two solutions of near-equal support and either package may
  take the other one from last-bit rounding (tests/test_torch_essential.py;
  measured: 1 frame, entry 1's third, 152 inliers in both, positions
  within 2.7e-6 m before it);
- the other options, each entry against its unbatched run, keyframes and
  match counts equal: oriented and gated positions within 1e-5 m
  (measured 0 and 1.5e-8); photometric within 2e-3 m (measured 5.3e-4:
  batched convolutions round 1 ulp apart from single ones, and the refine
  amplifies round-off, tests/test_torch_variants_photometric.py); marg and
  oldest2 (SLAM mode, GT scale, only slot 0 fixed while the prior is
  empty) with the window LM capped at 4 iterations, within 1e-4 m over 3
  frames (was 1e-2 m at 12 iterations; by the 4th frame one entry's match
  count differs by 130). The third frame's keyframe refine drifts along a
  weak direction of the window (tests/test_torch_variants_gauges.py) past
  ~8 of 12 LM iterations, where the batched and unbatched runs part by
  0.0865 m on an AVX-512 host (2.5e-3 m where first written); at 4 they
  agree within 4.2e-5 m on an AVX-512 host and under AVX2 alike, and the
  unbatched run alone moves by up to 7.6e-5 m under a 1-ulp change of its
  IMU samples (8 random sign patterns).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vislam_tpu.frontend.essential as jess
from test_torch_batch import _count_plain_calls, _init, _kf0, _seqs
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.engine import make_sequence_inputs as j_inputs
from vislam_tpu.engine import run_batch_scan as j_run_batch_scan
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import (
    VIOEngine as TEngine,
    make_batch_inputs,
    make_sequence_inputs,
    run_batch_scan,
    run_sequence_scan,
    sequence_seed,
    stack_states,
)
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import batch_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def _cfg(cfg, frontend=None, backend=None, engine=None, f32=False):
    fe = dict(frontend or {}, **({"image_dtype": "float32"} if f32 else {}))
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, **fe),
        backend=dataclasses.replace(cfg.backend, **(backend or {})),
        engine=dataclasses.replace(cfg.engine, **(engine or {})))


VISION = dict(frontend=dict(levels_used=1), engine=dict(vision_rotation=True))

MODES = {
    # overrides, frames, position tolerance, op calls per batched step
    "vision_rotation": (VISION, 6, 1e-5, {"response_nms": 1, "match_top2": 1}),
    "oriented": (dict(frontend=dict(oriented=True)), 4, 1e-5,
                 {"response_nms": 2, "match_top2": 2}),
    "gated": (dict(frontend=dict(guided_gate_px=30.0)), 4, 1e-5,
              {"response_nms": 2, "match_top2": 1}),
    "photometric": (dict(engine=dict(photometric_refine=True)), 5, 2e-3,
                    {"response_nms": 2, "match_top2": 2}),
    "marg": (dict(backend=dict(vi_factors=True, refine_in_step=True, online_gauge="marg",
                               lm_iters=4)), 3, 1e-4, {"response_nms": 2, "match_top2": 3}),
    "oldest2": (dict(backend=dict(vi_factors=True, refine_in_step=True,
                                  online_gauge="oldest2", lm_iters=4)), 3, 1e-4,
                {"response_nms": 2, "match_top2": 3}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_entries_equal_unbatched_runs(monkeypatch, mode):
    """Entry b of run_batch_scan against run_sequence_scan with seed
    sequence_seed(seed, b), GT scale; each batched step calls each
    kernel's op once for the whole batch (vision-only: one level, one
    match and no rescue; gated: the gated match only)."""
    over, n, atol, per_step = MODES[mode]
    seqs = _seqs(n + 1)
    eng = TEngine(seqs[0]["calib"], _cfg(tconfig.SystemConfig(), **over), device="cpu")
    inputs = [make_sequence_inputs(s, 1, n + 1, device="cpu") for s in seqs]
    states0 = stack_states([_init(eng, s) for s in seqs])
    counts = _count_plain_calls(monkeypatch)
    _, res = run_batch_scan(eng, states0, make_batch_inputs(inputs), _kf0(seqs), seed=7)
    assert counts == {**{k: v * n for k, v in per_step.items()}, "fed_evolve": 0}, counts
    monkeypatch.undo()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    assert torch.isfinite(res.p_wc).all()
    for b, (seq, inp) in enumerate(zip(seqs, inputs)):
        _, one = run_sequence_scan(eng, _init(eng, seq), inp, seed=sequence_seed(7, b))
        assert torch.equal(res.is_keyframe[b], one.is_keyframe)
        assert torch.equal(res.num_matches[b], one.num_matches)
        torch.testing.assert_close(res.p_wc[b], one.p_wc, rtol=0, atol=atol)


def test_batch_vision_rotation_matches_reference_run_batch_scan(monkeypatch):
    """B = 2, 8 frames of the KITTI mode (vision-only rotation, one level,
    float32 pipeline, GT scale): the port's batch from the reference's
    converted batch state, on the reference's draws (entry b's frame n:
    gumbel(fold_in(split(PRNGKey(0), 2)[b], n), (512, 8, 512))), against
    the reference's run_batch_scan with the exact hypothesis eigenvector."""
    def exact(G):
        def f(g):
            return np.linalg.eigh(np.asarray(g, np.float64))[1][..., 0].astype(np.float32)
        return jax.pure_callback(f, jax.ShapeDtypeStruct(G.shape[:-1], jnp.float32), G,
                                 vmap_method="expand_dims")

    monkeypatch.setattr(jess, "_smallest_evec_9", exact)
    n = 8
    seqs = _seqs(n + 1)
    jeng = JEngine(seqs[0]["calib"], _cfg(JSystem(), **VISION, f32=True))
    jstates = [_init(jeng, s) for s in seqs]
    jins = [j_inputs(s) for s in seqs]
    _, jres = j_run_batch_scan(
        jeng, jax.tree.map(lambda *xs: jnp.stack(xs), *jstates),
        jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *jins),
        jnp.asarray(_kf0(seqs)))

    teng = TEngine(seqs[0]["calib"], _cfg(tconfig.SystemConfig(), **VISION, f32=True),
                   device="cpu")
    states0, inputs = batch_from_numpy([jax.tree.map(np.asarray, s) for s in jstates],
                                       [jax.tree.map(np.asarray, i) for i in jins], "cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    noises = [[(torch.from_numpy(np.asarray(jax.random.gumbel(
        jax.random.fold_in(keys[b], k), (512, 8, 512)))), None) for k in range(n)]
        for b in range(2)]
    _, tres = run_batch_scan(teng, states0, inputs, _kf0(seqs), noises=noises)
    np.testing.assert_array_equal(tres.is_keyframe.numpy(), np.asarray(jres.is_keyframe))
    assert tres.is_keyframe.sum() >= 2
    assert np.abs(tres.num_inliers.numpy() - np.asarray(jres.num_inliers)).max() <= 3
    other = np.abs(tres.t_dir_cam.numpy() - np.asarray(jres.t_dir_cam)).max(-1) > 1e-3
    assert other.sum() <= 2, other
    for b in range(2):
        upto = int(np.argmax(other[b])) if other[b].any() else n
        np.testing.assert_allclose(tres.p_wc[b, :upto].numpy(), np.asarray(jres.p_wc)[b, :upto],
                                   atol=1e-3)
