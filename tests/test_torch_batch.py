"""vislam_tpu_torch's batched sequences (`engine/batch.py::run_batch_scan`,
B sequences stepped as one torch.func.vmap call of the step per frame)
against vislam_tpu's `run_batch_scan` (a jax.vmap of the scanned step),
and each batch entry against the port's own unbatched run.

Every test runs with vmap's per-example fallback disabled, so an operator
without a batching rule raises instead of looping over the sequences.

The reference comparison feeds the port the reference's own draws: entry
b's frame n solves from fold_in(split(PRNGKey(seed), B)[b], n) and its
fold_in 7 for the rescue, and runs the float32 image pipeline, where both
frontends compute the same response (tests/test_torch_engine.py explains
why the default bf16 pipeline is held on the trajectory instead).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _jax_noise
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
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
    sequence_key,
    stack_states,
    unstack_states,
)
from vislam_tpu_torch.eval import ate_rmse
from vislam_tpu_torch.ops import fed_kernel, harris_kernel, match_kernel, threefry_kernel
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import batch_from_numpy, inputs_from_numpy, inputs_to_numpy

torch.set_num_threads(2)
SEEDS = (3, 9)
N_REF = 12          # frames stepped against the reference


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def _seqs(n_frames):
    return [make_synthetic_sequence(SyntheticConfig(n_frames=n_frames, n_landmarks=300, seed=s))
            for s in SEEDS]


def _init(eng, seq):
    return eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=seq["gt_vel"][0],
                          p_w0=seq["gt_pos"][0])


def _kf0(seqs):
    return np.stack([s["gt_pos"][0] for s in seqs]).astype(np.float32)


def _configure(cfg, f32=True, **backend):
    fe = dataclasses.replace(cfg.frontend, image_dtype="float32") if f32 else cfg.frontend
    return dataclasses.replace(cfg, frontend=fe,
                               backend=dataclasses.replace(cfg.backend, **backend))


@pytest.fixture(scope="module")
def seqs_ref():
    return _seqs(N_REF + 1)


@pytest.fixture(scope="module")
def reference_batch(seqs_ref):
    """The reference's run_batch_scan (seed 0) of sequences 3 and 9 on the
    float32 pipeline, by gt_scale, each made once: (final state, results,
    the port's converted initial states and inputs)."""
    made = {}

    def get(gt_scale):
        if gt_scale not in made:
            jeng = JEngine(seqs_ref[0]["calib"], _configure(JSystem()))
            jstates = [_init(jeng, s) for s in seqs_ref]
            jins = [j_inputs(s, use_gt_scale=gt_scale) for s in seqs_ref]
            jfinal, jres = j_run_batch_scan(
                jeng, jax.tree.map(lambda *xs: jnp.stack(xs), *jstates),
                jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *jins),
                jnp.asarray(_kf0(seqs_ref)))
            made[gt_scale] = (jfinal, jres) + batch_from_numpy(
                [jax.tree.map(np.asarray, s) for s in jstates],
                [jax.tree.map(np.asarray, i) for i in jins], "cpu")
        return made[gt_scale]

    return get


def _held_as_reference(tfinal, tres, jfinal, jres):
    """The same keyframes on every frame of every entry, match counts within
    2 (a near-tie may flip one match), positions within 2e-3 m
    (tests/test_torch_engine.py's float32 bound), the same latches and
    keyframe counts at the end."""
    assert tres.p_wc.shape == (2, N_REF, 3)
    np.testing.assert_array_equal(tres.is_keyframe.numpy(), np.asarray(jres.is_keyframe))
    assert tres.is_keyframe.sum() > 8
    assert np.abs(tres.num_matches.numpy() - np.asarray(jres.num_matches)).max() <= 2
    np.testing.assert_allclose(tres.p_wc.numpy(), np.asarray(jres.p_wc), atol=2e-3)
    for name in ("vi_aligned", "vi_engaged", "bootstrap_applies", "kf_count", "frame_idx"):
        np.testing.assert_array_equal(getattr(tfinal, name).numpy(),
                                      np.asarray(getattr(jfinal, name)), err_msg=name)


@pytest.mark.parametrize("gt_scale", [True, False], ids=["gt_scale", "imu_scale"])
def test_batch_matches_reference_run_batch_scan(seqs_ref, reference_batch, gt_scale):
    """B = 2 (sequences 3 and 9), 12 frames, GT scale and GT-free: the port's
    batch, started from the reference's converted batch state and fed the
    reference's draws, is held as `_held_as_reference` says."""
    jfinal, jres, states0, inputs = reference_batch(gt_scale)
    teng = TEngine(seqs_ref[0]["calib"], _configure(tconfig.SystemConfig()), device="cpu")
    assert inputs.images.shape[:2] == (2, N_REF) and inputs.use_gt_scale is gt_scale
    keys = jax.random.split(jax.random.PRNGKey(0), len(SEEDS))
    noises = [[(_jax_noise(k, 768), _jax_noise(jax.random.fold_in(k, 7), 768))
               for k in (jax.random.fold_in(keys[b], n) for n in range(N_REF))]
              for b in range(len(SEEDS))]
    tfinal, tres = run_batch_scan(teng, states0, inputs, _kf0(seqs_ref), noises=noises)
    _held_as_reference(tfinal, tres, jfinal, jres)


def test_batch_at_seed_equals_reference_without_fed_draws(seqs_ref, reference_batch):
    """No draws fed in: the port's run_batch_scan at seed 0 keys entry b
    with split(PRNGKey(0), 2)[b] and frame n with its fold_in n, the
    reference's keys, and is held against the reference's batch at seed 0
    (GT scale) as the fed test above. Then a rank's slice: entry 1 run
    alone with offset 1 (what `parallel/batch_runner.py` passes a rank
    under process_local) equals entry 1 of the whole batch over its first
    6 frames (keyframes and match counts equal, positions within 1e-5 m:
    batched reductions of 1 against 2 entries)."""
    jfinal, jres, states0, inputs = reference_batch(True)
    teng = TEngine(seqs_ref[0]["calib"], _configure(tconfig.SystemConfig()), device="cpu")
    tfinal, tres = run_batch_scan(teng, states0, inputs, _kf0(seqs_ref), seed=0)
    _held_as_reference(tfinal, tres, jfinal, jres)

    n = 6
    part = inputs._replace(**{f: getattr(inputs, f)[1:, :n]
                              for f in ("images", "imu", "imu_dt", "gt_pos")})
    state1 = stack_states(unstack_states(states0)[1:])
    _, one = run_batch_scan(teng, state1, part, _kf0(seqs_ref)[1:], seed=0, offset=1)
    assert torch.equal(one.is_keyframe[0], tres.is_keyframe[1, :n])
    assert torch.equal(one.num_matches[0], tres.num_matches[1, :n])
    torch.testing.assert_close(one.p_wc[0], tres.p_wc[1, :n], rtol=0, atol=1e-5)


def test_batch_kaze_tracks_like_reference_run_batch_scan():
    """The KAZE analog (nonlinear scale space + hessian) batched, B = 2
    (sequences 3 and 9), 3 frames, GT scale, default pipeline: the port's
    run_batch_scan from the reference's converted batch state on the
    reference's draws, against the reference's run_batch_scan (its FED
    folded by its custom_vmap rule, `vislam_tpu/ops/fed_kernel.py`). Held on
    the trajectory as tests/test_torch_frontends.py holds the unbatched
    KAZE run: the reference's CPU path takes its CPU branch of the contrast
    factor (2.7% off the TPU branch the port implements), so keypoints
    differ from the first frame on. Each entry's ATE under 0.5 m and within
    0.05 m of the reference's, positions within 5e-2 m, match counts within
    15% at the median (measured: positions 4.3e-3 m, match counts 6% apart at
    the median, the ATEs 8e-4 and 2.5e-4 m apart)."""
    n = 3
    seqs = _seqs(n + 1)
    kaze = dict(scale_space="nonlinear", detector="hessian")
    jcfg, tcfg = (dataclasses.replace(c, frontend=dataclasses.replace(c.frontend, **kaze))
                  for c in (JSystem(), tconfig.SystemConfig()))
    jeng = JEngine(seqs[0]["calib"], jcfg)
    jstates = [_init(jeng, s) for s in seqs]
    jins = [j_inputs(s) for s in seqs]
    _, jres = j_run_batch_scan(
        jeng, jax.tree.map(lambda *xs: jnp.stack(xs), *jstates),
        jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *jins),
        jnp.asarray(_kf0(seqs)))

    teng = TEngine(seqs[0]["calib"], tcfg, device="cpu")
    states0, inputs = batch_from_numpy([jax.tree.map(np.asarray, s) for s in jstates],
                                       [jax.tree.map(np.asarray, i) for i in jins], "cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), len(SEEDS))
    noises = [[(_jax_noise(k, 768), _jax_noise(jax.random.fold_in(k, 7), 768))
               for k in (jax.random.fold_in(keys[b], m) for m in range(n))]
              for b in range(len(SEEDS))]
    _, tres = run_batch_scan(teng, states0, inputs, _kf0(seqs), noises=noises)

    jp, tp = np.asarray(jres.p_wc), tres.p_wc.numpy()
    assert tp.shape == jp.shape == (2, n, 3)
    jm, tm = np.asarray(jres.num_matches), tres.num_matches.numpy()
    np.testing.assert_allclose(tp, jp, atol=5e-2)
    assert np.median(np.abs(tm - jm) / np.maximum(jm, 1)) < 0.15, (jm, tm)
    for b, s in enumerate(seqs):
        a_j = ate_rmse(jp[b], s["gt_pos"][1:n + 1], align=False)
        a_t = ate_rmse(tp[b], s["gt_pos"][1:n + 1], align=False)
        assert a_t < 0.5 and abs(a_t - a_j) < 0.05, (b, a_j, a_t)


def _count_plain_calls(monkeypatch):
    """Count the kernels' plain versions as the custom ops call them on the
    CPU (one call per op call: a folded batch counts once)."""
    counts = {"response_nms": 0, "match_top2": 0, "fed_evolve": 0, "threefry_categorical": 0}
    for mod, name in ((harris_kernel, "response_nms"), (match_kernel, "match_top2"),
                      (fed_kernel, "fed_evolve"), (threefry_kernel, "threefry_categorical")):
        plain = getattr(mod, name + "_plain")

        def counted(*a, _plain=plain, _name=name, **k):
            counts[_name] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name + "_plain", counted)
    return counts


MODES = {
    # frontend and backend overrides, GT scale, frames, op calls per batched step
    "default": (dict(), dict(), True, 8, {"response_nms": 2, "match_top2": 2, "fed_evolve": 0,
                                          "threefry_categorical": 2}),
    "kaze": (dict(scale_space="nonlinear", detector="hessian"), dict(), True, 4,
             {"response_nms": 3, "match_top2": 2, "fed_evolve": 2, "threefry_categorical": 2}),
    "akaze": (dict(scale_space="nonlinear", detector="fast", descriptor="brief"), dict(), True,
              4, {"response_nms": 3, "match_top2": 2, "fed_evolve": 2,
                  "threefry_categorical": 2}),
    "slam": (dict(), dict(vi_factors=True, refine_in_step=True), False, 4,
             {"response_nms": 2, "match_top2": 3, "fed_evolve": 0, "threefry_categorical": 2}),
}


# AKAZE does not track on these sequences (in the reference either,
# tests/test_torch_frontends.py): no frame reaches the match floor of a
# vision solve, so it takes no keyframe and its matches are held instead.
NO_KEYFRAMES = {"akaze"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_entries_equal_unbatched_runs(monkeypatch, mode):
    """Each entry b of run_batch_scan equals the port's own
    run_sequence_scan with key sequence_key(seed, b) on the same inputs:
    the same keyframes and match counts, positions within 1e-5 m (float32
    round-off of batched against single reductions), on the default config
    (GT scale), the KAZE analog (FED and the hessian response folded) and
    in SLAM mode (GT-free, the window VI-BA in the step), and the AKAZE
    analog (FED, fast and the contrast statistic folded, the BRIEF-256
    match at a_group 1). Each batched step calls each kernel's op once for
    the whole batch: one response call per level (KAZE, AKAZE: and the
    contrast statistic), one FED call per cycle, 2 matches (main and gated
    rescue), and in SLAM mode the window match as a third; and two draws
    (every entry's main draw, then its rescue's: the categorical op, no
    Gumbel field)."""
    frontend, backend, gt_scale, n, per_step = MODES[mode]
    seqs = _seqs(n + 1)
    base = _configure(tconfig.SystemConfig(), f32=False, **backend)
    cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend, **frontend))
    eng = TEngine(seqs[0]["calib"], cfg, device="cpu")
    inputs = [make_sequence_inputs(s, 1, n + 1, use_gt_scale=gt_scale, device="cpu")
              for s in seqs]
    states0 = stack_states([_init(eng, s) for s in seqs])
    counts = _count_plain_calls(monkeypatch)
    final, res = run_batch_scan(eng, states0, make_batch_inputs(inputs), _kf0(seqs), seed=7)
    assert counts == {k: v * n for k, v in per_step.items()}, counts
    monkeypatch.undo()
    if mode in NO_KEYFRAMES:
        assert not res.is_keyframe.any() and res.num_matches.median() > 30
    else:
        assert res.is_keyframe.any(dim=1).all()
    for b, (seq, inp) in enumerate(zip(seqs, inputs)):
        one_final, one = run_sequence_scan(eng, _init(eng, seq), inp, key=sequence_key(7, b))
        assert torch.equal(res.is_keyframe[b], one.is_keyframe)
        assert torch.equal(res.num_matches[b], one.num_matches)
        torch.testing.assert_close(res.p_wc[b], one.p_wc, rtol=0, atol=1e-5)
        entry = unstack_states(final)[b]
        assert torch.equal(entry.kf_count, one_final.kf_count)
        torch.testing.assert_close(entry.p_wc, one_final.p_wc, rtol=0, atol=1e-5)


def test_batch_default_pipeline_ate():
    """The default bf16 pipeline at B = 2 over 23 frames: both entries
    under the ATE bound tests/test_batch.py holds the reference to (0.6 m),
    with keyframes taken."""
    seqs = [make_synthetic_sequence(SyntheticConfig(n_frames=24, n_landmarks=250, seed=s))
            for s in SEEDS]
    eng = TEngine(seqs[0]["calib"], device="cpu")
    inputs = make_batch_inputs([make_sequence_inputs(s, device="cpu") for s in seqs])
    _, res = run_batch_scan(eng, stack_states([_init(eng, s) for s in seqs]), inputs,
                            _kf0(seqs))
    assert res.p_wc.shape == (2, 23, 3)
    for b, s in enumerate(seqs):
        ate = ate_rmse(res.p_wc[b].numpy(), s["gt_pos"][1:24], align=False)
        assert ate < 0.6, (b, ate)
        assert int(res.is_keyframe[b].sum()) > 3


def test_batch_helpers():
    """sequence_key is a function of (seed, b) that separates sequences;
    make_batch_inputs refuses a batch that mixes GT and IMU scale; states
    stack and unstack to the same leaves; the batched inputs convert to
    numpy (a leading B) and back."""
    assert np.array_equal(sequence_key(0, 1), sequence_key(0, 1))
    assert len({tuple(sequence_key(s, b)) for s in range(3) for b in range(4)}) == 12
    seq = _seqs(3)[0]
    a = make_sequence_inputs(seq, 1, 3, device="cpu")
    with pytest.raises(ValueError, match="use_gt_scale"):
        make_batch_inputs([a, a._replace(use_gt_scale=False)])
    eng = TEngine(seq["calib"], device="cpu")
    s0 = _init(eng, seq)
    back = unstack_states(stack_states([s0, s0]))
    leaves = lambda t: torch.utils._pytree.tree_leaves(t)   # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(leaves(back[1]), leaves(s0)))
    batch = make_batch_inputs([a, a])
    assert batch.images.shape[:2] == (2, 2)
    back = inputs_from_numpy(inputs_to_numpy(batch), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(back[:4], batch[:4]))
    assert back.use_gt_scale is True
