"""The slice: vislam_tpu_torch's VIOEngine against vislam_tpu's on one
synthetic sequence, default SystemConfig(), GT scale, stepped as
tests/test_engine.py steps the reference. The port is fed the reference's
own RANSAC draws (rebuilt from fold_in(PRNGKey(0), frame) and its fold_in
7 for the rescue), so both solve from the same hypotheses.

At the default config the two frontends differ by design: the reference's
CPU path computes the detector response in bf16, the port in float32 (as
the reference's TPU kernel does), so keypoints, and with them keyframe
decisions, drift apart within a few frames; that run is held on the
trajectory. With a float32 image pipeline both compute the same response,
and the run is held frame by frame.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import (
    VIOEngine as TEngine,
    make_sequence_inputs,
    run_sequence_scan,
)
from vislam_tpu_torch.eval import ate_rmse
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import (
    inputs_from_numpy,
    inputs_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

torch.set_num_threads(2)
N_FRAMES = 20
H = 512


def _f32(cfg):
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 image_dtype="float32"))


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=N_FRAMES, n_landmarks=300, seed=3))


def _imu(seq, j):
    lo, hi = (j - 1) * 10, j * 10
    imu = np.zeros((16, 6), np.float32)
    imu[:10] = np.concatenate([seq["imu_gyro"][lo:hi], seq["imu_accel"][lo:hi]], -1)
    dt = np.zeros(16, np.float32)
    dt[:10] = 1 / 200.0
    return imu, dt


def _jax_noise(key, M):
    ka, kb = jax.random.split(key)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(ka, (H, M))),
                                      np.asarray(jax.random.gumbel(kb, (H, M)))]))


def _noises(counter, M=768):
    key = jax.random.fold_in(jax.random.PRNGKey(0), counter)
    return _jax_noise(key, M), _jax_noise(jax.random.fold_in(key, 7), M)


def _init(eng, seq):
    return eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                          v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])


def _run(eng, seq, port, keep_state_at=None, n_frames=N_FRAMES):
    state = _init(eng, seq)
    last_kf, out, kept = 0, [], None
    for j in range(1, n_frames):
        imu, dt = _imu(seq, j)
        gt_norm = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        if port:
            state, res = eng.step(state, seq["images"][j], imu, dt, gt_norm,
                                  *_noises(j - 1))
        else:
            state, res = eng.step(state, seq["images"][j], imu, dt, gt_norm)
        if bool(res.is_keyframe):
            last_kf = j
        out.append(dict(p=np.asarray(res.p_wc), kf=bool(res.is_keyframe),
                        nm=int(res.num_matches), ni=int(res.num_inliers),
                        fb=bool(res.used_fallback)))
        if j == keep_state_at:
            kept = (state, last_kf)
    return out, state, kept


@pytest.fixture(scope="module")
def default_runs(seq):
    j = _run(JEngine(seq["calib"]), seq, port=False)
    t = _run(TEngine(seq["calib"], device="cpu"), seq, port=True)
    return j, t


@pytest.fixture(scope="module")
def f32_runs(seq):
    j = _run(JEngine(seq["calib"], _f32(JSystem())), seq, port=False, keep_state_at=10)
    t = _run(TEngine(seq["calib"], _f32(tconfig.SystemConfig()), device="cpu"), seq,
             port=True)
    return j, t


def _ate(run, seq):
    poses = np.array([seq["gt_pos"][0]] + [r["p"] for r in run])
    return ate_rmse(poses, seq["gt_pos"][:N_FRAMES], align=False)


def test_default_config_tracks_like_reference(default_runs, seq):
    """Default config. Both ATEs under the reference's own 0.5 m bound
    (tests/test_engine.py) and the port's within 0.05 m of the reference's
    (measured: 0.0646 m reference, 0.0678 m port). Once the frontends pick
    a different keyframe the runs track different anchors, so the rest is
    held loosely: keyframe decisions agree on at least half the frames
    (measured 0.68), the median per-frame match count differs by under 10%
    (measured 1%), positions stay within 5 cm (measured 1.6 cm)."""
    (jr, _, _), (tr, _, _) = default_runs
    a_j, a_t = _ate(jr, seq), _ate(tr, seq)
    assert a_j < 0.5 and a_t < 0.5, (a_j, a_t)
    assert abs(a_t - a_j) < 0.05, (a_j, a_t)
    kf_agree = np.mean([x["kf"] == y["kf"] for x, y in zip(jr, tr)])
    assert kf_agree >= 0.5, kf_agree
    rel = [abs(x["nm"] - y["nm"]) / max(x["nm"], 1) for x, y in zip(jr, tr)]
    assert np.median(rel) < 0.1, rel
    dp = max(np.abs(x["p"] - y["p"]).max() for x, y in zip(jr, tr))
    assert dp < 0.05, dp
    # The reference's own acceptance checks hold for the port.
    assert (np.array([r["nm"] for r in tr]) > 50).mean() > 0.9
    assert (np.array([r["ni"] for r in tr]) >= 8).mean() > 0.9


def test_float32_pipeline_matches_reference_frame_by_frame(f32_runs, seq):
    """Float32 image pipeline, same draws: the same keyframe decision on
    every frame, match and inlier counts within 2 (a near-tie may flip one
    match; measured: equal on every frame), positions within 2 mm
    (measured 0.34 mm: float32 round-off through 19 composed poses)."""
    (jr, _, _), (tr, _, _) = f32_runs
    assert [r["kf"] for r in jr] == [r["kf"] for r in tr]
    for x, y in zip(jr, tr):
        assert abs(x["nm"] - y["nm"]) <= 2, (x, y)
        assert abs(x["ni"] - y["ni"]) <= 2, (x, y)
        np.testing.assert_allclose(y["p"], x["p"], atol=2e-3)


def test_forced_rescue_matches_reference_frame_by_frame(seq):
    """The rescue re-match taken on every frame (an inlier trigger no solve
    can pass, and a win margin any gated solve beats): the port's selects
    stand in for the reference's lax.cond, so the same frames take the
    gated solve and the rest is held as in the float32 test above."""
    def forced(cfg):
        cfg = _f32(cfg)
        return dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, fallback_trigger_inliers=10 ** 6, fallback_win_margin=0.0))

    n = 8
    jr, _, _ = _run(JEngine(seq["calib"], forced(JSystem())), seq, port=False, n_frames=n)
    tr, _, _ = _run(TEngine(seq["calib"], forced(tconfig.SystemConfig()), device="cpu"),
                    seq, port=True, n_frames=n)
    assert all(r["fb"] for r in jr), [r["fb"] for r in jr]
    assert [r["fb"] for r in tr] == [r["fb"] for r in jr]
    assert [r["kf"] for r in tr] == [r["kf"] for r in jr]
    for x, y in zip(jr, tr):
        assert abs(x["nm"] - y["nm"]) <= 2, (x, y)
        assert abs(x["ni"] - y["ni"]) <= 2, (x, y)
        np.testing.assert_allclose(y["p"], x["p"], atol=2e-3)


def test_state_conversion_roundtrip_and_step_from_reference_state(f32_runs, seq):
    """A reference state (after frame 10) converts 1:1, dtypes included, and
    one port step from it matches the reference's next step."""
    (jr, _, (jstate, last_kf)), _ = f32_runs
    tree = jax.tree.map(np.asarray, jstate)
    st = state_from_numpy(tree, "cpu")
    assert st.window.desc.dtype == torch.bfloat16
    assert st.kf_feat.mask.dtype == torch.bool and st.frame_idx.dtype == torch.int32
    back = state_to_numpy(st)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    eng = TEngine(seq["calib"], _f32(tconfig.SystemConfig()), device="cpu")
    eng.set_step_counter(10)
    imu, dt = _imu(seq, 11)
    gt_norm = float(np.linalg.norm(seq["gt_pos"][11] - seq["gt_pos"][last_kf]))
    _, res = eng.step(st, seq["images"][11], imu, dt, gt_norm, *_noises(10))
    ref = jr[10]   # frame 11
    assert bool(res.is_keyframe) == ref["kf"]
    assert abs(int(res.num_matches) - ref["nm"]) <= 2
    np.testing.assert_allclose(res.p_wc.numpy(), ref["p"], atol=2e-3)


def test_scan_at_seed_equals_reference_without_fed_draws(f32_runs, seq):
    """No draws fed in: the port's run_sequence_scan at seed 0 draws under
    its own keys (fold_in(PRNGKey(0), n), the reference's) and, over the
    float32 pipeline's first 12 frames, is held against the reference's
    step loop at seed 0 as the fed test above holds it: the same keyframe
    and rescue decisions on every frame, match and inlier counts within 2,
    positions within 2 mm."""
    (jr, _, _), _ = f32_runs
    n = 12
    eng = TEngine(seq["calib"], _f32(tconfig.SystemConfig()), seed=0, device="cpu")
    _, res = run_sequence_scan(eng, _init(eng, seq),
                               make_sequence_inputs(seq, 1, n + 1, device="cpu"), seed=0)
    assert [bool(k) for k in res.is_keyframe] == [r["kf"] for r in jr[:n]]
    assert [bool(f) for f in res.used_fallback] == [r["fb"] for r in jr[:n]]
    for k, x in enumerate(jr[:n]):
        assert abs(int(res.num_matches[k]) - x["nm"]) <= 2, (k, x)
        assert abs(int(res.num_inliers[k]) - x["ni"]) <= 2, (k, x)
        np.testing.assert_allclose(res.p_wc[k].numpy(), x["p"], atol=2e-3)


def test_run_sequence_scan_equals_step_loop(seq):
    """The sequence loop and a loop of step draw the same hypotheses (frame
    key fold_in(PRNGKey(seed), frame index)) and produce the same results."""
    n = 8
    eng = TEngine(seq["calib"], device="cpu")
    inputs = make_sequence_inputs(seq, 1, n + 1, device="cpu")
    # The staged inputs convert to numpy and back unchanged.
    back = inputs_from_numpy(inputs_to_numpy(inputs), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[:4], inputs[:4]))
    assert back.use_gt_scale is True
    state_s, res_s = run_sequence_scan(eng, _init(eng, seq), inputs)

    state = _init(eng, seq)
    kf_gt = state.p_wc.clone()
    for k in range(n):
        gt_norm = float(torch.linalg.vector_norm(inputs.gt_pos[k] - kf_gt))
        state, res = eng.step(state, inputs.images[k], inputs.imu[k], inputs.imu_dt[k],
                              gt_norm)
        if bool(res.is_keyframe):
            kf_gt = inputs.gt_pos[k]
        assert bool(res.is_keyframe) == bool(res_s.is_keyframe[k])
        assert int(res.num_matches) == int(res_s.num_matches[k])
        assert torch.equal(res.p_wc, res_s.p_wc[k])
    assert res_s.p_wc.shape == (n, 3)
    assert torch.equal(state.p_wc, state_s.p_wc)
    assert int(state_s.frame_idx) == n
    assert res_s.is_keyframe.any()


STEP_OPTIONS = [
    ("engine", "photometric_refine", True),
    ("backend", "online_gauge", "marg"),
    ("backend", "online_gauge", "oldest2"),
    ("frontend", "oriented", True),
    ("frontend", "guided_gate_px", 40.0),
]


@pytest.mark.parametrize("section,field,value", STEP_OPTIONS)
def test_step_options_construct_and_step(seq, section, field, value):
    """The settings the port refused until it ported them: each constructs
    and steps 3 frames with finite poses (each is held against the
    reference in tests/test_torch_variants_*.py)."""
    base = tconfig.SystemConfig()
    cfg = dataclasses.replace(base, **{section: dataclasses.replace(
        getattr(base, section), **{field: value})})
    eng = TEngine(seq["calib"], cfg, device="cpu")
    out, state, _ = _run(eng, seq, port=True, n_frames=4)
    assert getattr(getattr(eng.cfg, section), field) == value
    assert np.isfinite([r["p"] for r in out]).all() and int(state.frame_idx) == 3


FRONTENDS = {
    "kaze": dict(scale_space="nonlinear", detector="hessian"),
    "akaze": dict(scale_space="nonlinear", detector="fast", descriptor="brief"),
    "harris": dict(detector="harris"),
    "dog": dict(detector="dog"),
}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_frontend_variants_construct_and_step(seq, name):
    """The frontends that raised before their kernels were ported (the
    nonlinear scale space, the other detector families, BRIEF) construct
    and step at full width: K = 768 keypoints of the right descriptor
    width, a finite pose, matches against the first keyframe."""
    base = tconfig.SystemConfig()
    cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                 **FRONTENDS[name]))
    eng = TEngine(seq["calib"], cfg, device="cpu")
    state = _init(eng, seq)
    assert tuple(state.kf_feat.desc.shape) == (768, cfg.frontend.desc_dim)
    assert tuple(state.window.desc.shape) == (10, 768, cfg.frontend.desc_dim)
    imu, dt = _imu(seq, 1)
    gt_norm = float(np.linalg.norm(seq["gt_pos"][1] - seq["gt_pos"][0]))
    state, res = eng.step(state, seq["images"][1], imu, dt, gt_norm, *_noises(0))
    assert torch.isfinite(res.p_wc).all() and int(state.frame_idx) == 1
    assert int(res.num_matches) > 30


def test_nms_radius_other_than_2_raises_on_cuda_only(seq):
    """Another NMS radius (it raised on CUDA before the kernel's raw
    response was routed through the radius-r NMS, as the reference routes
    it) constructs on every device and steps: radius 1 and 3 at full width.
    On a machine without a card, asking for CUDA raises only for the
    missing device. The detector output itself is held against the
    reference in tests/test_torch_detect.py."""
    base = tconfig.SystemConfig()
    for radius in (1, 3):
        cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                     nms_radius=radius))
        eng = TEngine(seq["calib"], cfg, device="cpu")
        state = _init(eng, seq)
        imu, dt = _imu(seq, 1)
        gt_norm = float(np.linalg.norm(seq["gt_pos"][1] - seq["gt_pos"][0]))
        state, res = eng.step(state, seq["images"][1], imu, dt, gt_norm, *_noises(0))
        assert torch.isfinite(res.p_wc).all() and int(state.frame_idx) == 1
        assert int(res.num_matches) > 30 and int(state.kf_feat.mask.sum()) > 300
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TEngine(seq["calib"], cfg, device="cuda")


def test_gt_free_steps_raise(seq):
    """GT-free steps and sequences (they raised before GT-free supervision
    was ported) now run: a negative gt_t_norm selects the IMU scale, and
    use_gt_scale=False sequences give the steps' frames. The alignment and
    the SLAM mode are held against the reference in
    tests/test_torch_gtfree.py and tests/test_torch_slam.py."""
    eng = TEngine(seq["calib"], device="cpu")
    state = _init(eng, seq)
    imu, dt = _imu(seq, 1)
    s1, res = eng.step(state, seq["images"][1], imu, dt, -1.0, *_noises(0))
    assert torch.isfinite(res.p_wc).all() and int(s1.frame_idx) == 1
    assert not bool(s1.vi_aligned)      # GT-free: the latch waits for the alignment
    inputs = make_sequence_inputs(seq, 1, 3, use_gt_scale=False, device="cpu")
    _, res_s = run_sequence_scan(eng, state, inputs, noises=[_noises(0), _noises(1)])
    assert torch.equal(res_s.p_wc[0], res.p_wc)
