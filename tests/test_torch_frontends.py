"""The port's frontend variants against the reference, engine end to end:
the KAZE analog (nonlinear scale space + hessian), the AKAZE analog
(nonlinear + fast + BRIEF-256), and the harris and dog detectors, each
stepped as tests/test_torch_engine.py steps the default slice (same
synthetic sequence, the reference's own RANSAC draws fed to the port).

The nonlinear runs are held on the trajectory: the reference's CPU path
takes its CPU branch of the contrast factor (2.7% off the TPU branch the
port implements) and XLA's per-step FED borders, so keypoints differ from
the first frame on. harris and dog with a float32 image pipeline compute
the same response in both packages and are held frame by frame.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import _imu, _noises, _run
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.eval import ate_rmse
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)
N_FRAMES = 12
KAZE = dict(scale_space="nonlinear", detector="hessian")
AKAZE = dict(scale_space="nonlinear", detector="fast", descriptor="brief")


def _cfg(base, **frontend):
    return dataclasses.replace(base, frontend=dataclasses.replace(base.frontend, **frontend))


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=N_FRAMES, n_landmarks=300, seed=3))


def _runs(seq, n_frames, keep_state_at=None, **frontend):
    j = _run(JEngine(seq["calib"], _cfg(JSystem(), **frontend)), seq, port=False,
             keep_state_at=keep_state_at, n_frames=n_frames)
    t = _run(TEngine(seq["calib"], _cfg(tconfig.SystemConfig(), **frontend), device="cpu"),
             seq, port=True, n_frames=n_frames)
    return j, t


def _ate(run, seq):
    poses = np.array([seq["gt_pos"][0]] + [r["p"] for r in run])
    return ate_rmse(poses, seq["gt_pos"][:len(poses)], align=False)


@pytest.fixture(scope="module")
def akaze_runs(seq):
    return _runs(seq, N_FRAMES, keep_state_at=10, **AKAZE)


def test_kaze_tracks_like_reference(seq):
    """KAZE analog. Both ATEs under the reference's 0.5 m bound and within
    0.05 m of each other (measured 0.0373 m reference, 0.0377 m port over
    these 11 frames); per-frame match counts within 15% at the median
    (measured 8%) and positions within 5 cm (measured 4.6 mm): the two
    frontends select different keypoints, and a keyframe taken on another
    frame moves every later anchor."""
    (jr, _, _), (tr, _, _) = _runs(seq, N_FRAMES, **KAZE)
    a_j, a_t = _ate(jr, seq), _ate(tr, seq)
    assert a_j < 0.5 and a_t < 0.5, (a_j, a_t)
    assert abs(a_t - a_j) < 0.05, (a_j, a_t)
    rel = [abs(x["nm"] - y["nm"]) / max(x["nm"], 1) for x, y in zip(jr, tr)]
    assert np.median(rel) < 0.15, rel
    assert max(np.abs(x["p"] - y["p"]).max() for x, y in zip(jr, tr)) < 0.05
    assert sum(r["kf"] for r in tr) > 3
    assert (np.array([r["ni"] for r in tr]) >= 8).all()


def test_akaze_tracks_like_reference(akaze_runs, seq):
    """AKAZE analog. It does not track on these sequences in the reference
    either (BENCH_NOTES.md: fast + BRIEF gives too few matches): no frame
    reaches the match floor that admits a vision solve (0.35 of the
    keyframe's fine keypoints), no keyframe is taken, and the pose follows
    the IMU. So the ATEs agree to 1 mm (measured equal to 1e-8 m), and what
    the run does show of BRIEF matching is held directly: the same
    keyframes (none) and per-frame match counts within 10% at the median
    (measured 3%)."""
    (jr, _, _), (tr, _, _) = akaze_runs
    a_j, a_t = _ate(jr, seq), _ate(tr, seq)
    assert a_j < 0.5 and a_t < 0.5, (a_j, a_t)
    assert abs(a_t - a_j) < 1e-3, (a_j, a_t)
    assert [r["kf"] for r in tr] == [r["kf"] for r in jr]
    rel = [abs(x["nm"] - y["nm"]) / max(x["nm"], 1) for x, y in zip(jr, tr)]
    assert np.median(rel) < 0.1, rel
    assert np.median([r["nm"] for r in tr]) > 30


@pytest.mark.parametrize("detector", ["harris", "dog"])
def test_detector_f32_pipeline_matches_reference_frame_by_frame(seq, detector):
    """harris / dog with a float32 image pipeline, same draws: as
    test_float32_pipeline_matches_reference_frame_by_frame holds the
    default detector (the same keyframe decision on every frame, counts
    within 2, positions within 2 mm; measured equal counts and 2e-7 m)."""
    (jr, _, _), (tr, _, _) = _runs(seq, 6, detector=detector, image_dtype="float32")
    assert [r["kf"] for r in jr] == [r["kf"] for r in tr]
    for x, y in zip(jr, tr):
        assert abs(x["nm"] - y["nm"]) <= 2, (x, y)
        assert abs(x["ni"] - y["ni"]) <= 2, (x, y)
        np.testing.assert_allclose(y["p"], x["p"], atol=2e-3)


def test_akaze_state_from_reference_steps_like_reference(akaze_runs, seq):
    """A reference AKAZE state (after frame 10) converts 1:1, its (W, K, 256)
    bf16 descriptor bank and (K, 256) keyframe descriptors included, and one
    port step from it takes the reference's keyframe decision with a match
    count within 25% (measured 45 against 40: the new frame's features come
    from each package's own frontend, whose per-frame counts differ by up
    to 23% over the run above) and the same position (the pose follows the
    IMU)."""
    (jr, _, (jstate, last_kf)), _ = akaze_runs
    tree = jax.tree.map(np.asarray, jstate)
    st = state_from_numpy(tree, "cpu")
    assert st.window.desc.dtype == torch.bfloat16
    assert tuple(st.window.desc.shape) == (10, 768, 256)
    assert tuple(st.kf_feat.desc.shape) == (768, 256)
    back = state_to_numpy(st)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    eng = TEngine(seq["calib"], _cfg(tconfig.SystemConfig(), **AKAZE), device="cpu")
    eng.set_step_counter(10)
    imu, dt = _imu(seq, 11)
    gt_norm = float(np.linalg.norm(seq["gt_pos"][11] - seq["gt_pos"][last_kf]))
    _, res = eng.step(st, seq["images"][11], imu, dt, gt_norm, *_noises(10))
    ref = jr[10]   # frame 11
    assert bool(res.is_keyframe) == ref["kf"]
    assert abs(int(res.num_matches) - ref["nm"]) <= 0.25 * ref["nm"], (int(res.num_matches), ref)
    np.testing.assert_allclose(res.p_wc.numpy(), ref["p"], atol=2e-3)
