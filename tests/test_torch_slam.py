"""vislam_tpu_torch against vislam_tpu: SLAM mode, the in-step window
bundle adjustment (`engine/refine.py` over `backend/ba.py` and
`backend/vi_ba.py`), GT-free with IMU factors and with GT scale vision
only. Stepped as tests/test_torch_gtfree.py steps the GT-free runs (the
reference's RANSAC draws, the float32 image pipeline)."""

import jax
import numpy as np
import pytest
import torch

from test_torch_gtfree import configure, hold_frame_by_frame, run_both
from test_torch_engine import _noises
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine.refine import build_window_problem as j_build_window_problem
from vislam_tpu.engine.refine import refine_window as j_refine_window
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.engine import make_sequence_inputs, run_sequence_scan
from vislam_tpu_torch.engine.refine import build_window_problem as t_build_window_problem
from vislam_tpu_torch.engine.refine import refine_window as t_refine_window
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)
SLAM = dict(vi_factors=True, refine_in_step=True)
KEEP = 45          # a keyframe after the VI-BA engaged (frame 38)


@pytest.fixture(scope="module")
def seq60():
    return make_synthetic_sequence(SyntheticConfig(n_frames=60, n_landmarks=300, seed=0))


@pytest.fixture(scope="module")
def slam_runs(seq60):
    """The warm GT-free SLAM run over 60 frames (tests/test_two_phase.py:82,
    the in-step refine of `backend.refine_in_step`), both packages, and the
    reference's state after frame KEEP."""
    return run_both(seq60, 60, keep_state_at=KEEP, **SLAM)


def test_slam_matches_reference_frame_by_frame(slam_runs, seq60):
    """Keyframes, vi_aligned, vi_engaged and the apply count equal on every
    frame (the VI-BA engages at frame 38 in both); positions within 1e-2 m
    (measured 3.9e-5: the window BA's float32 solves redistribute round-off
    but the capped anchor feedback keeps it small); ATE within 0.05 m of the
    reference's and under 0.5 m (measured 0.2263 both)."""
    (jr, _, _), (tr, tstate, _) = slam_runs
    hold_frame_by_frame(jr, tr, seq60, max_ate=0.5)
    assert tr[-1]["engaged"] and not tr[20]["engaged"]
    assert tstate.window.count.item() == 10


def _engaged_state(slam_runs):
    (_, _, jstate), _ = slam_runs
    assert bool(jstate.vi_engaged) and int(jstate.window.count) == 10
    return jax.tree.map(np.asarray, jstate)


def test_window_problem_matches_reference(slam_runs, seq60):
    """Track association (one batched match), triangulation and the VI
    outlier gates on the reference's engaged window: the observation mask
    and the surviving tracks equal but for at most 1% of entries (a
    near-tied descriptor match or a gate at its threshold may flip;
    measured: equal), the observations exact, the landmarks of common
    tracks within 1e-2 of their range from the anchor keyframe (measured:
    median 4.5e-6, max 3.5e-3, the largest on tracks whose first and last
    rays are nearly parallel, where the midpoint depth amplifies float32
    round-off of the window poses)."""
    tree = _engaged_state(slam_runs)
    c = seq60["calib"]
    jcfg = configure(JSystem(), **SLAM)
    tcfg = configure(tconfig.SystemConfig(), **SLAM)
    js, jp, jok = jax.tree.map(np.asarray, j_build_window_problem(
        jax.tree.map(jax.numpy.asarray, tree), jcfg, c.fx, c.fy, c.cx, c.cy))
    ts, tp, tok = t_build_window_problem(state_from_numpy(tree, "cpu"), tcfg,
                                         c.fx, c.fy, c.cx, c.cy)
    both = jp.obs_mask & tp.obs_mask.numpy()
    assert jp.obs_mask.sum() > 500
    assert np.mean(jp.obs_mask != tp.obs_mask.numpy()) <= 0.01
    assert np.mean(jok != tok.numpy()) <= 0.01
    np.testing.assert_array_equal(tp.obs_uv.numpy()[both], jp.obs_uv[both])
    common = jok & tok.numpy()
    p_anchor = -tree.window.R_cw[-1].T @ tree.window.t_cw[-1]
    rng = np.linalg.norm(js.X[common] - p_anchor, axis=-1)
    dX = np.linalg.norm(ts.X.numpy()[common] - js.X[common], axis=-1)
    assert (dX <= 1e-2 * rng).all(), (dX / rng).max()


def test_refine_window_from_reference_state(slam_runs, seq60):
    """One refine_window call on the reference's engaged window (converted),
    in both packages: the refined window positions, the anchor, velocities
    and the bias within 1e-3 m (m/s); the refine moved the window."""
    tree = _engaged_state(slam_runs)
    c = seq60["calib"]
    R_bc = np.asarray(c.T_body_cam[:3, :3], np.float32)
    j = jax.tree.map(np.asarray, j_refine_window(
        jax.tree.map(jax.numpy.asarray, tree), configure(JSystem(), **SLAM),
        c.fx, c.fy, c.cx, c.cy, R_bc=R_bc))
    t = state_to_numpy(t_refine_window(
        state_from_numpy(tree, "cpu"), configure(tconfig.SystemConfig(), **SLAM),
        c.fx, c.fy, c.cx, c.cy, R_bc=torch.from_numpy(R_bc)))

    def pos(s):
        return -np.einsum("wji,wj->wi", s.window.R_cw, s.window.t_cw)

    assert np.abs(pos(j) - pos(tree)).max() > 1e-4      # the BA was kept
    np.testing.assert_allclose(pos(t), pos(j), atol=1e-3)
    np.testing.assert_allclose(t.window.v_w, j.window.v_w, atol=1e-3)
    for name in ("p_wc", "kf_p_wc", "v_w", "bias_g", "bias_a"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), atol=1e-3,
                                   err_msg=name)


def test_slam_scan_equals_step_loop(seq60):
    """run_sequence_scan in SLAM mode, GT-free, gives the frames a loop of
    steps gives."""
    n = 6
    eng = TEngine(seq60["calib"], configure(tconfig.SystemConfig(), **SLAM), device="cpu")

    def init():
        return eng.initialize(seq60["images"][0], q_wb0=seq60["gt_quat"][0],
                              v_w0=seq60["gt_vel"][0], p_w0=seq60["gt_pos"][0])

    inputs = make_sequence_inputs(seq60, 1, n + 1, use_gt_scale=False, device="cpu")
    noises = [_noises(k) for k in range(n)]
    state_s, res_s = run_sequence_scan(eng, init(), inputs, noises=noises)
    state = init()
    for k in range(n):
        state, res = eng.step(state, inputs.images[k], inputs.imu[k], inputs.imu_dt[k],
                              -1.0, *noises[k])
        assert torch.equal(res.p_wc, res_s.p_wc[k])
    assert torch.equal(state.window.t_cw, state_s.window.t_cw)
    assert int(res_s.is_keyframe.sum()) >= 3


def test_vision_only_in_step_ba_matches_reference(seq60):
    """GT scale with the in-step vision-only BA (`refine_in_step` without
    IMU factors, `backend/ba.py`), 20 frames: every latch and keyframe
    equal, positions within 1e-2 m (measured 1.5e-6), ATE within 0.05 m of
    the reference's (measured 0.0708 both)."""
    (jr, _, _), (tr, _, _) = run_both(seq60, 20, gt_scale=True, refine_in_step=True)
    hold_frame_by_frame(jr, tr, seq60, max_ate=0.5)
