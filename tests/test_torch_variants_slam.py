"""vislam_tpu_torch against vislam_tpu: the step in SLAM mode (the in-step
window VI-BA, `vi_factors` + `refine_in_step`) under the `marg` and
`oldest2` gauges, 20 frames, stepped as tests/test_torch_gtfree.py steps
them (the reference's draws, the float32 image pipeline). The gauges'
solves are held one `refine_window` at a time in
tests/test_torch_variants_gauges.py.

- GT-free: every latch and keyframe equal, positions within 1e-2 m (PR 5's
  stated float32 limit for SLAM mode), ATE within 0.05 m. Within 20
  frames the VI-BA is not engaged (two-phase: 20 keyframes), so this holds
  the wiring, the pending prior left untouched and the window BA's
  result discarded alike (measured: positions equal to 1.4e-7 m).
- GT scale (the VI-BA engaged from the first frame), with the window LM
  capped at 4 iterations (the default 12 parts the runs from frame 2): a
  window with only slot 0 fixed (either gauge until the marg prior is
  active) drifts along a weak direction in both packages, past ~4 LM
  iterations on one refine and over the frames at any count (at 4 the runs
  part from frame 7). So frames 1-6, where the in-step refine is kept from
  frame 2, are held frame by frame: latches equal, positions within 2e-4 m
  (measured 6.2e-5 m on an AVX-512 host, 8.3e-5 m under AVX2; the
  reference moves by up to 6.7e-4 m on frame 1 and 6.4e-2 m by frame 5
  under a 1-ulp change of its IMU samples, 8 draws; a refine whose gravity
  has the wrong sign, rejected every time, moves frame 2 by 5.3e-4 m and
  frames 4-6 by 1.9e-3 to 2.7e-3 m). The whole run is held on the
  trajectory: the port's ATE under 0.5 m and within 0.05 m of the
  reference's (measured 0.024 / 0.019 m apart on an AVX-512 host, 0.029 /
  0.038 m under AVX2, marg / oldest2), keyframes equal on at least 60% of
  the frames (was 80% at 12 iterations; measured 80% / 85% on an AVX-512
  host, 70% / 75% under AVX2; the reference's own keyframes agree with
  its unchanged run's on as few as 70% / 65% under a 1-ulp IMU change at
  4 iterations, 8 draws, and 60% is that times about 0.9), and under marg
  the prior active by the last frame in both.
"""

import numpy as np
import pytest
import torch

from test_torch_gtfree import ate, hold_frame_by_frame, run_both
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

torch.set_num_threads(2)
N = 21              # frames 1-20


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=N, n_landmarks=300, seed=0))


@pytest.mark.parametrize("gauge", ["marg", "oldest2"])
def test_gt_free_slam_step_matches_reference(seq, gauge):
    (jr, jstate, _), (tr, tstate, _) = run_both(
        seq, N, vi_factors=True, refine_in_step=True, online_gauge=gauge)
    hold_frame_by_frame(jr, tr, seq, max_ate=0.5)
    assert not tr[-1]["engaged"]
    np.testing.assert_array_equal(tstate.marg_pend_H.numpy(), np.asarray(jstate.marg_pend_H))


@pytest.mark.parametrize("gauge", ["marg", "oldest2"])
def test_gt_scale_slam_tracks_reference(seq, gauge):
    (jr, jstate, _), (tr, tstate, _) = run_both(
        seq, N, gt_scale=True, vi_factors=True, refine_in_step=True, online_gauge=gauge,
        lm_iters=4)
    hold_frame_by_frame(jr[:6], tr[:6], seq, atol_p=2e-4, max_ate=0.5)
    a_j, a_t = ate(jr, seq), ate(tr, seq)
    assert a_t < 0.5 and abs(a_t - a_j) < 0.05, (a_j, a_t)
    assert np.mean([x["kf"] == y["kf"] for x, y in zip(jr, tr)]) >= 0.6
    assert np.isfinite([r["p"] for r in tr]).all()
    if gauge == "marg":
        assert float(torch.trace(tstate.marg_H)) > 1e-6 and float(np.trace(jstate.marg_H)) > 1e-6
