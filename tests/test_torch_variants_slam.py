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
  frame 2, are held frame by frame: latches equal, and each frame's
  position within a bound the test derives on the host that runs it:
  SPREAD_MULTIPLE (4) times the largest move of the port's own position on
  that frame under ULP_DRAWS (4) 1-ulp changes of its IMU samples (random
  signs), floored at 1e-5 m and capped at 3e-4 m (SPREAD_CAP: a refine
  that turns chaotic widens the port's own spread, and must fail rather
  than loosen its bound; the reference's own 1-ulp spread, 6.7e-4 m on
  frame 1 and more later, would only raise every frame to the cap). It
  was a fixed 2e-4 m, against 6.2e-5 m
  measured on one AVX-512 host and 8.3e-5 m under AVX2, and 6.9e-5 m on
  another AVX-512 host (Intel Xeon): a margin under 3x. Measured on that
  host: gaps per frame 3.8e-6, 6.4e-5, 5.9e-5, 6.7e-5, 6.6e-5, 6.9e-5 m
  (marg and oldest2 alike: the prior is empty on these frames) against
  the port's spreads 2.9e-6, 7.9e-5, 6.9e-5, 1.05e-4, 1.04e-4, 1.02e-4 m
  (at most 1.3 times it, on frame 1; bounds 1.2e-5 m on frame 1, 2.8e-4
  on frame 3 and the cap on the others); under AVX2 (ATEN_CPU_CAPABILITY=avx2
  MKL_ENABLE_INSTRUCTIONS=AVX2 OPENBLAS_CORETYPE=Haswell
  XLA_FLAGS=--xla_cpu_max_isa=AVX2) gaps 3.3e-6, 8.9e-6, 8.8e-6, 3.4e-6,
  4.2e-6, 4.8e-7 m against spreads 5.8e-6, 5.4e-5, 5.1e-5, 8.4e-5,
  8.4e-5, 1.3e-4 m. A refine whose gravity has the wrong sign, rejected every
  time, moves frame 2 by 5.3e-4 m and frames 4-6 by 1.9e-3 to 2.7e-3 m.
  The whole run is held on the
  trajectory: the port's ATE under 0.5 m and within 0.05 m of the
  reference's (measured 0.024 / 0.019 m apart on an AVX-512 host, 0.029 /
  0.038 m under AVX2, marg / oldest2), keyframes equal on at least 60% of
  the frames (was 80% at 12 iterations; measured 80% / 85% on an AVX-512
  host, 70% / 75% under AVX2; the reference's own keyframes agree with
  its unchanged run's on as few as 70% / 65% under a 1-ulp IMU change at
  4 iterations, 8 draws, and 60% is that times about 0.9), and under marg
  the prior active by the last frame in both.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_gtfree import ate, hold_frame_by_frame, run_both
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from eval_reference_spread import perturbed  # noqa: E402  (1-ulp IMU changes, rng(draw))

torch.set_num_threads(2)
N = 21              # frames 1-20
HELD = 6            # frames held frame by frame at GT scale
ULP_DRAWS = 4
SPREAD_MULTIPLE = 4.0
SPREAD_FLOOR = 1e-5         # m
SPREAD_CAP = 3e-4           # m


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
    p = np.array([r["p"] for r in tr[:HELD]])
    spread = np.max([np.abs(np.array([r["p"] for r in run_both(
        perturbed(seq, d), HELD + 1, gt_scale=True, ports=(True,), vi_factors=True,
        refine_in_step=True, online_gauge=gauge, lm_iters=4)[0][0]]) - p).max(-1)
        for d in range(1, ULP_DRAWS + 1)], axis=0)
    bound = np.clip(SPREAD_MULTIPLE * spread, SPREAD_FLOOR, SPREAD_CAP)
    hold_frame_by_frame(jr[:HELD], tr[:HELD], seq, atol_p=bound, max_ate=0.5)
    a_j, a_t = ate(jr, seq), ate(tr, seq)
    assert a_t < 0.5 and abs(a_t - a_j) < 0.05, (a_j, a_t)
    assert np.mean([x["kf"] == y["kf"] for x, y in zip(jr, tr)]) >= 0.6
    assert np.isfinite([r["p"] for r in tr]).all()
    if gauge == "marg":
        assert float(torch.trace(tstate.marg_H)) > 1e-6 and float(np.trace(jstate.marg_H)) > 1e-6
