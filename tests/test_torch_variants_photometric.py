"""vislam_tpu_torch against vislam_tpu: the photometric refine
(`backend/photometric.py`, `engine.photometric_refine`).

Tolerances, each with what was measured when written:
- `photometric_align` on the reference's two cases
  (tests/test_photometric.py): R within 1e-5, t within 1e-4 m (measured
  7.5e-7 and 7.5e-6: float32 round-off through 40 Gauss-Newton solves),
  the points in view equal, the final error within 3e-3 relative (was
  1e-3: the reference's own final error moves by up to 1.64e-3 relative
  under a 1-ulp change of its two images, 16 random sign patterns, with
  every library limited to AVX2; 1.05e-3 on an AVX-512 host; the port lies
  1.68e-3 from it there; 3e-3 is that spread times about 1.8); and the
  reference's own accuracy bounds hold for the port;
- `_tukey_weights` on odd and even valid counts: 1e-6 (the same median
  element, read at a device index);
- the step on EVAL config 3's sequence (seed 1, 350 landmarks, its
  amplitudes), 16 frames, float32 pipeline, the reference's draws:
  keyframes equal and match counts within 2 on every frame, positions
  within 2.5e-2 m and the ATEs within 5e-3 m of each other. The refine
  amplifies round-off: the reference against itself, its images scaled by
  1 + 2^-22 (two ulps), moves by up to 1.25e-2 m and 25 inliers on this
  sequence (measured when written; the port against the reference: 1.1e-2
  m, 18 inliers), so inlier counts are not compared frame by frame.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsp

from test_photometric import _setup
from test_torch_engine import _f32, _run
from vislam_tpu.backend.photometric import _tukey_weights as j_tukey
from vislam_tpu.backend.photometric import photometric_align as j_align
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.frontend import build_pyramid as j_pyramid
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.backend.photometric import _tukey_weights as t_tukey
from vislam_tpu_torch.backend.photometric import photometric_align as t_align
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.frontend.pyramid import build_pyramid as t_pyramid
from vislam_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# The reference's two cases: seed, rotation and translation perturbation,
# whether 10% of the depths are corrupted x3, and its own accuracy bounds
# (deg, m).
CASES = {
    "perturbation": (20, [0.01, -0.012, 0.008], [0.03, -0.04, 0.02], False, 0.3, 0.02),
    "bad_depths": (21, [0.008, 0.01, -0.006], [-0.03, 0.02, 0.03], True, 0.6, 0.04),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_photometric_align_matches_reference(case):
    seed, drot, dt, corrupt, max_deg, max_m = CASES[case]
    seq, calib, uv, depth, good, R_ji, t_ji = _setup(seed=seed)
    if corrupt:
        rng = np.random.default_rng(0)
        depth = depth.copy()
        depth[rng.choice(len(depth), len(depth) // 10, replace=False)] *= 3.0
    R0 = Rsp.from_rotvec(drot).as_matrix() @ R_ji
    t0 = t_ji + np.array(dt)
    intr = (calib.fx, calib.fy, calib.cx, calib.cy)
    j = j_align(j_pyramid(jnp.asarray(seq["images"][0], jnp.float32), 4),
                j_pyramid(jnp.asarray(seq["images"][1], jnp.float32), 4),
                jnp.asarray(uv, jnp.float32), jnp.asarray(depth), jnp.asarray(good),
                jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32), *intr)
    t = t_align(t_pyramid(_t(seq["images"][0]), 4), t_pyramid(_t(seq["images"][1]), 4),
                _t(uv), _t(depth), torch.from_numpy(good), _t(R0), _t(t0), *intr)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-5)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert int(t.num_valid) == int(j.num_valid) > 100
    assert abs(float(t.final_error) - float(j.final_error)) <= 3e-3 * float(j.final_error)
    rot_err = np.degrees(np.linalg.norm(Rsp.from_matrix(t.R.numpy().T @ R_ji).as_rotvec()))
    assert rot_err < max_deg and np.linalg.norm(t.t.numpy() - t_ji) < max_m


@pytest.mark.parametrize("n_valid", [1, 2, 57, 58])
def test_tukey_weights_match_reference(n_valid):
    """The MAD's median is element (n - 1) // 2 of the valid residuals:
    odd and even counts, one and two valid entries; invalid ones weigh 0."""
    rng = np.random.default_rng(n_valid)
    r = (rng.standard_t(3, 96) * 4.0).astype(np.float32)
    mask = np.zeros(96, bool)
    mask[rng.choice(96, n_valid, replace=False)] = True
    j = np.asarray(j_tukey(jnp.asarray(r), jnp.asarray(mask)))
    t = t_tukey(_t(r), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    assert (t[~mask] == 0).all() and ((t[mask] > 0).any() or n_valid <= 2)


@pytest.fixture(scope="module")
def seq3():
    """EVAL config 3's sequence (scripts/eval_configs.py), cut to 16 frames."""
    return make_synthetic_sequence(SyntheticConfig(
        n_frames=16, n_landmarks=350, seed=1, trans_amp=(2.0, 1.4, 0.7),
        rot_amp=(0.12, 0.15, 0.3)))


def _photometric(cfg):
    return dataclasses.replace(_f32(cfg), engine=dataclasses.replace(
        cfg.engine, photometric_refine=True))


def test_photometric_step_matches_reference(seq3):
    """The step with the photometric refine over 15 frames of config 3's
    sequence: keyframes, counts and positions as the reference's; the
    keyframe image is carried only with the refine on."""
    jr, _, _ = _run(JEngine(seq3["calib"], _photometric(JSystem())), seq3, port=False,
                    n_frames=16)
    eng = TEngine(seq3["calib"], _photometric(tconfig.SystemConfig()), device="cpu")
    tr, state, _ = _run(eng, seq3, port=True, n_frames=16)
    assert [r["kf"] for r in jr] == [r["kf"] for r in tr]
    assert sum(r["kf"] for r in tr) >= 5
    for x, y in zip(jr, tr):
        assert abs(x["nm"] - y["nm"]) <= 2, (x, y)
        np.testing.assert_allclose(y["p"], x["p"], atol=2.5e-2)

    def ate(run):
        return float(np.sqrt(np.mean(np.sum(
            (np.array([r["p"] for r in run]) - seq3["gt_pos"][1:16]) ** 2, -1))))

    assert abs(ate(tr) - ate(jr)) < 5e-3 and ate(tr) < 0.2, (ate(jr), ate(tr))
    last_kf = max(k + 1 for k, r in enumerate(tr) if r["kf"])
    np.testing.assert_array_equal(state.kf_image.numpy(), seq3["images"][last_kf])
