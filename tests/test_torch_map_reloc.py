"""vislam_tpu_torch against vislam_tpu: relocalization
(`attempt_relocalization`) on the reference tests' archive
(`tests/test_reloc.py::_gt_record`: GT poses and the reference's features
of every 3rd frame up to 27 of the 40-frame seed-0 sequence), the live
frame's features the reference's too.

Tolerances. The candidates come from the same global descriptors (float32
round-off, 1e-5); the metric measurement's match counts can differ by a
near-tied ratio test, which moves the PnP solution by ~1e-4: the same
keyframe, success and inliers within 2; the pose within 1e-3 (m, rotation
entries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_reloc import _gt_record
from vislam_tpu.backend.reloc import attempt_relocalization as j_reloc
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.frontend.features import extract_features as j_extract
from vislam_tpu.utils.config import FrontendConfig
from vislam_tpu_torch.backend.reloc import attempt_relocalization as t_reloc
from vislam_tpu_torch.backend.trajectory_opt import KeyframeRecord

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gt_archive():
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=40, n_landmarks=300, seed=0))
    return seq, [_gt_record(seq, j) for j in range(0, 30, 3)]


def _live(image):
    f = j_extract(jnp.asarray(image, jnp.float32), FrontendConfig())
    return np.array(f.uv), np.array(f.desc), np.array(f.mask)


def _both(live, archive, calib):
    c = (calib.fx, calib.fy, calib.cx, calib.cy)
    j = j_reloc(*live, archive, *c)
    t = t_reloc(*[torch.from_numpy(x) for x in live], [KeyframeRecord(*k) for k in archive],
                *c, device="cpu")
    return j, t


@pytest.mark.parametrize("j_live", [20, 33])
def test_relocalization_matches_reference(gt_archive, j_live):
    """A held-out frame (20: between keyframes 18 and 21; 33: past the
    archive's end): the reference's keyframe, pose and gates, within
    centimetres of GT."""
    seq, archive = gt_archive
    j, t = _both(_live(seq["images"][j_live]), archive, seq["calib"])
    assert j.success and t.success
    assert t.kf_index == j.kf_index
    assert abs(t.n_inliers - j.n_inliers) <= 2
    np.testing.assert_allclose(t.p_wc, j.p_wc, atol=1e-3)
    np.testing.assert_allclose(t.R_wc, j.R_wc, atol=1e-3)
    assert t.R_wc.dtype == np.float32 and t.p_wc.dtype == np.float32
    assert np.linalg.norm(t.p_wc - seq["gt_pos"][j_live]) < 0.05


def test_relocalization_rejects_unseen_place_and_short_archive(gt_archive):
    """Pure noise does not relocalize (no false positive); an archive of one
    keyframe is refused before any work, as in the reference."""
    seq, archive = gt_archive
    noise = np.random.default_rng(7).uniform(0, 255, seq["images"][0].shape).astype(np.uint8)
    j, t = _both(_live(noise), archive, seq["calib"])
    assert not j.success and not t.success
    assert (t.kf_index, t.n_inliers, t.R_wc) == (-1, 0, None)
    j, t = _both(_live(seq["images"][20]), archive[:1], seq["calib"])
    assert tuple(t) == tuple(j)
