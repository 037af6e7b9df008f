"""vislam_tpu_torch against vislam_tpu: the evaluation layer, `eval/runner.py`
(`run_vio_sequence`), `eval/matchability.py` and `viz/`.

Tolerances, each with what was measured when written:
- `run_vio_sequence`, 20 synthetic frames, float32 image pipeline, the
  port fed the reference's RANSAC draws (tests/test_torch_engine.py): GT
  scale, poses within 2e-3 m and the ATEs within 2e-3 m (that file's
  frame-by-frame bound); GT-free, poses within 1e-2 m and the ATEs within
  0.05 m (tests/test_torch_gtfree.py's bounds);
- `repo_match_pairs` on the reference tests' 6-frame `natural` and
  `repetitive` sequences at 376x240 (tests/test_adversarial.py), float32
  pipeline (with the default bf16 one the two detectors' responses differ
  by design, tests/test_torch_engine.py): per pair the same matches, as
  sets of (uv_a, uv_b) each within 1e-2 px of its twin (float32 round-off
  of the subpixel refinement, tests/test_torch_variants_frontend.py), and
  `score_pairs` rows equal (counts exactly, the mean pixel error within
  1e-3 px);
- the plots and `LiveViz` as tests/test_aux.py holds the reference's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_engine import _noises
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.data.adversarial import make_adversarial_sequence as j_make_adversarial
from vislam_tpu.data.adversarial import presets as j_presets
from vislam_tpu.data.synthetic import synthetic_calib as j_calib
from vislam_tpu.eval import run_vio_sequence as j_run_vio_sequence
from vislam_tpu.eval.matchability import opencv_match_pairs as j_opencv_match_pairs
from vislam_tpu.eval.matchability import repo_match_pairs as j_repo_match_pairs
from vislam_tpu.eval.matchability import score_pairs as j_score_pairs
from vislam_tpu.utils.config import FrontendConfig as JFrontend
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.data.adversarial import make_adversarial_sequence as t_make_adversarial
from vislam_tpu_torch.data.adversarial import presets as t_presets
from vislam_tpu_torch.data.synthetic import synthetic_calib as t_calib
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.eval import run_vio_sequence as t_run_vio_sequence
from vislam_tpu_torch.eval.matchability import repo_match_pairs as t_repo_match_pairs
from vislam_tpu_torch.eval.matchability import score_pairs as t_score_pairs
from vislam_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)
N = 21              # frames 1-20


def _f32(cfg):
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 image_dtype="float32"))


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=N, n_landmarks=300, seed=3))


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's step fed the reference's RANSAC draws of the same frame."""
    plain = TEngine.step

    def step(self, state, image, imu, imu_dt, gt_t_norm=-1.0):
        return plain(self, state, image, imu, imu_dt, gt_t_norm, *_noises(self._step_counter))

    monkeypatch.setattr(TEngine, "step", step)


@pytest.mark.parametrize("gt_scale,atol,ate_tol", [(True, 2e-3, 2e-3), (False, 1e-2, 0.05)],
                         ids=["gt_scale", "gt_free"])
def test_run_vio_sequence_matches_reference(seq, reference_draws, gt_scale, atol, ate_tol):
    j = j_run_vio_sequence(seq, _f32(JSystem()), gt_scale=gt_scale)
    t = t_run_vio_sequence(seq, _f32(tconfig.SystemConfig()), gt_scale=gt_scale, device="cpu")
    assert t["poses"].shape == j["poses"].shape == (N - 1, 3)
    np.testing.assert_array_equal(t["gt"], j["gt"])
    np.testing.assert_allclose(t["poses"], j["poses"], atol=atol)
    assert abs(t["ate"] - j["ate"]) < ate_tol and t["ate"] < 0.5, (j["ate"], t["ate"])
    assert int(t["state"].frame_idx) == N - 1


def test_run_vio_sequence_options(seq, reference_draws):
    """online_ba (refine_window after each keyframe), vi_factors and
    init_bias are applied: the run differs from the plain one where the
    window refine ran, the biases start at zero, and the poses stay finite
    and on the reference's trajectory (ATE within 0.05 m)."""
    cfg = _f32(tconfig.SystemConfig())
    plain = t_run_vio_sequence(seq, cfg, n_frames=12, device="cpu")
    t = t_run_vio_sequence(seq, cfg, online_ba=True, vi_factors=False, init_bias=True,
                           n_frames=12, device="cpu")
    j = j_run_vio_sequence(seq, _f32(JSystem()), online_ba=True, vi_factors=False,
                           init_bias=True, n_frames=12)
    assert t["poses"].shape == (11, 3) and np.isfinite(t["poses"]).all()
    assert not np.array_equal(t["poses"], plain["poses"])
    assert abs(t["ate"] - j["ate"]) < 0.05, (j["ate"], t["ate"])


def test_run_vio_sequence_refuses_a_missing_card(seq):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_run_vio_sequence(seq, n_frames=3)


def _adversarial(name):
    j = j_make_adversarial(dataclasses.replace(j_presets()[name], n_frames=6),
                           j_calib(376, 240))
    t = t_make_adversarial(dataclasses.replace(t_presets()[name], n_frames=6),
                           t_calib(376, 240))
    return j, t


@pytest.fixture(scope="module")
def adversarial():
    return {name: _adversarial(name) for name in ("natural", "repetitive")}


# Three of scripts/eval_matchability.py's frontend rows and the grid
# dedup: (frontend overrides, gate_px, grid_dedup).
ROWS = {
    "default": ({}, 0.0, False),
    "dog_guided": (dict(detector="dog"), 30.0, False),
    "fast_brief": (dict(detector="fast", descriptor="brief"), 0.0, False),
    "default_dedup": ({}, 0.0, True),
}


def _same_pairs(tp, jp, tol=1e-2):
    """Per pair, the same matches as sets of (uv_a, uv_b) within tol px."""
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert (a["i"], a["j"]) == (b["i"], b["j"])
        assert len(a["uv_a"]) == len(b["uv_a"]), (a["i"], len(a["uv_a"]), len(b["uv_a"]))
        x = np.concatenate([a["uv_a"], a["uv_b"]], -1)
        y = np.concatenate([b["uv_a"], b["uv_b"]], -1)
        d = np.abs(x[:, None, :] - y[None, :, :]).max(-1)
        assert (d.min(1) < tol).all() and (d.min(0) < tol).all(), d.min(1).max()


@pytest.mark.parametrize("name", ["natural", "repetitive"])
@pytest.mark.parametrize("row", sorted(ROWS))
def test_repo_match_pairs_matches_reference(adversarial, name, row):
    over, gate_px, dedup = ROWS[row]
    jseq, tseq = adversarial[name]
    jp = j_repo_match_pairs(jseq, JFrontend(image_dtype="float32", **over), gate_px=gate_px,
                            grid_dedup=dedup)
    tp = t_repo_match_pairs(tseq, tconfig.FrontendConfig(image_dtype="float32", **over),
                            gate_px=gate_px, grid_dedup=dedup, device="cpu")
    _same_pairs(tp, jp)
    js = j_score_pairs(jseq["scene"], jp, name=row)
    ts = t_score_pairs(tseq["scene"], tp, name=row)
    for k in ("n_pairs", "matches_per_pair", "inliers_per_pair", "inlier_rate"):
        assert getattr(ts, k) == getattr(js, k), k
    assert abs(ts.mean_px_err - js.mean_px_err) < 1e-3
    assert ts.row() == js.row()
    if dedup:
        assert ts.matches_per_pair <= 49


def test_score_pairs_equals_reference_on_the_same_pairs(adversarial):
    """The port's scorer on the reference's own pairs gives its result."""
    jseq, tseq = adversarial["repetitive"]
    jp = j_repo_match_pairs(jseq, JFrontend(detector="dog"), gate_px=30.0)
    assert (dataclasses.asdict(t_score_pairs(tseq["scene"], jp))
            == dataclasses.asdict(j_score_pairs(jseq["scene"], jp)))


def test_natural_parity_vs_opencv_sift(adversarial):
    """tests/test_adversarial.py's parity, the port's default frontend (bf16
    pipeline) against the reference's OpenCV SIFT row: at least as many
    matches per pair, the inlier rate within 3 points and above 0.9."""
    jseq, tseq = adversarial["natural"]
    repo = t_score_pairs(tseq["scene"], t_repo_match_pairs(tseq, device="cpu"))
    sift = j_score_pairs(jseq["scene"], j_opencv_match_pairs(jseq, kind="sift"))
    assert repo.matches_per_pair >= sift.matches_per_pair
    assert repo.inlier_rate >= sift.inlier_rate - 0.03
    assert repo.inlier_rate > 0.9


def test_viz_plots(tmp_path):
    from vislam_tpu_torch.eval import read_trajectory_csv, write_trajectory_csv
    from vislam_tpu_torch.viz import draw_matches, plot_state_comparison, plot_trajectory

    n = 20
    rows = []
    rng = np.random.default_rng(0)
    for j in range(n):
        p = np.array([j * 0.1, np.sin(j * 0.3), 0.0])
        rows.append(dict(
            frame=j, t_ns=int(1e9 * j * 0.05), is_kf=(j % 3 == 0),
            est_p=p + 0.01 * rng.standard_normal(3),
            est_rpy=np.zeros(3), est_q=[1, 0, 0, 0], est_v=np.zeros(3),
            gt_p=p, gt_rpy=np.zeros(3), gt_q=[1, 0, 0, 0], gt_v=np.zeros(3),
        ))
    csv = str(tmp_path / "t.csv")
    write_trajectory_csv(csv, rows)
    traj = read_trajectory_csv(csv)
    p1 = str(tmp_path / "traj.png")
    p2 = str(tmp_path / "state.png")
    plot_trajectory(traj, p1, align=True)
    plot_state_comparison(traj, p2)
    assert os.path.getsize(p1) > 10000
    assert os.path.getsize(p2) > 10000

    img = rng.integers(0, 255, (120, 160), np.uint8).astype(np.float32)
    uv = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    p3 = str(tmp_path / "matches.png")
    draw_matches(img, uv, img, uv + 2, np.ones(30, bool), p3)
    assert os.path.getsize(p3) > 10000


def test_live_viz_snapshots(tmp_path):
    """LiveViz re-renders atomically every N keyframes and on close."""
    from vislam_tpu_torch.viz import LiveViz

    lv = LiveViz(str(tmp_path / "run"), every_kf=2)
    rng = np.random.default_rng(0)
    p = np.zeros(3)
    for j in range(10):
        p = p + rng.normal(0, 0.1, 3)
        lv.update(j, p, p + 0.01, is_keyframe=(j % 2 == 0))
    out = lv.close()
    assert out is not None
    assert os.path.exists(out)
    assert lv._renders >= 3  # periodic renders happened, not just close()
    assert not os.path.exists(str(tmp_path / "run") + "_live.tmp.png")
