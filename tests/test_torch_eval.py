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
- the plots and `LiveViz` as tests/test_aux.py holds the reference's;
- the port's EVAL harness (`scripts/torch_eval_configs.py`) against the
  reference harness (`scripts/eval_configs.py::run_vio` with the same
  options, config 5 against `scripts/eval_reference_spread.py::run_batch`,
  the lines of that harness's main()), each on its pinned sequence cut to
  12 frames (the VI-BA under the marg gauge 30: GT-free, the window stays
  inert until the promotion deadline engages it at frame 28; config 4 all
  86, its loop closes at frame 80), float32 pipeline, the reference's
  draws: positions and ATE within 1e-4 m for the unsupervised open loop,
  the vision-only online BA and the marg VI-BA (measured 5.5e-7, 3.4e-7
  and 2.7e-6 m; the port's marg run under the ends gauge, or without the
  VI-BA, parts from the reference's by 6.6e-2 m), each runner's
  refine_window calls counted (one per keyframe promotion with the
  online BA or the VI-BA, else none), the photometric refine as
  tests/test_torch_variants_photometric.py holds it (positions 2.5e-2 m,
  ATEs 5e-3 m; measured 1.1e-2 m), config 5 at B = 2 positions and ATEs
  within 1e-4 m (measured 1.6e-6 and 3e-7 m), config 4 in the docstring of
  its test.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import _noises
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.data.adversarial import make_adversarial_sequence as j_make_adversarial
from vislam_tpu.data.adversarial import presets as j_presets
from vislam_tpu.data.synthetic import synthetic_calib as j_calib
from vislam_tpu.eval import ate_rmse
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import eval_configs as j_harness             # noqa: E402  (the reference's EVAL harness)
import eval_reference_spread as j_spread     # noqa: E402
import torch_eval_configs as t_harness       # noqa: E402  (the port's)

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


RUNNER_FRAMES = 12


def _cut(seq, n):
    """The first n frames of a sequence dict (and their IMU samples)."""
    out = dict(seq)
    for k in ("images", "gt_pos", "gt_quat", "gt_vel"):
        out[k] = seq[k][:n]
    for k in ("imu_gyro", "imu_accel"):
        out[k] = seq[k][:(n - 1) * 10]
    return out


def _both(**sections):
    """(reference, port) SystemConfig with the float32 pipeline and the
    given sections' fields replaced."""
    out = []
    for c in (JSystem(), tconfig.SystemConfig()):
        fe = dict(sections.get("frontend", {}), image_dtype="float32")
        out.append(dataclasses.replace(c, frontend=dataclasses.replace(c.frontend, **fe), **{
            k: dataclasses.replace(getattr(c, k), **v) for k, v in sections.items()
            if k != "frontend"}))
    return out


@pytest.fixture(scope="module")
def pinned():
    """EVAL configs 2 and 3's pinned sequences."""
    return {name: make_synthetic_sequence(SyntheticConfig(**t_harness.SEQUENCES[name]))
            for name in ("2", "3")}


# sequence, config sections, run_vio options, frames, position and ATE bounds
OPTIONS = {
    "unsupervised_open_loop": ("2", dict(engine=dict(vi_align_bootstrap=False)),
                               dict(gt_scale=False), RUNNER_FRAMES, 1e-4, 1e-4),
    "online_ba": ("3", {}, dict(gt_scale=True, ba=True), RUNNER_FRAMES, 1e-4, 1e-4),
    "vi_ba_marg": ("3", dict(backend=dict(online_gauge="marg")),
                   dict(gt_scale=False, vi_ba=True), 30, 1e-4, 1e-4),
    "photometric": ("3", {}, dict(gt_scale=True, photometric=True), RUNNER_FRAMES, 2.5e-2,
                    5e-3),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_eval_runner_option_matches_reference(pinned, reference_draws, monkeypatch, option):
    """The port harness's run_vio option (`_vio`) against the reference
    harness's run_vio with the same options and configuration, and the
    port's window refine run once per keyframe promotion where the option
    asks for it (online BA at GT scale is neutral to ~1e-6 m, so the
    positions alone would not see it dropped)."""
    from vislam_tpu_torch.engine import refine

    name, sections, opts, n, atol, ate_tol = OPTIONS[option]
    seq = _cut(pinned[name], n)
    jcfg, tcfg = _both(**sections)
    j = j_harness.run_vio(seq, cfg=jcfg, **opts)
    calls = []
    plain = refine.refine_window
    monkeypatch.setattr(refine, "refine_window", lambda *a, **k: calls.append(1) or plain(*a, **k))
    t = t_harness._vio(seq, "cpu", 0, cfg=tcfg, **opts)
    promotions = int(t["state"].kf_count) - 1
    assert promotions >= 1
    assert len(calls) == (promotions if opts.get("ba") or opts.get("vi_ba") else 0)
    assert t["poses"].shape == j["poses"].shape == (n - 1, 3)
    np.testing.assert_allclose(t["poses"], j["poses"], atol=atol)
    a_j = float(ate_rmse(j["poses"], j["gt"], align=False))
    assert abs(t["ate"] - a_j) < ate_tol and t["ate"] < 0.5, (a_j, t["ate"])


def test_eval_loop_correction_matches_reference(reference_draws):
    """Config 4 (seed 21, 86 frames), GT scale, every keyframe archived,
    then correct_trajectory (min_separation 10, sim_thresh 0.80,
    min_inliers 25): the port's run_loop against the reference harness's
    run_vio(loop_correct=True). The same loops (archive index pairs and
    inlier counts), positions within 5e-2 m (measured
    1.33e-2 m at frame 18: over 85 frames float32 round-off parts the two
    runs by more than the 2e-3 m that holds frame by frame), and the
    keyframes' largest error before and after the correction within 1e-3
    m (measured 9.2e-5 and 1.9e-4 m)."""
    seq = make_synthetic_sequence(SyntheticConfig(**t_harness.SEQUENCES["4"]))
    jcfg, tcfg = _both()
    j = j_harness.run_vio(seq, cfg=jcfg, gt_scale=True, loop_correct=True)
    t = t_harness.run_loop(seq, "cpu", 0, cfg=tcfg)
    np.testing.assert_allclose(t["poses"], j["poses"], atol=5e-2)
    assert t["loops"] == [tuple(x) for x in j["loops"]] and len(t["loops"]) >= 1
    assert t["n_loops"] == len(j["loops"])
    assert abs(t["kf_maxerr_before"] - j["kf_err_before"]) < 1e-3
    assert abs(t["kf_maxerr_after"] - j["kf_err_after"]) < 1e-3
    assert t["kf_maxerr_after"] < t["kf_maxerr_before"]


def test_eval_batch_runner_matches_reference():
    """Config 5's runner at B = 2 (its pinned sequences of seeds 0 and 1,
    cut to 12 frames) against the reference's batch (scripts/
    eval_reference_spread.py::run_batch, the lines of scripts/
    eval_configs.py's main()), the port fed the reference's draws (entry
    b's frame n: fold_in(split(PRNGKey(0), 2)[b], n), as
    tests/test_torch_batch.py feeds them)."""
    from test_torch_engine import _jax_noise

    seqs = [_cut(make_synthetic_sequence(SyntheticConfig(**t_harness.SEQUENCES["5"], seed=b)),
                 RUNNER_FRAMES) for b in range(2)]
    jcfg, tcfg = _both()
    j = j_spread.run_batch(seqs, 0, cfg=jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    noises = [[(_jax_noise(k, 768), _jax_noise(jax.random.fold_in(k, 7), 768))
               for k in (jax.random.fold_in(keys[b], n) for n in range(RUNNER_FRAMES - 1))]
              for b in range(2)]
    t = t_harness.run_batch(seqs, "cpu", 0, cfg=tcfg, noises=noises)
    assert t["poses"].shape == j["poses"].shape == (2, RUNNER_FRAMES - 1, 3)
    np.testing.assert_allclose(t["poses"], j["poses"], atol=1e-4)
    for k in ("ate_mean", "ate_max"):
        assert abs(t[k] - j[k]) < 1e-4 and t[k] < 0.5, (k, j[k], t[k])
