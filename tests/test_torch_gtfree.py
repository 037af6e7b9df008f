"""vislam_tpu_torch against vislam_tpu: GT-free (IMU-scale) supervision,
the linear VI alignment (`inertial/vi_align.py`) and its application to
the window (`engine/bootstrap.py`), and the GT-free open loop end to end.

Runs are stepped as tests/test_torch_engine.py steps them: the port is fed
the reference's own RANSAC draws, and the frame-by-frame runs use the
float32 image pipeline (with the default bf16 one the two frontends differ
by design, and keyframes drift apart within a few frames; see that file).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _imu, _noises
from test_vi_align import _window as _align_window
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.engine.bootstrap import vi_align_window as j_vi_align_window
from vislam_tpu.inertial.vi_align import refine_gravity as j_refine_gravity
from vislam_tpu.inertial.vi_align import vi_align as j_vi_align
from vislam_tpu.inertial.vi_align import vi_align_fixed_gravity as j_vi_align_fixed_gravity
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.engine import make_sequence_inputs, run_sequence_scan
from vislam_tpu_torch.engine.bootstrap import vi_align_window as t_vi_align_window
from vislam_tpu_torch.eval import ate_rmse
from vislam_tpu_torch.inertial.vi_align import refine_gravity as t_refine_gravity
from vislam_tpu_torch.inertial.vi_align import vi_align as t_vi_align
from vislam_tpu_torch.inertial.vi_align import vi_align_fixed_gravity as t_vi_align_fixed_gravity
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)
LATCHES = ("kf", "aligned", "engaged", "applies")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def configure(cfg, f32=True, **backend):
    """cfg with the float32 image pipeline and backend overrides."""
    fe = dataclasses.replace(cfg.frontend, image_dtype="float32") if f32 else cfg.frontend
    return dataclasses.replace(cfg, frontend=fe,
                               backend=dataclasses.replace(cfg.backend, **backend))


def run_both(seq, n, f32=True, cold=False, gt_scale=False, keep_state_at=None,
             ports=(False, True), **backend):
    """Step the reference and the port (`ports`: which of the two, False the
    reference) over frames 1..n-1 of seq from the same start; returns
    ((records, final state, kept state) per package). A record holds p_wc,
    the keyframe flag and the state's latches."""
    out = []
    for port in ports:
        cfg = configure((tconfig.SystemConfig if port else JSystem)(), f32, **backend)
        eng = TEngine(seq["calib"], cfg, device="cpu") if port else JEngine(seq["calib"], cfg)
        state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                               v_w0=np.zeros(3) if cold else seq["gt_vel"][0],
                               p_w0=seq["gt_pos"][0])
        recs, kept, last_kf = [], None, 0
        for j in range(1, n):
            imu, dt = _imu(seq, j)
            g = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf])) \
                if gt_scale else -1.0
            draws = _noises(j - 1) if port else ()
            state, res = eng.step(state, seq["images"][j], imu, dt, g, *draws)
            if bool(res.is_keyframe):
                last_kf = j
            recs.append(dict(p=np.asarray(res.p_wc), kf=bool(res.is_keyframe),
                             aligned=bool(state.vi_aligned), engaged=bool(state.vi_engaged),
                             applies=int(state.bootstrap_applies),
                             shadow=np.asarray(state.shadow_p_wc), scale=float(state.shadow_scale)))
            if j == keep_state_at:
                kept = state
        out.append((recs, state, kept))
    return out


def ate(recs, seq):
    poses = np.array([seq["gt_pos"][0]] + [r["p"] for r in recs])
    return ate_rmse(poses, seq["gt_pos"][:len(poses)], align=False)


def hold_frame_by_frame(jr, tr, seq, atol_p=1e-2, max_ate=0.4):
    """Latches equal on every frame (a flip is reported with its frame),
    positions within atol_p, ATE within 0.05 m of the reference's and under
    max_ate. atol_p is one bound or one per frame."""
    for k, (x, y) in enumerate(zip(jr, tr)):
        flips = [f"{name} {x[name]} vs {y[name]}" for name in LATCHES if x[name] != y[name]]
        assert not flips, f"frame {k + 1}: " + ", ".join(flips)
    dps = np.array([np.abs(x["p"] - y["p"]).max() for x, y in zip(jr, tr)])
    assert (dps <= atol_p).all(), (dps, atol_p)
    dp = dps.max()
    a_j, a_t = ate(jr, seq), ate(tr, seq)
    assert a_t < max_ate and abs(a_t - a_j) < 0.05, (a_j, a_t)
    return dp, a_j, a_t


@pytest.fixture(scope="module")
def seq40():
    return make_synthetic_sequence(SyntheticConfig(n_frames=40, n_landmarks=300, seed=0))


@pytest.mark.parametrize("fixed_gravity", [False, True])
def test_vi_align_matches_reference(fixed_gravity):
    """The alignment of a 12-keyframe window of exact preintegrated factors
    (tests/test_vi_align.py), two intervals masked out. The normal
    equations (3K + 4 unknowns, 1e-8 ridge) are solved in float32 by
    another LU: scale, gravity and velocities agree to 1e-4 relative /
    1e-4 absolute (measured 2e-6 / 8e-6), the residual to 1e-3 relative."""
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=60, n_landmarks=10, seed=2))
    ks = list(range(0, 56, 5))
    R_wb, dv, dp, dt = _align_window(seq, None, ks)
    pbar = (np.stack([seq["gt_pos"][k] for k in ks]) / 3.7).astype(np.float32)
    mask = np.ones(len(ks) - 1, bool)
    mask[[3, 7]] = False
    g_w = np.array([0.0, 0.0, -9.81], np.float32)
    args = (R_wb, pbar, dv, dp, dt.astype(np.float32))
    if fixed_gravity:
        j = j_vi_align_fixed_gravity(*map(jnp.asarray, args), jnp.asarray(g_w),
                                     mask=jnp.asarray(mask))
        t = t_vi_align_fixed_gravity(*map(_t, args), _t(g_w), mask=torch.from_numpy(mask))
    else:
        j = j_refine_gravity(j_vi_align(*map(jnp.asarray, args), mask=jnp.asarray(mask)))
        t = t_refine_gravity(t_vi_align(*map(_t, args), mask=torch.from_numpy(mask)))
    assert abs(float(j.scale) - 3.7) < 0.1
    for name in ("scale", "gravity", "velocities"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(t.residual) == pytest.approx(float(j.residual), rel=1e-3)


def test_vi_align_singular_system_is_non_finite():
    """An all-NaN window: the reference's solve returns non-finite values,
    which its gates reject; the port's solve_ex does the same, no raise."""
    K = 5
    nan = np.full((K - 1, 3), np.nan, np.float32)
    args = (np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), np.zeros((K, 3), np.float32),
            nan, nan, np.full(K - 1, np.nan, np.float32))
    t = t_vi_align_fixed_gravity(*map(_t, args), _t([0, 0, -9.81]))
    j = j_vi_align_fixed_gravity(*map(jnp.asarray, args), jnp.asarray([0, 0, -9.81]))
    assert not np.isfinite(np.asarray(j.scale)) and not torch.isfinite(t.scale)


@pytest.fixture(scope="module")
def open_loop(seq40):
    """The warm GT-free open loop over 40 frames (tests/test_vi_mode.py:48),
    and the reference's state after frame 14, the first healthy keyframe."""
    return run_both(seq40, 40, keep_state_at=14)


@pytest.mark.parametrize("corrupt", [False, True])
def test_vi_align_window_from_reference_state(open_loop, seq40, corrupt):
    """vi_align_window on the reference's state after frame 14 (converted),
    its latch cleared: as it is (healthy: vi_aligned latches, nothing
    applied), and with the window's velocities halved (inconsistent: the
    fit re-anchors positions and velocities). Outcomes equal; positions and
    velocities to 1e-4 m (float32 solve of the same normal equations)."""
    (_, _, jstate), _ = open_loop
    tree = jax.tree.map(np.asarray, jstate)
    tree = tree._replace(vi_aligned=np.asarray(False))
    if corrupt:
        tree = tree._replace(window=tree.window._replace(v_w=0.5 * tree.window.v_w),
                             v_w=0.5 * tree.v_w)
    R_bc = np.asarray(seq40["calib"].T_body_cam[:3, :3], np.float32)
    kw = dict(min_factors=4, min_excitation=0.5, engage_min_excitation=1.5)
    j = jax.tree.map(np.asarray, j_vi_align_window(jax.tree.map(jnp.asarray, tree), R_bc,
                                                   9.81, **kw))
    t = state_to_numpy(t_vi_align_window(state_from_numpy(tree, "cpu"), _t(R_bc), 9.81, **kw))
    assert bool(j.vi_aligned) == bool(t.vi_aligned) == (not corrupt)
    assert int(j.bootstrap_applies) == int(t.bootstrap_applies) == int(corrupt)
    assert bool(j.vi_engaged) == bool(t.vi_engaged)
    for a, b in ((j.window.t_cw, t.window.t_cw), (j.window.v_w, t.window.v_w),
                 (j.p_wc, t.p_wc), (j.kf_p_wc, t.kf_p_wc), (j.v_w, t.v_w)):
        np.testing.assert_allclose(b, a, atol=1e-4)


def test_gt_free_open_loop_matches_reference_frame_by_frame(open_loop, seq40):
    """Warm start, 40 frames: keyframes, vi_aligned, vi_engaged and the
    apply count equal on every frame; positions within 1e-2 m (measured
    2.3e-5: float32 round-off through 39 IMU-scaled compositions); ATE
    within 0.05 m of the reference's and under the reference test's 0.4 m
    (measured 0.1211 both)."""
    (jr, _, _), (tr, tstate, _) = open_loop
    hold_frame_by_frame(jr, tr, seq40)
    assert tr[-1]["aligned"] and not tr[-1]["engaged"]
    assert tstate.p_wc.device.type == "cpu"


def test_gt_free_cold_start_matches_reference_frame_by_frame(seq40):
    """Cold start (v0 = 0, the true v0 is ~1.8 m/s), 30 frames: the
    alignment re-anchors (one full apply, at frame 13), on the same frames
    in both packages, and every latch agrees. Positions within 2e-2 m
    (measured 1.04e-2 at frame 29): the shadow chain's depth ratios, from
    near-parallel rays at 0.5-1 cm baselines, amplify float32 round-off
    (the chain scale is 2e-5 relative apart after frame 2, 0.5% by frame
    13, in both packages' own arithmetic), and the cold-start fit scales
    the shadow track by s = 16.8, so the 8e-5 m of shadow difference
    becomes 6.9e-3 m at the apply."""
    (jr, _, _), (tr, _, _) = run_both(seq40, 30, cold=True)
    assert jr[-1]["applies"] > 0
    hold_frame_by_frame(jr, tr, seq40, atol_p=2e-2, max_ate=2.0)


def test_gt_free_sequence_scan_equals_step_loop(seq40):
    """run_sequence_scan over GT-free inputs draws what a loop of GT-free
    steps draws and returns the same frames."""
    n = 8
    eng = TEngine(seq40["calib"], device="cpu")

    def init():
        return eng.initialize(seq40["images"][0], q_wb0=seq40["gt_quat"][0],
                              v_w0=seq40["gt_vel"][0], p_w0=seq40["gt_pos"][0])

    inputs = make_sequence_inputs(seq40, 1, n + 1, use_gt_scale=False, device="cpu")
    state_s, res_s = run_sequence_scan(eng, init(), inputs)
    state = init()
    for k in range(n):
        state, res = eng.step(state, inputs.images[k], inputs.imu[k], inputs.imu_dt[k], -1.0)
        assert bool(res.is_keyframe) == bool(res_s.is_keyframe[k])
        assert torch.equal(res.p_wc, res_s.p_wc[k])
    assert torch.equal(state.window.v_w, state_s.window.v_w)
    assert res_s.is_keyframe.any()


def test_entry_points_default_to_the_card(seq40):
    """VIOEngine and make_sequence_inputs run on the card unless asked
    otherwise; without one they refuse instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(seq40["calib"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sequence_inputs(seq40, 1, 3)
