"""vislam_tpu_torch against vislam_tpu: the window BA's `marg` and
`oldest2` gauges (`engine/refine.py`, `backend.online_gauge`), one
`refine_window` at a time, from the reference's state after frame 18 of a
SLAM-mode run (the in-step window VI-BA, `vi_factors` + `refine_in_step`)
at GT scale with the marg gauge: the window full, the prior handed over on
eviction, the VI-BA engaged (GT scale engages it from the first frame).

Tolerances, each with what was measured when written: refined window
positions, the anchor, velocities and the bias within 1e-3 m (m/s), as
tests/test_torch_slam.py:91; the pending prior's linearization point
within 1e-3 and its information within 1e-2 of its largest entry.
- marg with the prior active, 12 LM iterations (the default): measured
  9.3e-5 m (the reference against itself, its window translations scaled
  by 1 + 2^-22: 1.4e-3 m);
- a window with only slot 0 fixed (marg with the prior empty, oldest2
  with IMU factors) and oldest2 vision only, 4 LM iterations: measured
  2.1e-5 m and 7.7e-6 m. Past ~4 iterations these windows drift along a
  weak direction: at 12 the reference against itself under the same
  2-ulp change moves 0.14 m (vision only 1.1e-4 m), the port 0.28 m from
  it, so the full solve is no test of the port.
An unknown gauge name raises ValueError before the first step (the
reference takes it as `ends` in vision-only windows and as slot 0 fixed
with IMU factors, silently).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import _imu
from test_torch_gtfree import configure
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.engine.refine import refine_window as j_refine_window
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.engine.refine import _widest_baseline_slot, check_gauge
from vislam_tpu_torch.engine.refine import refine_window as t_refine_window
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)
KEEP = 18           # the state the refine_window checks start from


def _slam(gauge, vi=True, lm_iters=12):
    return dict(vi_factors=vi, refine_in_step=True, online_gauge=gauge, lm_iters=lm_iters)


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=KEEP + 1, n_landmarks=300,
                                                   seed=0))


@pytest.fixture(scope="module")
def kept(seq):
    """The reference's state after frame KEEP, GT scale, marg gauge."""
    eng = JEngine(seq["calib"], configure(JSystem(), **_slam("marg")))
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                           v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
    last_kf = 0
    for j in range(1, KEEP + 1):
        imu, dt = _imu(seq, j)
        g = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        state, res = eng.step(state, seq["images"][j], imu, dt, g)
        last_kf = j if bool(res.is_keyframe) else last_kf
    tree = jax.tree.map(np.asarray, state)
    assert int(tree.window.count) == 10 and float(np.trace(tree.marg_H)) > 1e-6
    return tree


def _positions(s):
    return -np.einsum("wji,wj->wi", s.window.R_cw, s.window.t_cw)


def _refine_both(tree, seq, backend):
    c = seq["calib"]
    R_bc = np.asarray(c.T_body_cam[:3, :3], np.float32)
    j = jax.tree.map(np.asarray, j_refine_window(
        jax.tree.map(jax.numpy.asarray, tree), configure(JSystem(), **backend),
        c.fx, c.fy, c.cx, c.cy, R_bc=R_bc))
    t = state_to_numpy(t_refine_window(
        state_from_numpy(tree, "cpu"), configure(tconfig.SystemConfig(), **backend),
        c.fx, c.fy, c.cx, c.cy, R_bc=torch.from_numpy(R_bc)))
    assert np.abs(_positions(j) - _positions(tree)).max() > 1e-5      # the BA was kept
    np.testing.assert_allclose(_positions(t), _positions(j), atol=1e-3)
    for name in ("p_wc", "kf_p_wc", "v_w", "bias_g", "bias_a"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(t.window.v_w, j.window.v_w, atol=1e-3)
    return j, t


@pytest.mark.parametrize("prior", ["active", "empty"])
def test_refine_window_marg_matches_reference(kept, seq, prior):
    """No pose fixed under the active prior, slot 0 fixed with it empty;
    the pending prior computed and kept alike."""
    tree = kept
    if prior == "empty":
        tree = tree._replace(marg_H=np.zeros_like(tree.marg_H))
    j, t = _refine_both(tree, seq, _slam("marg", lm_iters=12 if prior == "active" else 4))
    scale = np.abs(j.marg_pend_H).max()
    assert scale > 0 and not np.array_equal(j.marg_pend_H, tree.marg_pend_H)
    np.testing.assert_allclose(t.marg_pend_H, j.marg_pend_H, atol=1e-2 * scale)
    for name in ("marg_pend_R_cw", "marg_pend_t_cw", "marg_pend_v"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), atol=1e-3,
                                   err_msg=name)


def test_refine_window_oldest2_vi_matches_reference(kept, seq):
    """oldest2 with IMU factors: slot 0 fixed, the anchor refined."""
    _refine_both(kept, seq, _slam("oldest2", lm_iters=4))


def test_refine_window_oldest2_vision_only_matches_reference(kept, seq):
    """oldest2 without IMU factors: slot 0 and the widest-baseline slot
    fixed; the slot equals the reference's rule (argmax of the distance
    from slot 0 over valid slots but 0 and the anchor)."""
    tree = kept
    p = _positions(tree)
    W = p.shape[0]
    anchor = int(np.clip(int(tree.window.count) - 1, 0, W - 1))
    cand = tree.window.valid & (np.arange(W) != 0) & (np.arange(W) != anchor)
    far = int(np.argmax(np.where(cand, np.linalg.norm(p - p[0], axis=-1), -1.0)))
    st = state_from_numpy(tree, "cpu")
    got = _widest_baseline_slot(st.window, torch.arange(W), torch.tensor(anchor))
    assert int(got) == far and far not in (0, anchor)
    _refine_both(tree, seq, _slam("oldest2", vi=False, lm_iters=4))


def test_unknown_gauge_raises(seq):
    """A deliberate difference from the reference: an unknown name is
    refused at construction (and by the refine), not run as another gauge."""
    base = tconfig.SystemConfig()
    cfg = dataclasses.replace(base, backend=dataclasses.replace(base.backend,
                                                                online_gauge="oldest"))
    with pytest.raises(ValueError, match="oldest"):
        TEngine(seq["calib"], cfg, device="cpu")
    with pytest.raises(ValueError, match="not a gauge"):
        check_gauge("Marg")
    for g in ("ends", "marg", "oldest2"):
        check_gauge(g)
