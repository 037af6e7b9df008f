"""vislam_tpu_torch against vislam_tpu: loop closure. Global descriptors,
candidate detection, `verify_loop` (fed the reference's Gumbel draws),
`pnp_gn`, `triangulate_dlt`, `measure_relative_pose`, `correct_trajectory`
(SE(3) and Sim(3)) and `keyframes_from_scan`.

The archive: the reference's `extract_features` on every 4th frame of the
86-frame seed-21 sequence (the one `tests/test_trajectory_opt.py` loops
around: the path revisits its start at frame 80), at GT poses plus a drift
that grows along the sequence (0.45 m and 4 degrees of yaw by the end).
Both packages get the same archive.

Tolerances. Descriptor sums and similarities: float32 round-off, 1e-5.
The match kernel's twin and XLA compute the distances in another order, so
a near-tied ratio test can flip: correspondence and inlier counts may
differ by a few (measured 0-1), and PnP solutions of sets that differ by a
point move by ~1e-4: R, t to 1e-3. Loops (a, b) are equal sets, the
candidates' order among equal similarities is not compared (torch.topk
and lax.top_k need not order ties alike), and corrected positions agree to
1e-3 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsp

from vislam_tpu.backend import loop as jloop
from vislam_tpu.backend import pnp as jpnp
from vislam_tpu.backend import trajectory_opt as jto
from vislam_tpu.backend.triangulate import triangulate_dlt as j_dlt
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.frontend.features import extract_features as j_extract
from vislam_tpu.utils.config import FrontendConfig as JFrontend
from vislam_tpu_torch.backend import loop as tloop
from vislam_tpu_torch.backend import pnp as tpnp
from vislam_tpu_torch.backend import trajectory_opt as tto
from vislam_tpu_torch.backend.triangulate import triangulate_dlt as t_dlt
from vislam_tpu_torch.utils.config import FrontendConfig as TFrontend

torch.set_num_threads(2)
CPU = dict(device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def archive():
    """(seq, archive as the reference's KeyframeRecords, GT positions)."""
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=86, n_landmarks=300, seed=21))
    frames = list(range(0, 86, 4))
    recs, gt = [], []
    for n, j in enumerate(frames):
        f = j_extract(jnp.asarray(seq["images"][j], jnp.float32), JFrontend())
        frac = n / (len(frames) - 1)
        R_gt = Rsp.from_quat(np.roll(seq["gt_quat"][j], -1)).as_matrix()
        R_wc = Rsp.from_euler("z", np.radians(4.0) * frac).as_matrix() @ R_gt
        p_wc = seq["gt_pos"][j] + frac * np.array([0.3, -0.3, 0.15])
        recs.append(jto.record_from_feat(j, R_wc.astype(np.float32),
                                         p_wc.astype(np.float32), f))
        gt.append(seq["gt_pos"][j])
    return seq, recs, np.array(gt)


def _stack(recs, key):
    return np.stack([getattr(k, key) for k in recs])


def test_global_descriptors_and_candidates_match_reference(archive):
    _, recs, _ = archive
    desc, mask = _stack(recs, "desc"), _stack(recs, "kp_mask")
    j_g = np.array(jloop.global_descriptors(jnp.asarray(desc), jnp.asarray(mask)))
    t_g = tloop.global_descriptors(_t(desc), _t(mask))
    np.testing.assert_allclose(t_g.numpy(), j_g, rtol=1e-5, atol=1e-6)
    W = len(recs)
    valid = np.ones(W, bool)
    valid[3] = False
    kw = dict(min_separation=8, sim_thresh=0.85, max_candidates=8)
    j_c = jloop.detect_loop_candidates(jnp.asarray(j_g), jnp.asarray(valid), **kw)
    t_c = tloop.detect_loop_candidates(_t(j_g), _t(valid), **kw)
    assert t_c.idx_a.dtype == torch.int32 and t_c.mask.dtype == torch.bool
    np.testing.assert_allclose(np.sort(t_c.sim.numpy()), np.sort(np.array(j_c.sim)), atol=1e-6)

    def pairs(c):
        return {(int(a), int(b)) for a, b, m in zip(np.array(c.idx_a), np.array(c.idx_b),
                                                    np.array(c.mask)) if m}
    assert pairs(t_c) == pairs(j_c) and pairs(t_c)
    assert all(b - a >= 8 and 3 not in (a, b) for a, b in pairs(t_c))


@pytest.mark.parametrize("a,b,accepted", [(10, 11, True), (0, 20, False)])
def test_verify_loop_with_reference_draws(archive, a, b, accepted):
    """With the reference's Gumbel draws for its key, the reference's
    decision, inliers (measured equal) and direction: keyframes 10 and 11
    (frames 40, 44) pass; the revisit 0 and 20 (frames 0, 80, another
    heading) fails the identity-rotation epipolar test in both packages."""
    seq, recs, _ = archive
    ka, kb = recs[a], recs[b]
    c = seq["calib"]
    key = jax.random.PRNGKey(3)
    j_ok, _, j_t, j_n = jloop.verify_loop(
        *map(jnp.asarray, (ka.desc, ka.kp_mask, ka.uv, kb.desc, kb.kp_mask, kb.uv)),
        c.fx, c.fy, c.cx, c.cy, key)
    ka_, kb_ = jax.random.split(key)
    K = ka.desc.shape[0]
    noise = np.stack([np.array(jax.random.gumbel(k, (256, K))) for k in (ka_, kb_)])
    t_ok, R, t_t, t_n = tloop.verify_loop(
        *map(_t, (ka.desc, ka.kp_mask, ka.uv, kb.desc, kb.kp_mask, kb.uv)),
        c.fx, c.fy, c.cx, c.cy, noise=_t(noise))
    assert bool(t_ok) == bool(j_ok) == accepted
    assert abs(int(t_n) - int(j_n)) <= 1
    np.testing.assert_allclose(t_t.numpy(), np.array(j_t), atol=1e-3)
    np.testing.assert_array_equal(R.numpy(), np.eye(3))


def test_pnp_gn_matches_reference(rng):
    """PnP on 300 points with 1 px noise and 15% outliers, from a start 0.1
    rad and 0.2 m off: the reference's pose, inliers and RMSE."""
    N = 300
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 12, N)],
                 -1).astype(np.float32)
    R = Rsp.from_rotvec([0.05, -0.1, 0.03]).as_matrix().astype(np.float32)
    t = np.array([0.3, -0.1, 0.4], np.float32)
    Xc = X @ R.T + t
    uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 376, 400 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    uv = (uv + rng.normal(scale=1.0, size=uv.shape)).astype(np.float32)
    bad = rng.uniform(size=N) < 0.15
    uv[bad] += rng.uniform(-60, 60, (bad.sum(), 2)).astype(np.float32)
    mask = rng.uniform(size=N) > 0.05
    R0 = (Rsp.from_rotvec([0.0, 0.1, 0.0]).as_matrix() @ R).astype(np.float32)
    t0 = t + np.array([0.2, 0.0, 0.0], np.float32)
    args = (X, uv, mask, R0, t0)
    j = jpnp.pnp_gn(*map(jnp.asarray, args), 400.0, 400.0, 376.0, 240.0)
    p = tpnp.pnp_gn(*map(_t, args), 400.0, 400.0, 376.0, 240.0)
    np.testing.assert_allclose(p.R.numpy(), np.array(j.R), atol=1e-5)
    np.testing.assert_allclose(p.t.numpy(), np.array(j.t), atol=1e-4)
    np.testing.assert_array_equal(p.inlier_mask.numpy(), np.array(j.inlier_mask))
    assert int(p.num_inliers) == int(j.num_inliers) and p.num_inliers.dtype == torch.int32
    np.testing.assert_allclose(float(p.rmse), float(j.rmse), rtol=1e-4)
    assert np.abs(p.t.numpy() - t).max() < 0.05


def test_triangulate_dlt_matches_reference(rng):
    """Two projection matrices 0.5 m apart, 64 points with 0.3 px noise:
    the reference's points to 1e-3 relative (the 4x4 eigenvectors in float32)."""
    M = 64
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1, 1, M), rng.uniform(3, 8, M)], -1)
    K = np.array([[400, 0, 376], [0, 400, 240], [0, 0, 1]], np.float64)
    R = Rsp.from_rotvec([0.0, 0.05, 0.0]).as_matrix()
    P_i = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P_j = K @ np.hstack([R, np.array([[-0.5], [0.0], [0.0]])])

    def proj(P):
        h = np.hstack([X, np.ones((M, 1))]) @ P.T
        return (h[:, :2] / h[:, 2:] + rng.normal(scale=0.3, size=(M, 2))).astype(np.float32)

    args = [proj(P_i), proj(P_j), P_i.astype(np.float32), P_j.astype(np.float32)]
    j = np.array(j_dlt(*map(jnp.asarray, args)))
    t = t_dlt(*map(_t, args)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)
    assert np.abs(t - X).max() < 0.3


def test_measure_relative_pose_matches_reference(archive):
    """Keyframe a = 0 (partner 1) against the revisit b = 20, from the
    drifted estimate: ok, the same transform (1e-3) and inliers (+-2)."""
    seq, recs, _ = archive
    c = seq["calib"]
    ka, kn, kb = recs[0], recs[1], recs[20]
    R0 = (kb.R_wc.T @ ka.R_wc).astype(np.float32)
    t0 = (kb.R_wc.T @ (ka.p_wc - kb.p_wc)).astype(np.float32)
    args = (kb.desc, kb.kp_mask, kb.uv, R0, t0, c.fx, c.fy, c.cx, c.cy)
    j = jto.measure_relative_pose(ka, kn, *args)
    t = tto.measure_relative_pose(tto.KeyframeRecord(*ka), tto.KeyframeRecord(*kn), *args, **CPU)
    assert j[0] and t[0]
    np.testing.assert_allclose(t[1], j[1], atol=1e-3)
    np.testing.assert_allclose(t[2], j[2], atol=1e-3)
    assert abs(t[3] - j[3]) <= 2
    np.testing.assert_allclose(t[4], j[4], rtol=1e-2)


@pytest.mark.parametrize("use_sim3", [False, True], ids=["se3", "sim3"])
def test_correct_trajectory_matches_reference(archive, use_sim3):
    """The same verified loops (pairs equal, inliers within 2) and corrected
    positions within 1e-3 m of the reference's; the loop spans >= 10
    keyframes and the worst keyframe error falls."""
    seq, recs, gt = archive
    c = seq["calib"]
    kw = dict(min_separation=8, sim_thresh=0.80, min_inliers=25, use_sim3=use_sim3)
    j_p, j_R, j_info = jto.correct_trajectory(recs, c.fx, c.fy, c.cx, c.cy, **kw)
    t_p, t_R, t_info = tto.correct_trajectory([tto.KeyframeRecord(*k) for k in recs],
                                              c.fx, c.fy, c.cx, c.cy, **kw, **CPU)
    assert [(a, b) for a, b, _ in t_info["loops"]] == [(a, b) for a, b, _ in j_info["loops"]]
    assert all(abs(x[2] - y[2]) <= 2 for x, y in zip(t_info["loops"], j_info["loops"]))
    assert any(b - a >= 10 for a, b, _ in t_info["loops"])
    np.testing.assert_allclose(t_p, j_p, atol=1e-3)
    np.testing.assert_allclose(t_R, j_R, atol=1e-3)
    np.testing.assert_allclose(t_info["scales"], np.array(j_info["scales"]), atol=1e-3)
    err = [np.linalg.norm(p - gt, axis=-1).max() for p in (_stack(recs, "p_wc"), t_p)]
    assert err[1] < err[0], err


def test_keyframes_from_scan_matches_reference(archive):
    """A scan's results (keyframes at frames 2, 5 and 9, GT poses) and its
    staged images: the reference's records (frame indices and poses equal;
    fine-level keypoint sets overlapping >= 0.95 at integer pixels, the
    bf16 pipelines' measured overlap, tests/test_torch_detect.py)."""
    from vislam_tpu.engine.engine import FrameResult as JResult
    from vislam_tpu_torch.engine.engine import FrameResult as TResult

    seq, _, _ = archive
    n = 10
    is_kf = np.zeros(n, bool)
    is_kf[[2, 5, 9]] = True
    R = np.stack([Rsp.from_quat(np.roll(q, -1)).as_matrix() for q in seq["gt_quat"][1:n + 1]]
                 ).astype(np.float32)
    p = seq["gt_pos"][1:n + 1].astype(np.float32)
    fields = {f: np.zeros(n, np.float32) for f in JResult._fields}
    fields.update(is_keyframe=is_kf, R_wc=R, p_wc=p)
    images = seq["images"][1:n + 1].astype(np.float32)
    j = jto.keyframes_from_scan(images, JResult(**fields), JFrontend(), frame_offset=1)
    t = tto.keyframes_from_scan(_t(images), TResult(**{k: _t(v) for k, v in fields.items()}),
                                TFrontend(), frame_offset=1)
    assert [k.frame_index for k in t] == [k.frame_index for k in j] == [3, 6, 10]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.R_wc, b.R_wc)
        np.testing.assert_array_equal(a.p_wc, b.p_wc)
        assert a.desc.dtype == np.float32 and a.kp_mask.dtype == bool
        ka = {tuple(x) for x in np.round(a.uv[a.kp_mask]).astype(int)}
        kb = {tuple(x) for x in np.round(b.uv[b.kp_mask]).astype(int)}
        assert len(ka & kb) / len(kb) >= 0.95
