"""vislam_tpu_torch against vislam_tpu: the host side of a run. Trajectory
files, bootstrap smoothing, roll-pitch-yaw, checkpoints (JAX -> port and
port -> JAX), the packed per-frame result, the pipelined host-loop step
against the sequence loop, and relocalize.

Steps against the reference use the float32 image pipeline and the
reference's own RANSAC draws, as tests/test_torch_engine.py does.
"""

import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _imu, _noises
from vislam_tpu import lie as jlie
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.engine.engine import unpack_host_result as j_unpack
from vislam_tpu.eval import smooth as jsmooth
from vislam_tpu.eval import traj_io as jtraj
from vislam_tpu.utils import checkpoint as jck
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch import lie as tlie
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.engine import make_sequence_inputs, run_sequence_scan
from vislam_tpu_torch.engine.engine import pack_result
from vislam_tpu_torch.engine.engine import unpack_host_result as t_unpack
from vislam_tpu_torch.eval import smooth as tsmooth
from vislam_tpu_torch.eval import traj_io as ttraj
from vislam_tpu_torch.utils import checkpoint as tck
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)


def _f32(cfg):
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 image_dtype="float32"))


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=14, n_landmarks=300, seed=3))


def _init(eng, seq):
    return eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                          v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])


def _leaves(state):
    return list(tck._leaves(state))


# ---------------------------------------------------------------- files


def _rows(rng, n=6):
    rows = []
    for k in range(n):
        gt = k % 2 == 0
        rows.append(dict(
            frame=k + 1, t_ns=1403636579763555584 + 50_000_000 * k, is_kf=bool(k % 3 == 0),
            est_p=rng.normal(size=3).astype(np.float32), est_rpy=rng.normal(size=3),
            est_q=rng.normal(size=4).astype(np.float32), est_v=rng.normal(size=3),
            gt_p=rng.normal(size=3) if gt else None, gt_rpy=rng.normal(size=3) if gt else None,
            gt_q=rng.normal(size=4) if gt else None, gt_v=None))
    return rows


def test_trajectory_files_are_byte_identical(tmp_path, rng):
    """The CSV and TUM writers produce the reference's bytes for the same
    rows (float32 and float64 values, missing GT); the readers agree."""
    rows = _rows(rng)
    for kind in ("csv", "tum"):
        a, b = str(tmp_path / f"j.{kind}"), str(tmp_path / f"t.{kind}")
        getattr(jtraj, f"write_trajectory_{kind}")(a, rows)
        getattr(ttraj, f"write_trajectory_{kind}")(b, rows)
        assert filecmp.cmp(a, b, shallow=False), kind
        ja, tb = getattr(jtraj, f"read_trajectory_{kind}")(a), \
            getattr(ttraj, f"read_trajectory_{kind}")(b)
        assert ja.keys() == tb.keys()
        for k in ja:
            np.testing.assert_array_equal(tb[k], ja[k])


@pytest.mark.parametrize("tail", [12, 3])
def test_bootstrap_smoothing_equals_reference(rng, tail):
    """A re-anchor at frame 20 - tail: the least-squares scale (long tail)
    and the boundary-ratio fallback (short tail); a warm run unchanged.
    Within 1e-9 m (float64, the same numpy code)."""
    n = 20
    shadows = np.cumsum(rng.normal(size=(n, 3)), 0)
    poses = 1.7 * shadows + rng.normal(size=(n, 3)) * 0.01
    applies = np.zeros(n, int)
    applies[n - tail:] = 1
    args = (poses, shadows, applies, np.zeros(3), shadows[0] * 0.5)
    np.testing.assert_allclose(tsmooth.smooth_bootstrap_prefix(*args),
                               jsmooth.smooth_bootstrap_prefix(*args), atol=1e-9, rtol=0)
    warm = (poses, shadows, np.zeros(n, int), np.zeros(3), np.zeros(3))
    np.testing.assert_array_equal(tsmooth.smooth_bootstrap_prefix(*warm), poses)


def test_euler_equals_reference(rng):
    """rpy <-> quaternion <-> matrix, wrap and angle difference, batched,
    through the poles; float32 within 1e-5 rad."""
    rpy = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    rpy[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-4, 0.0]
    q = np.asarray(jlie.rpy_to_quat(jnp.asarray(rpy)))
    R = np.asarray(jlie.rpy_to_mat(jnp.asarray(rpy)))
    def t(x):
        return torch.from_numpy(np.array(x))

    np.testing.assert_allclose(tlie.rpy_to_quat(t(rpy)).numpy(), q, atol=1e-6)
    np.testing.assert_allclose(tlie.rpy_to_mat(t(rpy)).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(tlie.quat_to_rpy(t(q)).numpy(),
                               np.asarray(jlie.quat_to_rpy(jnp.asarray(q))), atol=1e-5)
    np.testing.assert_allclose(tlie.mat_to_rpy(t(R)).numpy(),
                               np.asarray(jlie.mat_to_rpy(jnp.asarray(R))), atol=1e-5)
    a, b = rpy[:, 0] * 3, rpy[:, 1] * 3
    np.testing.assert_allclose(tlie.wrap_angle(t(a)).numpy(),
                               np.asarray(jlie.wrap_angle(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(tlie.angle_diff(t(a), t(b)).numpy(),
                               np.asarray(jlie.angle_diff(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


# ---------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def j_state(seq):
    """A reference state at init (the bf16 window bank's slot 0 filled), its
    float leaves perturbed so that no leaf is its default."""
    eng = JEngine(seq["calib"], JSystem())
    st = jax.tree.map(np.asarray, _init(eng, seq))
    rng = np.random.default_rng(9)

    def perturb(x):
        if x.dtype == np.float32:
            return (x + rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree.map(perturb, st)


def test_checkpoint_from_reference_resumes_in_port(tmp_path, j_state):
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, j_state, 17, meta={"last_kf": 12, "last_kf_pos": [1.0, 2, 3]})
    st, fidx = tck.load_checkpoint(path, device="cpu")
    assert fidx == 17 and tck.load_checkpoint_meta(path)["last_kf"] == 12
    want = state_from_numpy(j_state, "cpu")
    assert st.window.desc.dtype == torch.bfloat16
    for a, b in zip(_leaves(st), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_from_port_loads_in_reference(tmp_path, j_state):
    port = state_from_numpy(j_state, "cpu")
    path = str(tmp_path / "t.npz")
    tck.save_checkpoint(path, port, 23, meta={"last_kf": 20})
    st, fidx = jck.load_checkpoint(path)
    assert fidx == 23 and jck.load_checkpoint_meta(path) == {"last_kf": 20}
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(j_state)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_added_field_defaults_and_positional_refused(tmp_path, j_state):
    """A file without the fields added to the state later loads them from
    their defaults (the reference's table); a positional file (no leaf
    paths) with more leaves than the state (a newer checkpoint) is refused,
    as the reference refuses it."""
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, j_state, 5)
    data = dict(np.load(path))
    paths = [str(p) for p in data["__paths"]]
    drop = {".vi_engaged", ".shadow_win_p", ".bootstrap_applies"}
    keep = [i for i, p in enumerate(paths) if p not in drop]
    old = {f"leaf_{k}": data[f"leaf_{i}"] for k, i in enumerate(keep)}
    bf16 = [keep.index(int(i)) for i in data["__bf16_leaves"]]
    np.savez(str(tmp_path / "old.npz"), **old, __frame_index=data["__frame_index"],
             __paths=np.asarray([paths[i] for i in keep]), __bf16_leaves=np.asarray(bf16))
    st, _ = tck.load_checkpoint(str(tmp_path / "old.npz"), device="cpu")
    assert not bool(st.vi_engaged) and int(st.bootstrap_applies) == 0
    assert st.shadow_win_p.shape == (10, 3) and not st.shadow_win_p.any()
    assert torch.equal(st.window.desc, state_from_numpy(j_state, "cpu").window.desc)
    n = len(paths)
    newer = {k: v for k, v in data.items() if k != "__paths"}
    newer[f"leaf_{n}"] = np.zeros(3, np.float32)
    np.savez(str(tmp_path / "newer.npz"), **newer)
    for load in (lambda p: tck.load_checkpoint(p, device="cpu"), jck.load_checkpoint):
        with pytest.raises(ValueError, match="newer checkpoint"):
            load(str(tmp_path / "newer.npz"))


def _positional(tmp_path, j_state, drop_trailing):
    """The reference's save of j_state as an older positional file: no leaf
    paths, and without the state's last `drop_trailing` leaves."""
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, j_state, 11)
    data = dict(np.load(path))
    n = len(data["__paths"]) - drop_trailing
    old = {f"leaf_{i}": data[f"leaf_{i}"] for i in range(n)}
    pos = str(tmp_path / f"pos{drop_trailing}.npz")
    np.savez(pos, **old, __frame_index=data["__frame_index"],
             __bf16_leaves=data["__bf16_leaves"])
    return pos


@pytest.mark.parametrize("drop_trailing", [0, 3], ids=["positional", "padded"])
def test_checkpoint_positional_loads_as_the_reference(tmp_path, j_state, drop_trailing):
    """A positional file written from the reference's save loads leaf for
    leaf as the reference's load_checkpoint reads it: positionally when
    the counts match; with the last three fields (shadow_origin_p,
    bootstrap_applies, vi_engaged) missing, padded from their defaults."""
    pos = _positional(tmp_path, j_state, drop_trailing)
    st, fidx = tck.load_checkpoint(pos, device="cpu")
    want, j_fidx = jck.load_checkpoint(pos)
    assert fidx == j_fidx == 11
    assert st.window.desc.dtype == torch.bfloat16
    got = state_to_numpy(st)
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if drop_trailing:
        assert not bool(st.vi_engaged) and int(st.bootstrap_applies) == 0
        assert not st.shadow_origin_p.any()


# ---------------------------------------------------------------- host loop


def test_packed_result_has_the_reference_layout(seq):
    """Three frames: the reference's step_host_async and the port's step
    (fed the reference's draws) packed by pack_result; the port's unpack
    of the reference's vector is field for field the reference's unpack,
    and the two results agree within test_torch_engine.py's float32
    frame-by-frame tolerances (positions 2e-3 m, counts within 2)."""
    je = JEngine(seq["calib"], _f32(JSystem()))
    te = TEngine(seq["calib"], _f32(tconfig.SystemConfig()), device="cpu")
    js, ts = _init(je, seq), _init(te, seq)
    last_kf = 0
    for j in range(1, 4):
        imu, dt = _imu(seq, j)
        g = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        js, jflat = je.step_host_async(js, seq["images"][j], imu, dt, g)
        ts, tres = te.step(ts, seq["images"][j], imu, dt, g, *_noises(j - 1))
        tflat = pack_result(ts, tres)
        assert tflat.shape == (37,) and tflat.dtype == torch.float32
        jflat = np.asarray(jflat)
        a, b, c = j_unpack(jflat), t_unpack(jflat), t_unpack(tflat.numpy())
        for name in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(b, name)),
                                          np.asarray(getattr(a, name)), err_msg=name)
        assert (c.is_keyframe, c.used_fallback, c.bootstrap_applies) == \
            (a.is_keyframe, a.used_fallback, a.bootstrap_applies)
        assert abs(c.num_matches - a.num_matches) <= 2
        assert abs(c.num_inliers - a.num_inliers) <= 2
        for name in ("p_wc", "shadow_p_wc"):
            np.testing.assert_allclose(getattr(c, name), getattr(a, name), atol=2e-3)
        for name in ("R_wc", "q_wb", "rpy", "t_pred_cam", "v_w"):
            np.testing.assert_allclose(getattr(c, name), getattr(a, name), atol=2e-3)
        np.testing.assert_allclose(c.t_dir_cam, a.t_dir_cam, atol=1e-2)
        if a.is_keyframe:
            last_kf = j


def test_step_pipelined_equals_run_sequence_scan(seq):
    """12 frames through the host-loop step (uint8 images, numpy IMU and GT,
    the keyframe GT position carried on the device) equal the sequence loop
    on the staged float32 inputs: keyframes equal, positions within 1e-6 m
    (the same operations on the same values)."""
    n = 12
    eng = TEngine(seq["calib"], device="cpu")
    inputs = make_sequence_inputs(seq, 1, n + 1, device="cpu")
    _, res = run_sequence_scan(eng, _init(eng, seq), inputs)
    state = _init(eng, seq)
    kf_gt = seq["gt_pos"][0]
    for k in range(n):
        imu, dt = _imu(seq, k + 1)
        state, kf_gt, flat = eng.step_pipelined(state, kf_gt, seq["images"][k + 1], imu, dt,
                                                seq["gt_pos"][k + 1], 1.0)
        r = t_unpack(flat.numpy())
        assert r.is_keyframe == bool(res.is_keyframe[k]), k
        np.testing.assert_allclose(r.p_wc, res.p_wc[k].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(kf_gt.numpy(), inputs.gt_pos[
            int(np.nonzero(res.is_keyframe[:k + 1].numpy())[0].max())].numpy()
            if res.is_keyframe[:k + 1].any() else np.float32(seq["gt_pos"][0]), atol=0)
    assert res.is_keyframe.sum() >= 3
    # step_host is step_host_async plus one fetch: the same step.
    eng.set_step_counter(0)
    imu, dt = _imu(seq, 1)
    _, h = eng.step_host(_init(eng, seq), seq["images"][1], imu, dt,
                         float(np.linalg.norm(seq["gt_pos"][1] - seq["gt_pos"][0])))
    np.testing.assert_allclose(h.p_wc, res.p_wc[0].numpy(), atol=1e-6, rtol=0)


def test_relocalize_equals_reference(seq):
    """From a converted reference state with non-finite velocity and gyro
    bias: the same re-anchored pose, sanitised dynamics, counters, and the
    new keyframe's features (float32 pipeline: the same count within 2,
    mean position within 1e-3 px) and window slot 0."""
    je = JEngine(seq["calib"], _f32(JSystem()))
    te = TEngine(seq["calib"], _f32(tconfig.SystemConfig()), device="cpu")
    js = _init(je, seq)
    js = js._replace(v_w=jnp.asarray([np.nan, 1.0, 2.0], jnp.float32),
                     bias_g=jnp.asarray([0.01, np.inf, 0.0], jnp.float32),
                     kf_count=jnp.asarray(7, jnp.int32), frame_idx=jnp.asarray(9, jnp.int32))
    ts = state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    R = np.asarray(jlie.rpy_to_mat(jnp.asarray([0.1, -0.2, 0.3])), np.float32)
    p = np.asarray([0.5, -1.0, 2.0], np.float32)
    a = jax.tree.map(np.asarray, je.relocalize(js, seq["images"][5], R, p))
    b = te.relocalize(ts, seq["images"][5], R, p)
    for name in ("q_wb", "R_wc", "p_wc", "kf_R_wc", "kf_p_wc", "v_w", "bias_g", "bias_a",
                 "origin_p_wc", "shadow_p_wc"):
        np.testing.assert_allclose(getattr(b, name).numpy(), getattr(a, name), atol=1e-6,
                                   err_msg=name)
    assert int(b.kf_count) == 8 and int(b.frame_idx) == 9
    for name in ("R_cw", "t_cw", "valid", "count", "v_w"):
        np.testing.assert_allclose(getattr(b.window, name).numpy(),
                                   getattr(a.window, name), atol=1e-6, err_msg=name)
    nb, na = int(b.kf_feat.mask.sum()), int(a.kf_feat.mask.sum())
    assert abs(nb - na) <= 2
    np.testing.assert_allclose(b.kf_feat.uv[b.kf_feat.mask].mean(0).numpy(),
                               a.kf_feat.uv[a.kf_feat.mask].mean(0), atol=1e-3)
