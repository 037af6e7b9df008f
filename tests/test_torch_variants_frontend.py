"""vislam_tpu_torch against vislam_tpu: the frontend's step options,
oriented descriptors (`frontend.oriented`, SIFT and BRIEF) and the
always-on guided match (`frontend.guided_gate_px`), on the reference's
draws and the float32 image pipeline (tests/test_torch_engine.py says why);
the port's adversarial imagery (`data/adversarial.py`) and the gated step
on its brick walls; `lie.quat_slerp`.

Tolerances, each with what was measured when written:
- oriented SIFT at random angles: 1e-5 (measured 1.8e-6; the rotated
  grid's samples are two float32 contractions in both packages), BRIEF
  1e-6 (its +-1/16 entries: equal);
- `extract_features(oriented=True)`: keypoints as sets equal (each within
  1e-2 px of its twin; measured 1e-3 px, float32 round-off of the subpixel
  refinement), descriptors of twin keypoints within 1e-4 (measured 1.1e-5,
  from those 1e-3 px);
- the steps: keyframes equal on every frame, match and inlier counts within
  2, positions within 2e-3 m (the default path's bound,
  tests/test_torch_engine.py);
- the adversarial sequence: exact (the same numpy);
- `quat_slerp`: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _f32, _imu, _noises, _run
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.data.adversarial import make_adversarial_sequence as j_make_adversarial
from vislam_tpu.data.adversarial import presets as j_presets
from vislam_tpu.data.synthetic import synthetic_calib as j_calib
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.frontend.binary_desc import describe_binary as j_describe_binary
from vislam_tpu.frontend.descriptor import describe_keypoints as j_describe
from vislam_tpu.frontend.features import extract_features as j_extract
from vislam_tpu.lie.quat import quat_slerp as j_slerp
from vislam_tpu.utils.config import FrontendConfig as JFrontend
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.data.adversarial import make_adversarial_sequence as t_make_adversarial
from vislam_tpu_torch.data.adversarial import presets as t_presets
from vislam_tpu_torch.data.synthetic import synthetic_calib as t_calib
from vislam_tpu_torch.engine import VIOEngine as TEngine
from vislam_tpu_torch.frontend.binary_desc import describe_binary as t_describe_binary
from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry
from vislam_tpu_torch.frontend.descriptor import describe_keypoints as t_describe
from vislam_tpu_torch.frontend.features import extract_features as t_extract
from vislam_tpu_torch.lie import quat_slerp as t_slerp
from vislam_tpu_torch.ops import match_kernel
from vislam_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)
N_STEP = 12


def _t(x):
    return torch.from_numpy(np.array(x))


def _frontend(cfg, **fe):
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, **fe))


@pytest.fixture(scope="module")
def seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=N_STEP + 1, n_landmarks=300,
                                                   seed=3))


def _keypoints(rng, K, H=120, W=160):
    img = (rng.random((H, W)) * 255).astype(np.float32)
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    return img, uv, rng.uniform(-np.pi, np.pi, K).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_oriented_sift_descriptors_match_reference(seed):
    """The rotated 256-sample grid (keypoints at the border included: the
    patch is clipped inside the image) and the upright grid at angle None."""
    img, uv, ang = _keypoints(np.random.default_rng(seed), 96)
    geom = DescriptorGeometry("cpu")
    j = np.asarray(j_describe(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ang)))
    t = t_describe(_t(img), _t(uv), geom, _t(ang)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    up = np.asarray(j_describe(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ang),
                               upright=True))
    np.testing.assert_allclose(t_describe(_t(img), _t(uv), geom).numpy(), up, atol=1e-5)
    assert np.abs(t - up).max() > 0.1     # the angle is not ignored


def test_oriented_brief_matches_reference():
    img, uv, ang = _keypoints(np.random.default_rng(2), 96)
    j = np.asarray(j_describe_binary(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ang)))
    t = t_describe_binary(_t(img), _t(uv), _t(ang), DescriptorGeometry("cpu").brief).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize("descriptor", ["sift", "brief"])
def test_extract_features_oriented_matches_reference(seq, descriptor):
    """extract_features with oriented=True, float32 pipeline: the same
    keypoints (as sets, queue 3 f) and, keypoint by keypoint, the same
    descriptors."""
    fe = dict(oriented=True, descriptor=descriptor, image_dtype="float32")
    j = j_extract(jnp.asarray(seq["images"][4], jnp.float32), JFrontend(**fe))
    t = t_extract(_t(seq["images"][4].astype(np.float32)), tconfig.FrontendConfig(**fe))
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    ju, tu = np.asarray(j.uv)[jm], t.uv.numpy()[tm]
    assert len(ju) == len(tu) > 300
    # The same set: each keypoint's nearest in the other within float32
    # round-off of the subpixel refinement (measured 1e-3 px).
    d = np.linalg.norm(ju[:, None] - tu[None], axis=-1)
    near = d.argmin(1)
    assert d.min(1).max() < 1e-2 and len(set(near.tolist())) == len(ju)
    np.testing.assert_allclose(t.desc.numpy()[tm][near], np.asarray(j.desc)[jm], atol=1e-4)
    assert np.abs(np.asarray(j.angle)[jm]).max() > 0.5       # angles are in play


def _hold(jr, tr):
    assert [r["kf"] for r in jr] == [r["kf"] for r in tr]
    for x, y in zip(jr, tr):
        assert abs(x["nm"] - y["nm"]) <= 2, (x, y)
        assert abs(x["ni"] - y["ni"]) <= 2, (x, y)
        np.testing.assert_allclose(y["p"], x["p"], atol=2e-3)


def test_oriented_step_matches_reference(seq):
    """12 frames with oriented SIFT: keyframes, counts and positions."""
    jr, _, _ = _run(JEngine(seq["calib"], _frontend(_f32(JSystem()), oriented=True)), seq,
                    port=False, n_frames=N_STEP)
    tr, _, _ = _run(TEngine(seq["calib"], _frontend(_f32(tconfig.SystemConfig()),
                                                    oriented=True), device="cpu"),
                    seq, port=True, n_frames=N_STEP)
    _hold(jr, tr)
    assert np.median([r["nm"] for r in tr]) > 50


def test_gated_step_matches_reference(seq, monkeypatch):
    """12 frames with the always-on guided match at 30 px: keyframes,
    counts and positions as the reference's; each frame makes exactly one
    match call, gated (the rescue is statically off, as in the reference),
    and takes no rescue."""
    calls = []
    plain = match_kernel.match_top2_plain

    def counted(*a, **k):
        calls.append(a[4] is not None and (a[6] if len(a) > 6 else k["gate_radius"]))
        return plain(*a, **k)

    jr, _, _ = _run(JEngine(seq["calib"], _frontend(_f32(JSystem()), guided_gate_px=30.0)),
                    seq, port=False, n_frames=N_STEP)
    monkeypatch.setattr(match_kernel, "match_top2_plain", counted)
    tr, _, _ = _run(TEngine(seq["calib"], _frontend(_f32(tconfig.SystemConfig()),
                                                    guided_gate_px=30.0), device="cpu"),
                    seq, port=True, n_frames=N_STEP)
    assert calls == [30.0] * (N_STEP - 1), calls
    assert not any(r["fb"] for r in tr)
    _hold(jr, tr)


@pytest.mark.parametrize("preset", ["repetitive", "combined"])
def test_adversarial_sequence_equals_reference(preset):
    """The port's copy renders exactly the reference's sequence (the same
    numpy), at 188x120 and 3 frames; the scene answers the same
    ground-truth correspondences."""
    j = j_make_adversarial(dataclasses.replace(j_presets()[preset], n_frames=3),
                           j_calib(188, 120))
    t = t_make_adversarial(dataclasses.replace(t_presets()[preset], n_frames=3),
                           t_calib(188, 120))
    for k in ("images", "t_cam_ns", "gt_pos", "gt_vel", "gt_quat", "gt_rpy", "imu_t_ns",
              "imu_gyro", "imu_accel"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    uv = np.array([[30.0, 40.0], [100.0, 60.0], [150.0, 100.0]])
    for a, b in zip(j["scene"].gt_correspondence(0, uv, 2),
                    t["scene"].gt_correspondence(0, uv, 2)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_gated_step_on_brick_walls_matches_reference():
    """The port's first robustness case: the repetitive (brick wall) preset
    at full size, 6 frames, GT scale, the 30 px gate (the regime where it
    decides, MATCHABILITY.md): keyframes, counts and positions as the
    reference's on the same draws."""
    cfg = dataclasses.replace(t_presets()["repetitive"], n_frames=7)
    seq = t_make_adversarial(cfg)
    jr, _, _ = _run(JEngine(seq["calib"], _frontend(_f32(JSystem()), guided_gate_px=30.0)),
                    seq, port=False, n_frames=7)
    tr, _, _ = _run(TEngine(seq["calib"], _frontend(_f32(tconfig.SystemConfig()),
                                                    guided_gate_px=30.0), device="cpu"),
                    seq, port=True, n_frames=7)
    _hold(jr, tr)
    assert np.isfinite([r["p"] for r in tr]).all()
    assert min(r["nm"] for r in tr) > 20


@pytest.mark.parametrize("case", ["general", "near_equal", "opposite_hemisphere"])
def test_quat_slerp_matches_reference(case):
    rng = np.random.default_rng(4)
    q0 = rng.normal(size=(16, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 = rng.normal(size=(16, 4))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    if case == "near_equal":
        q1 = q0 + 1e-7 * rng.normal(size=q0.shape)
    elif case == "opposite_hemisphere":
        q1 = -q0 + 0.1 * rng.normal(size=q0.shape)
    q0, q1 = q0.astype(np.float32), q1.astype(np.float32)
    t = rng.uniform(0, 1, (16, 1)).astype(np.float32)
    j = np.asarray(j_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    np.testing.assert_allclose(t_slerp(_t(q0), _t(q1), _t(t)).numpy(), j, atol=1e-6)
    # The ends: t = 0 gives q0, t = 1 gives q1 up to sign.
    ends = t_slerp(_t(q0), _t(q1), torch.tensor([[0.0], [1.0]]).repeat(8, 1)).numpy()
    np.testing.assert_allclose(ends[0::2], q0[0::2], atol=1e-5)
