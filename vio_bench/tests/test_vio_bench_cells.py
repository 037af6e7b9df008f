"""Each cell rehearsed on the CPU at a tiny size (2 sequences x 4 frames)
through the port's plain twins: the generator against the port's host
generator, the reference against the port, the result line, and the
check failing under each fault a cell can have and under the control."""

import numpy as np
import pytest
import torch

from vio_bench import check, generator, reference, run

SEED = 2 ** 33 + 17          # more than 32 bits: the harness takes any whole seed
CELLS = ["sift_b512", "kaze_b512"]


def tiny(cell):
    c = run.load_cell(cell)
    c.traffic = {**c.traffic, "sequences": 2}
    c.config = {**c.config, "frames": 4}
    c.workload = {**c.workload, "sample_frames": 8}
    return c


def _camera_and_noise(cell="sift_b512"):
    config = run.load_cell(cell).config
    return generator.Camera(**config["camera"]), generator.imu_noise(config["imu"])


def test_configured_camera_is_the_ports_euroc_cam0():
    from vislam_tpu_torch.calib.presets import euroc_calib

    cam, _ = _camera_and_noise()
    want = euroc_calib()
    assert (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy) == (
        want.width, want.height, want.fx, want.fy, want.cx, want.cy)


def test_generator_equals_the_ports_host_generator_without_background_noise():
    from vislam_tpu_torch.calib.camera_model import CameraCalib
    from vislam_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_sequence

    cam, noise = _camera_and_noise()
    assert noise["gyro_noise"] > 0 and noise["accel_noise"] > 0
    calib = CameraCalib(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, dist=(0.0, 0.0, 0.0, 0.0),
                        width=cam.width, height=cam.height, rate_cam_hz=generator.CAM_RATE_HZ,
                        rate_imu_hz=generator.IMU_RATE_HZ)
    traffic = generator.Traffic(sequences=2, frames=5, background_noise=0.0, **noise)
    batch = generator.make_batch(traffic, SEED, cam, 16, "cpu")
    for b in range(2):
        s = generator.sequence_seed(SEED, b)
        want = make_synthetic_sequence(SyntheticConfig(n_frames=6, n_landmarks=300, seed=s,
                                                       background_noise=0.0, **noise), calib)
        host = generator.host_sequence(traffic, s)
        np.testing.assert_array_equal(batch.images[b].numpy(), want["images"].astype(np.float32))
        np.testing.assert_array_equal(batch.gt_pos[b], want["gt_pos"])
        np.testing.assert_array_equal(batch.gt_quat[b], want["gt_quat"])
        np.testing.assert_array_equal(host.imu_gyro, want["imu_gyro"])
        np.testing.assert_array_equal(host.imu_accel, want["imu_accel"])
        np.testing.assert_array_equal(host.landmarks, want["landmarks"])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_features_equal_the_ports(cell):
    from vislam_tpu_torch.frontend.features import extract_features

    c = tiny(cell)
    cfg = run.system_config(c.config["system"])
    batch = generator.make_batch(generator.Traffic(sequences=1, frames=1), SEED,
                                 _camera_and_noise(cell)[0], 16, "cpu")
    got = extract_features(batch.images[0, 1], cfg.frontend)
    ref = reference.extract(batch.images[0, 1:2], c.config["system"]["frontend"],
                            reference.STATED)
    # Keypoint for keypoint, but for a rare one that round-off moves across
    # a top-k or score threshold (the CPU's vector math differs between
    # calls by an ulp now and then).
    same = (got.uv == ref.uv[0]).all(-1) & (got.mask == ref.mask[0])
    assert same.float().mean() > 0.99
    assert (got.desc - ref.desc[0])[same].abs().max() < 1e-5


def test_reference_draws_are_the_ports():
    from vislam_tpu_torch.utils import prng

    key = prng.fold_in(prng.split(prng.prng_key(123456789), 5)[3], 7)
    logits = torch.log(torch.tensor(np.random.default_rng(0).random(300) > 0.3,
                                    dtype=torch.float32) + 1e-9)
    want = prng.categorical(torch.as_tensor(key.astype(np.int64)), logits, (64,))
    k = reference.fold_in(reference.fold_in(reference.prng_key(123456789, "cpu"), 3), 7)
    assert torch.equal(reference.categorical(k, logits, 64, torch.float32), want)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_prints_a_correct_line(cell):
    out = run.run_cell(tiny(cell), SEED, 0.0, False, device="cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 8
    assert set(out["metrics"]) == {"frames_per_s", "ate_rmse_m", "setup_s"}
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())


def _state_unchanged(monkeypatch):
    from vislam_tpu_torch.engine.engine import VIOEngine
    step = VIOEngine._step

    def stale(self, state, *a, **k):
        return state, step(self, state, *a, **k)[1]
    monkeypatch.setattr(VIOEngine, "_step", stale)


def _half_batch(monkeypatch):
    from vislam_tpu_torch.engine import batch as batch_mod
    scan = batch_mod.run_batch_scan

    def half(eng, states, inputs, kf0, seed=0, **k):
        h = inputs.images.shape[0] // 2
        first = type(inputs)(*[x[:h] for x in inputs[:4]], inputs.use_gt_scale)
        s, r = scan(eng, type(states)(*[_first(x, h) for x in states]), first, kf0[:h], seed, **k)
        return s, type(r)(*[torch.cat([x, x]) for x in r])
    monkeypatch.setattr(batch_mod, "run_batch_scan", half)


def _first(x, h):
    return type(x)(*[_first(y, h) for y in x]) if isinstance(x, tuple) else x[:h]


def _answer_altered(monkeypatch):
    from vislam_tpu_torch.engine.engine import VIOEngine
    step = VIOEngine._step

    def moved(self, *a, **k):
        s, r = step(self, *a, **k)
        return s, r._replace(p_wc=r.p_wc + torch.tensor([0.01, 0.0, 0.0]))
    monkeypatch.setattr(VIOEngine, "_step", moved)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_check_fails_under_each_fault(fault, monkeypatch):
    fault(monkeypatch)
    out = run.run_cell(tiny("sift_b512"), SEED, 0.0, False, device="cpu")
    assert not out["correct"]


def _one_frame_in_32(monkeypatch):
    """One frame's translation direction turned by 60 degrees (a frame
    solved wrong) where the batch loop hands it out."""
    from vislam_tpu_torch.engine import batch as batch_mod
    scan = batch_mod.run_batch_scan
    c, s = np.cos(np.radians(60.0)), np.sin(np.radians(60.0))

    def off(*a, **k):
        state, r = scan(*a, **k)
        t = r.t_dir_cam.clone()
        if t.shape[1] < 8:      # the warm-up pass
            return state, r
        x, z = t[1, 3, 0].clone(), t[1, 3, 2].clone()
        t[1, 3, 0], t[1, 3, 2] = c * x + s * z, c * z - s * x
        return state, r._replace(t_dir_cam=t)
    monkeypatch.setattr(batch_mod, "run_batch_scan", off)


def test_check_fails_a_fault_confined_to_a_few_frames(monkeypatch):
    """A fault on 1 frame in 32 (3%) passes every 90th percentile; the
    widest gap fails it."""
    _one_frame_in_32(monkeypatch)
    c = tiny("sift_b512")
    c.traffic = {**c.traffic, "sequences": 4}
    c.config = {**c.config, "frames": 8}
    c.workload = {**c.workload, "sample_frames": 32}
    out = run.run_cell(c, SEED, 0.0, False, device="cpu")
    checks = out["checks"]
    assert not out["correct"]
    assert checks["t_dir_gap_p90_deg"]["value"] <= checks["t_dir_gap_p90_deg"]["limit"]
    assert checks["t_dir_gap_max_deg"]["value"] > checks["t_dir_gap_max_deg"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    c = tiny(cell)
    out = run.run_cell(c, SEED + 1, 0.0, False, device="cpu", control=True)
    assert out["correct"]
    limits = c.workload["limits"]
    assert any(out["control"][k] > limits[k] for k in check.NUMBERS)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, card):
    c = run.load_cell(cell)
    c.traffic = {**c.traffic, "sequences": 8}
    out = run.run_cell(c, SEED, 1.0, True)
    assert out["correct"] and out["device"]["busy_s"] > 0
