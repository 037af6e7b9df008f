"""vislam_tpu_torch against vislam_tpu: the PNG codec (against OpenCV's
decoder), the EuRoC, TUM and KITTI readers, the prefetching loader,
stage_dataset, the OpenCV-XML calibration, the static bias calibration and
the undistortion maps and remap.

The readers are held on fixtures written by the reference's writers
(`vislam_tpu/data/synthetic.py::write_euroc_fixture`, cv2 for the TUM and
KITTI layouts and the XML), so the port reads files it did not write; the
port's own fixture writer is held against the reference's files.
"""

import filecmp
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.calib import camera_model as jcam
from vislam_tpu.calib import presets as jpresets
from vislam_tpu.data import EurocDataset as JEuroc
from vislam_tpu.data import KittiDataset as JKitti
from vislam_tpu.data import PrefetchLoader as JLoader
from vislam_tpu.data import SyntheticConfig as JSynCfg
from vislam_tpu.data import TumDataset as JTum
from vislam_tpu.data import make_synthetic_sequence as j_make_seq
from vislam_tpu.data import write_euroc_fixture as j_write_fixture
from vislam_tpu.engine import stage_dataset as j_stage_dataset
from vislam_tpu.inertial import bias as jbias
from vislam_tpu_torch.calib import camera_model as tcam
from vislam_tpu_torch.calib import presets as tpresets
from vislam_tpu_torch.data import EurocDataset as TEuroc
from vislam_tpu_torch.data import KittiDataset as TKitti
from vislam_tpu_torch.data import PrefetchLoader as TLoader
from vislam_tpu_torch.data import SyntheticConfig as TSynCfg
from vislam_tpu_torch.data import TumDataset as TTum
from vislam_tpu_torch.data import png
from vislam_tpu_torch.data import write_euroc_fixture as t_write_fixture
from vislam_tpu_torch.engine import stage_dataset as t_stage_dataset
from vislam_tpu_torch.inertial import bias as tbias

torch.set_num_threads(2)


def _t_calib(c):
    """The reference's CameraCalib as the port's."""
    return tcam.CameraCalib(**{f: getattr(c, f) for f in (
        "fx", "fy", "cx", "cy", "dist", "width", "height", "T_body_cam", "rate_cam_hz",
        "rate_imu_hz")})


def _same_windows(a, b):
    """Two FrameWindows equal field for field (arrays exactly, None alike)."""
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=name)
            assert np.asarray(y).dtype == np.asarray(x).dtype, name


# ---------------------------------------------------------------- PNG


def _textured(rng, shape):
    """Smooth ramps plus noise: libpng picks different filters per row."""
    h, w = shape[:2]
    ramp = np.add.outer(np.arange(h), 2 * np.arange(w)) % 256
    noise = rng.integers(0, 40, shape)
    return ((ramp[..., None] if len(shape) == 3 else ramp) + noise).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_equals_opencv(tmp_path, rng, channels):
    """cv2-written grey, RGB and RGBA files (libpng's adaptive filters)
    decode to exactly cv2.imread(..., IMREAD_GRAYSCALE)."""
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, _textured(rng, shape))
    np.testing.assert_array_equal(png.read_png_grey(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _png_with_filters(img, filters):
    """A PNG of uint8 (H, W[, C]) with row y written by filter filters[y]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), per the PNG specification."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = filters[y]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    colour = {1: 0, 3: 2, 4: 6}[bpp]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_each_filter_type_decodes_exactly(rng, channels, kind):
    """Every row written with one filter type (and a mix after it) decodes
    exactly, by the C++ unfilter and by its numpy twin, which agree."""
    shape = (9, 13) if channels == 1 else (9, 13, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    filters = [kind] * 5 + [0, 1, 2, 3, 4]
    data = _png_with_filters(np.concatenate([img, img[:1]]), filters)
    want = np.concatenate([img, img[:1]])
    got = png.decode_png(data)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(png.decode_png(data, unfilter_fn=png.unfilter_plain), got)


def test_png_unfilter_equals_numpy_twin_on_random_rows(rng):
    """Random filter bytes and payloads: C++ and numpy reconstruct the same rows."""
    for bpp, stride in [(1, 40), (3, 33), (4, 64)]:
        h = 12
        raw = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        np.testing.assert_array_equal(png.unfilter(raw.tobytes(), h, stride, bpp),
                                      png.unfilter_plain(raw.tobytes(), h, stride, bpp))


def test_png_encode_roundtrip_and_unsupported_raise(tmp_path, rng):
    grey = rng.integers(0, 256, (21, 34)).astype(np.uint8)
    rgb = rng.integers(0, 256, (21, 34, 3)).astype(np.uint8)
    np.testing.assert_array_equal(png.decode_png(png.encode_png(grey)), grey)
    np.testing.assert_array_equal(png.decode_png(png.encode_png(rgb)), rgb)
    path = str(tmp_path / "g.png")
    png.write_png(path, grey)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), grey)
    cv2.imwrite(str(tmp_path / "w.png"), (grey.astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png_grey(str(tmp_path / "w.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


# ---------------------------------------------------------------- readers


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("euroc"))
    j_write_fixture(path, JSynCfg(n_frames=18, n_landmarks=120, seed=3), static_prefix_s=1.0)
    return path


def test_fixture_writer_writes_the_reference_files(tmp_path, euroc_dir):
    """The port's writer: the same CSV text, images that decode to the same
    pixels (its own PNG encoder)."""
    t_write_fixture(str(tmp_path), TSynCfg(n_frames=18, n_landmarks=120, seed=3),
                    static_prefix_s=1.0)
    for rel in ("imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert filecmp.cmp(os.path.join(euroc_dir, "mav0", rel),
                           os.path.join(str(tmp_path), "mav0", rel), shallow=False), rel
    cam = os.path.join("mav0", "cam0", "data")
    names = sorted(os.listdir(os.path.join(euroc_dir, cam)))
    assert names == sorted(os.listdir(os.path.join(str(tmp_path), cam)))
    for n in names[::5]:
        np.testing.assert_array_equal(
            png.read_png_grey(os.path.join(str(tmp_path), cam, n)),
            cv2.imread(os.path.join(euroc_dir, cam, n), cv2.IMREAD_GRAYSCALE))


def test_euroc_reader_equals_reference(euroc_dir):
    j, t = JEuroc(euroc_dir), TEuroc(euroc_dir)
    assert (len(t), t.start_index) == (len(j), j.start_index)
    np.testing.assert_array_equal(t.image_t_ns, j.image_t_ns)
    for k in range(t.start_index, len(t)):
        _same_windows(j.frame_window(k), t.frame_window(k))
    for a, b in zip(j.static_imu_prefix(2.5), t.static_imu_prefix(2.5)):
        np.testing.assert_array_equal(b, a)


def test_prefetch_loader_equals_reference(euroc_dir):
    """Same frames in the same order; pinning needs a card, so the CPU test
    reads unpinned (the image stays numpy)."""
    j, t = JEuroc(euroc_dir), TEuroc(euroc_dir)
    jl, tl = list(JLoader(j, start=3, end=12)), list(TLoader(t, start=3, end=12))
    assert [f.index for f in tl] == [f.index for f in jl] == list(range(3, 12))
    for a, b in zip(jl, tl):
        _same_windows(a, b)
    loader = TLoader(t, start=2, end=6)
    assert len(list(loader)) == 4 and loader.frames_read == 4 and loader.read_seconds > 0
    # A consumer that stops early leaves no worker behind.
    it = iter(TLoader(t, start=1))
    next(it)
    it.close()


def test_stage_dataset_equals_reference(euroc_dir):
    j, t = JEuroc(euroc_dir), TEuroc(euroc_dir)
    a = j_stage_dataset(j, 2, 14)
    b = t_stage_dataset(t, 2, 14, device="cpu")
    for name in ("images", "imu", "imu_dt", "gt_pos"):
        x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)
    assert b.use_gt_scale is bool(a.use_gt_scale) is True


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory, rng=np.random.default_rng(1)):
    """A TUM RGB-D layout with colour images, an accelerometer and GT."""
    root = tmp_path_factory.mktemp("tum")
    seq = j_make_seq(JSynCfg(n_frames=8, n_landmarks=80, seed=4))
    os.makedirs(root / "rgb")
    t_img = 1305031102.175304 + 0.0333 * np.arange(8)
    with open(root / "rgb.txt", "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for k, img in enumerate(seq["images"]):
            colour = np.stack([img, np.roll(img, 3, 1), 255 - img], -1)
            cv2.imwrite(str(root / "rgb" / f"{t_img[k]:.6f}.png"), colour)
            f.write(f"{t_img[k]:.6f} rgb/{t_img[k]:.6f}.png\n")
    with open(root / "groundtruth.txt", "w") as f:
        f.write("# ground truth trajectory\n")
        for k in range(24):
            p, q = rng.normal(size=3), rng.normal(size=4)
            f.write(f"{t_img[0] - 0.02 + 0.011 * k:.4f} " + " ".join(f"{x:.4f}" for x in
                                                                    (*p, *q)) + "\n")
    with open(root / "accelerometer.txt", "w") as f:
        f.write("# accelerometer data\n")
        for k in range(60):
            a = rng.normal(size=3) + [0, 0, 9.8]
            f.write(f"{t_img[0] - 0.01 + 0.004 * k:.6f} " + " ".join(f"{x:.6f}" for x in a)
                    + "\n")
    return str(root)


def test_tum_reader_equals_reference(tum_dir):
    j, t = JTum(tum_dir), TTum(tum_dir)
    assert len(t) == len(j) == 8
    for k in range(1, len(t)):
        _same_windows(j.frame_window(k), t.frame_window(k))


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """The KITTI odometry layout with colour images (image_2) and poses."""
    from scipy.spatial.transform import Rotation as Rsp

    root = tmp_path_factory.mktemp("kitti")
    seq = j_make_seq(JSynCfg(n_frames=6, n_landmarks=80, seed=6))
    img_dir = root / "sequences" / "04" / "image_2"
    os.makedirs(img_dir)
    os.makedirs(root / "poses")
    for k, img in enumerate(seq["images"]):
        cv2.imwrite(str(img_dir / f"{k:06d}.png"), np.stack([img, img // 2, 255 - img], -1))
    np.savetxt(str(root / "sequences" / "04" / "times.txt"), np.arange(6) * 0.1, fmt="%.6e")
    with open(root / "poses" / "04.txt", "w") as f:
        for q, p in zip(seq["gt_quat"], seq["gt_pos"]):
            R = Rsp.from_quat(np.roll(q, -1)).as_matrix()
            f.write(" ".join(f"{x:.9e}" for x in np.hstack([R, p[:, None]]).reshape(-1)) + "\n")
    return str(root)


def test_kitti_reader_equals_reference(kitti_dir):
    """Equal windows; the GT quaternion (float32 mat_to_quat in both) within
    1e-6 (two implementations of one branch-free formula, float32)."""
    j, t = JKitti(kitti_dir, "04"), TKitti(kitti_dir, "04")
    assert len(t) == len(j) == 6
    for k in range(1, len(t)):
        a, b = j.frame_window(k), t.frame_window(k)
        np.testing.assert_allclose(b.gt_quat, a.gt_quat, atol=1e-6)
        b.gt_quat = a.gt_quat
        _same_windows(a, b)


# ---------------------------------------------------------------- calibration


def test_opencv_xml_loads_as_the_reference_does(tmp_path):
    """A cv2-written XML (3x3 and 4x4 matrices, a 1-D distortion array,
    integer and real scalars), and one with fields missing (defaults);
    the port's writer round-trips through both loaders.

    The rates differ by design: the reference reads camera_rate and
    imu_rate after `fs.release()` (`vislam_tpu/calib/presets.py:83-95`),
    where every node is empty, so it always returns the defaults 20 / 200
    Hz; the port returns the values in the file."""
    xml = str(tmp_path / "c.xml")
    fs = cv2.FileStorage(xml, cv2.FILE_STORAGE_WRITE)
    fs.write("camera_matrix", jpresets.euroc_calib().K)
    fs.write("distortion_coefficients", np.asarray(jpresets.euroc_calib().dist))
    fs.write("image_width", 640)
    fs.write("image_height", 400)
    fs.write("camera_rate", 30.0)
    fs.write("imu_rate", 400.0)
    fs.write("imu2cam0", np.arange(16, dtype=np.float32).reshape(4, 4))
    fs.release()
    short = str(tmp_path / "s.xml")
    fs = cv2.FileStorage(short, cv2.FILE_STORAGE_WRITE)
    fs.write("camera_matrix", np.diag([300.0, 310.0, 1.0]))
    fs.release()
    written = str(tmp_path / "w.xml")
    tpresets.write_opencv_xml(written, _t_calib(jpresets.euroc_calib()))
    for path in (xml, short, written):
        a, b = jpresets.load_opencv_xml(path), tpresets.load_opencv_xml(path)
        for f in ("fx", "fy", "cx", "cy", "width", "height"):
            assert getattr(a, f) == getattr(b, f), (path, f)
        assert (a.rate_cam_hz, a.rate_imu_hz) == (20.0, 200.0)
        assert (b.rate_cam_hz, b.rate_imu_hz) == ((30.0, 400.0) if path == xml else
                                                  (20.0, 200.0))
        assert tuple(map(float, a.dist)) == tuple(map(float, b.dist))
        np.testing.assert_array_equal(b.T_body_cam, a.T_body_cam)
    b = tpresets.load_opencv_xml(written)
    assert b.dist == jpresets.euroc_calib().dist
    np.testing.assert_array_equal(b.T_body_cam, jpresets.euroc_calib().T_body_cam)


def test_presets_equal_reference():
    for name in ("euroc_calib", "kitti_calib", "tum_calib"):
        a, b = getattr(jpresets, name)(), getattr(tpresets, name)()
        assert (a.fx, a.fy, a.cx, a.cy, a.dist, a.width, a.height, a.rate_cam_hz,
                a.rate_imu_hz, a.has_distortion) == (
            b.fx, b.fy, b.cx, b.cy, b.dist, b.width, b.height, b.rate_cam_hz,
            b.rate_imu_hz, b.has_distortion)
        np.testing.assert_array_equal(b.T_body_cam, a.T_body_cam)
        np.testing.assert_array_equal(b.K, a.K)


# ---------------------------------------------------------------- bias


def test_static_bias_calibration_equals_reference(rng):
    """A static prefix, a motion burst, a constant-rate spin: the mask is
    equal and the bias estimates agree within 1e-6 (float32 sums in
    another order)."""
    n = 500
    g = (rng.normal(size=(n, 3)) * 0.003 + [0.01, -0.02, 0.005]).astype(np.float32)
    a = (rng.normal(size=(n, 3)) * 0.02 + [0.1, -0.05, 9.81]).astype(np.float32)
    g[200:240] += rng.normal(size=(40, 3)).astype(np.float32)
    a[200:240] += 3 * rng.normal(size=(40, 3)).astype(np.float32)
    g[400:] += np.float32(0.5)
    mj = np.asarray(jbias.static_mask(jnp.asarray(g), jnp.asarray(a)))
    mt = tbias.static_mask(torch.from_numpy(g), torch.from_numpy(a))
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert 150 < mj.sum() < 400
    gt, at = torch.from_numpy(g), torch.from_numpy(a)
    R = np.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    pairs = [
        (jbias.calibrate_gyro_bias(jnp.asarray(g), jnp.asarray(mj)),
         tbias.calibrate_gyro_bias(gt, mt)),
        (jbias.calibrate_gyro_bias(jnp.asarray(g)), tbias.calibrate_gyro_bias(gt)),
        (jbias.calibrate_accel_bias(jnp.asarray(a), jnp.asarray(mj)),
         tbias.calibrate_accel_bias(at, mt)),
        (jbias.calibrate_accel_bias(jnp.asarray(a), jnp.asarray(mj), R_wb=jnp.asarray(R)),
         tbias.calibrate_accel_bias(at, mt, R_wb=torch.from_numpy(R))),
    ]
    for x, y in pairs:
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- undistortion


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_undistort_maps_and_remap_equal_reference(rng, alpha):
    """EuRoC's radtan camera: the maps within 1e-3 px and the rectified
    intrinsics within 1e-6 relative (both float32 on the host); the remap of
    a uint8 and a float32 image within 1e-3 grey levels, with maps shifted
    so that whole rows and columns sample outside the image (zero border)."""
    jc = jpresets.euroc_calib()
    mj, cj = jcam.compute_undistort_maps(jc, alpha=alpha)
    mt, ct = tcam.compute_undistort_maps(_t_calib(jc), alpha=alpha)
    np.testing.assert_allclose(mt, mj, atol=1e-3, rtol=0)
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(ct, f), getattr(cj, f), rtol=1e-6)
    maps = mj + np.float32([-30.0, 20.0])
    assert (maps[..., 0] < 0).any() and (maps[..., 1] > jc.height - 1).any()
    img = rng.integers(0, 256, (jc.height, jc.width)).astype(np.uint8)
    for x in (img, img.astype(np.float32) / 3.0):
        want = np.asarray(jcam.remap_bilinear(jnp.asarray(x), jnp.asarray(maps)))
        got = tcam.remap_bilinear(torch.from_numpy(x), torch.from_numpy(maps)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    rgb = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    small = np.stack(np.meshgrid(np.linspace(-3, 62, 50), np.linspace(-2, 41, 30)),
                     -1).astype(np.float32)
    want = np.asarray(jcam.undistort_image(jnp.asarray(rgb), small))
    got = tcam.undistort_image(torch.from_numpy(rgb), small).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
