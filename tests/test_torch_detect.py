"""vislam_tpu_torch against vislam_tpu: kernel 1's plain twins (the six
response families + 5x5 NMS), the pyramid, keypoint selection, descriptors
and extract_features.

Kernel 1 itself runs only on a CUDA card; chip_smoke.py holds it against
these plain twins there. Here the twins are held against the reference's
Pallas kernel in interpret mode (as tests/test_ops.py runs it) and against
the reference's XLA path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.frontend import descriptor as jdesc
from vislam_tpu.frontend import detect as jdet
from vislam_tpu.frontend.features import extract_features as j_extract
from vislam_tpu.frontend.pyramid import build_pyramid as j_pyramid
from vislam_tpu.frontend.pyramid import gaussian_blur as j_blur
from vislam_tpu.frontend.pyramid import scharr_gradients as j_scharr
from vislam_tpu.ops.harris_kernel import harris_nms_pallas
from vislam_tpu.utils.config import FrontendConfig as JFrontend
from vislam_tpu_torch.frontend import descriptor as tdesc
from vislam_tpu_torch.frontend import detect as tdet
from vislam_tpu_torch.frontend.features import extract_features as t_extract
from vislam_tpu_torch.frontend.pyramid import build_pyramid as t_pyramid
from vislam_tpu_torch.frontend.pyramid import gaussian_blur as t_blur
from vislam_tpu_torch.frontend.pyramid import scharr_gradients as t_scharr
from vislam_tpu_torch.ops.harris_kernel import FAMILIES, response_nms
from vislam_tpu_torch.utils.config import FrontendConfig as TFrontend

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frame():
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=2, n_landmarks=300, seed=3))
    return seq["images"][1].astype(np.float32)


def _key(feat, mask=True):
    uv = np.asarray(feat.uv)
    lv = np.asarray(feat.level)
    m = np.asarray(feat.mask)
    return {(int(l), int(round(float(u))), int(round(float(v))))
            for (u, v), l, ok in zip(uv, lv, m) if ok or not mask}


@pytest.mark.parametrize("shape", [(240, 376), (120, 188)])
def test_response_nms_matches_pallas_interpret(frame, shape):
    """Same bounds as tests/test_ops.py: rtol 5e-3 / atol 5e-2 on the
    interior (the Pallas kernel's roll-wrap halo and the twin's SAME
    padding differ only near the image border), NMS agreement > 0.995."""
    img = frame[: shape[0], : shape[1]]
    p_nms, p_resp = harris_nms_pallas(jnp.asarray(img), interpret=True)
    t_nms, t_resp = response_nms(torch.from_numpy(img.copy()), "shi_tomasi")
    inner = np.s_[12:-12, 12:-12]
    np.testing.assert_allclose(t_resp.numpy()[inner], np.asarray(p_resp)[inner],
                               rtol=5e-3, atol=5e-2)
    agree = (np.isneginf(t_nms.numpy()[inner]) == np.isneginf(np.asarray(p_nms)[inner]))
    assert agree.mean() > 0.995, agree.mean()


def test_response_nms_tile_rows_is_checked(frame):
    """`tile_rows` picks the CUDA kernel's tile height for the on-card
    checks; the plain version has no tiles, so every allowed value gives
    the default's result, and any other value raises on every device."""
    img = torch.from_numpy(frame[:40, :60].copy())
    base = response_nms(img, "shi_tomasi")
    for rows in (8, 16, 32):
        got = response_nms(img, "shi_tomasi", tile_rows=rows)
        assert all(torch.equal(a, b) for a, b in zip(got, base))
    with pytest.raises(ValueError, match="tile_rows"):
        response_nms(img, "shi_tomasi", tile_rows=12)


def test_response_nms_matches_xla_f32_everywhere(frame):
    """Against the reference's XLA response + reduce_window NMS at float32:
    the same SAME padding, so the whole field agrees, borders included."""
    img = frame[:120, :188]
    ref = np.asarray(jdet.harris_response(jnp.asarray(img)))
    ref_nms = np.asarray(jdet._nms(jnp.asarray(ref), 2))
    t_nms, t_resp = response_nms(torch.from_numpy(img.copy()), "shi_tomasi")
    np.testing.assert_allclose(t_resp.numpy(), ref, rtol=5e-3, atol=5e-2)
    assert (np.isneginf(t_nms.numpy()) == np.isneginf(ref_nms)).mean() > 0.995
    # Batched input: one call over a (B, H, W) stack equals per-image calls.
    b_nms, b_resp = response_nms(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    np.testing.assert_array_equal(b_resp[0].numpy(), t_resp.numpy())


# Where each family's twin agrees with the reference on the whole field:
# XLA's SAME padding for the families XLA has (fast excepted: XLA wraps
# around, the port and the TPU kernel read zeros) and the TPU kernel's
# zero-padding-once for _gradmag2 and fast. Elsewhere they agree in the
# interior (12 px in, as tests/test_ops.py holds the TPU kernel).
WHOLE_FIELD_XLA = {"shi_tomasi", "harris", "dog", "hessian"}
WHOLE_FIELD_PALLAS = {"dog", "fast", "_gradmag2"}


def _rel_err(a, b, sl=np.s_[:, :]):
    scale = max(1.0, np.abs(b[sl]).max())
    return np.abs(a[sl] - b[sl]).max() / scale


@pytest.mark.parametrize("det", FAMILIES)
def test_family_twin_matches_pallas_interpret(det):
    """Each family's plain twin against the reference's Pallas kernel in
    interpret mode, on random pixels (tests/test_ops.py's input and bounds):
    error / scale < 1e-4 and NMS agreement > 0.999 in the interior, and on
    the whole field where both pad alike."""
    img = np.random.default_rng(3).uniform(0, 255, (96, 136)).astype(np.float32)
    p_nms, p_resp = (None if x is None else np.asarray(x)
                     for x in harris_nms_pallas(jnp.asarray(img), interpret=True, detector=det))
    t_nms, t_resp = response_nms(torch.from_numpy(img), det)
    t_resp = t_resp.numpy()
    inner = np.s_[12:-12, 12:-12]
    assert _rel_err(t_resp, p_resp, inner) < 1e-4
    if det in WHOLE_FIELD_PALLAS:
        assert _rel_err(t_resp, p_resp) < 1e-4
    if det == "_gradmag2":
        assert t_nms is None
    else:
        agree = np.isneginf(t_nms.numpy()[inner]) == np.isneginf(p_nms[inner])
        assert agree.mean() > 0.999, agree.mean()


@pytest.mark.parametrize("det", sorted(jdet.DETECTOR_RESPONSES))
def test_family_twin_matches_xla_response(det):
    """Each family's plain twin against the reference's XLA response and
    its reduce_window NMS, float32, same bounds as above."""
    img = np.random.default_rng(4).uniform(0, 255, (96, 136)).astype(np.float32)
    ref = np.asarray(jdet.DETECTOR_RESPONSES[det](jnp.asarray(img)))
    ref_nms = np.asarray(jdet._nms(jnp.asarray(ref), 2))
    t_nms, t_resp = response_nms(torch.from_numpy(img), det)
    t_resp = t_resp.numpy()
    inner = np.s_[12:-12, 12:-12]
    assert _rel_err(t_resp, ref, inner) < 1e-4
    agree = np.isneginf(t_nms.numpy()[inner]) == np.isneginf(ref_nms[inner])
    assert agree.mean() > 0.999, agree.mean()
    if det in WHOLE_FIELD_XLA:
        assert _rel_err(t_resp, ref) < 1e-4
        assert (np.isneginf(t_nms.numpy()) == np.isneginf(ref_nms)).mean() > 0.999
    # The port's names for the plain responses are the reference's.
    assert tdet.DETECTOR_RESPONSES[det](torch.from_numpy(img)).shape == img.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blur_and_scharr_match_reference(frame, dtype):
    """gaussian_blur and scharr_gradients: SAME zero padding on the whole
    field. float32: round-off (1e-5 relative). bfloat16: both round every
    pass to bf16 (taps too), so they agree to one bf16 step (2^-8
    relative) where the two frameworks' float32 sums straddle a rounding
    boundary."""
    img = frame[:96, :136]
    j_img = jnp.asarray(img, jnp.dtype(dtype))
    t_img = torch.from_numpy(img.copy()).to(getattr(torch, dtype))
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    for sigma, r in ((1.0, 3), (1.6, 4), (2.0, 3), (1.0, 2)):
        j = np.asarray(j_blur(j_img, sigma, radius=r).astype(jnp.float32))
        t = t_blur(t_img, sigma, radius=r).float().numpy()
        np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 255)
    for a, b in zip(t_scharr(t_img), j_scharr(j_img)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=rtol, atol=rtol * 255)


def test_pyramid_is_bit_identical_in_bf16(frame):
    j = j_pyramid(jnp.asarray(frame, jnp.bfloat16), 3)
    t = t_pyramid(torch.from_numpy(frame.copy()).to(torch.bfloat16), 3)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())


def test_selection_matches_reference_on_same_response(frame):
    """Grid top-k, subpixel refinement and orientation fed the reference's
    own response field: the same keypoint set (tie order may differ), and
    per keypoint the same refined uv and angle."""
    img = jnp.asarray(frame)
    resp = jdet.harris_response(img)
    nms = jdet._nms(resp, 2)
    juv, jscore = jdet._grid_topk(nms, 8, 8, 8, 12)
    tuv, tscore = tdet._grid_topk(torch.from_numpy(np.array(nms)), 8, 8, 8, 12)
    ja = {tuple(r) for r in np.asarray(juv)[np.isfinite(np.asarray(jscore))]}
    ta = {tuple(r) for r in tuv.numpy()[np.isfinite(tscore.numpy())]}
    assert ja == ta
    np.testing.assert_allclose(np.sort(tscore.numpy()), np.sort(np.asarray(jscore)))
    uv = np.array(juv)
    j_ref = np.array(jdet._subpixel_refine(resp, jnp.asarray(uv)))
    t_ref = tdet._subpixel_refine(torch.from_numpy(np.array(resp)), torch.from_numpy(uv))
    np.testing.assert_allclose(t_ref.numpy(), j_ref, rtol=1e-6, atol=1e-5)
    j_ang = np.asarray(jdet._orientations(img, jnp.asarray(j_ref)))
    t_ang = tdet._orientations(torch.from_numpy(frame.copy()), torch.from_numpy(j_ref))
    d = np.angle(np.exp(1j * (t_ang.numpy() - j_ang)))
    assert np.abs(d).max() < 1e-3


def test_descriptors_of_identical_keypoints_agree(frame, rng):
    """Same level, same uv: the descriptors agree to f32 round-off (~1e-5 on
    unit-norm 128-vectors; the contractions sum in another order)."""
    uv = rng.uniform(14, [frame.shape[1] - 14, frame.shape[0] - 14], (256, 2)).astype(np.float32)
    uv[0] = [3.0, 2.0]                       # clipped patch at a corner
    uv[1] = [frame.shape[1] - 2.5, frame.shape[0] - 1.2]
    j = np.asarray(jdesc.describe_keypoints(jnp.asarray(frame), jnp.asarray(uv),
                                            jnp.zeros(256), upright=True))
    geom = tdesc.DescriptorGeometry("cpu")
    t = tdesc.describe_keypoints(torch.from_numpy(frame.copy()), torch.from_numpy(uv), geom)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=2e-5)


def test_extract_features_float32_matches_reference(frame):
    """With a float32 image pipeline both packages compute the response in
    float32 from the same pixels: identical keypoints and descriptors."""
    cfg_j, cfg_t = JFrontend(image_dtype="float32"), TFrontend(image_dtype="float32")
    j = j_extract(jnp.asarray(frame), cfg_j)
    t = t_extract(torch.from_numpy(frame.copy()), cfg_t)
    assert t.uv.shape == (768, 2) and t.desc.shape == (768, 128)
    assert _key(t) == _key(j)
    # Row by row where the rows coincide (ties may permute rows).
    same = np.all(np.abs(t.uv.numpy() - np.asarray(j.uv)) < 1e-3, -1)
    assert same.mean() > 0.95
    np.testing.assert_allclose(t.desc.numpy()[same], np.asarray(j.desc)[same],
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(t.level.numpy(), np.asarray(j.level))


def test_extract_features_default_overlaps_reference(frame):
    """Default bf16 pipeline. The reference's CPU path computes the response
    in bf16 (XLA convs on the bf16 level) while the port follows the TPU
    kernel and computes it in float32 on the same bf16 level, so subpixel
    positions differ and near-equal corners can swap. Measured overlap of
    the valid keypoint sets at integer-pixel resolution: 0.983 on this
    frame; required: 0.95."""
    j = j_extract(jnp.asarray(frame), JFrontend())
    t = t_extract(torch.from_numpy(frame.copy()), TFrontend())
    a, b = _key(j), _key(t)
    overlap = len(a & b) / max(len(a), 1)
    assert overlap >= 0.95, overlap
    assert abs(len(a) - len(b)) <= 0.02 * len(a)


@pytest.mark.parametrize("radius", [1, 3])
def test_nms_radius_matches_reference_detector(frame, radius):
    """frontend.nms_radius 1 and 3: the port takes the response (the
    kernel's raw field on the card, the plain twin here) through the
    (2r+1)^2 NMS, as the reference routes any radius but 2; with the
    float32 image pipeline both detect the same keypoints, and the radius
    changes which ones (against radius 2)."""
    cfg_j = JFrontend(image_dtype="float32", nms_radius=radius)
    cfg_t = TFrontend(image_dtype="float32", nms_radius=radius)
    j = j_extract(jnp.asarray(frame), cfg_j)
    t = t_extract(torch.from_numpy(frame.copy()), cfg_t)
    assert _key(t) == _key(j)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert _key(t) != _key(t_extract(torch.from_numpy(frame.copy()),
                                     TFrontend(image_dtype="float32")))
