"""vislam_tpu_torch against vislam_tpu: the nonlinear scale space (kernel 3's
plain twin, FED diffusion), the contrast factor, BRIEF descriptors, and the
constants the CUDA sources carry.

Kernel 3 itself runs only on a CUDA card; chip_smoke.py holds it against
the plain twin there. The port implements the reference's TPU branch on
every device (the TPU kernel's FED borders, the `_gradmag2`-kernel contrast
factor), so it is held against that branch composed from the JAX package's
public functions with the Pallas kernels in interpret mode, and against the
reference's XLA `evolve` in the interior (4n px in, where its per-step
padding cannot reach).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.frontend import binary_desc as jbin
from vislam_tpu.frontend import nonlinear as jnl
from vislam_tpu.frontend.pyramid import gaussian_blur as j_blur
from vislam_tpu.ops.fed_kernel import fed_evolve_pallas
from vislam_tpu.ops.harris_kernel import harris_nms_pallas
from vislam_tpu_torch.frontend import binary_desc as tbin
from vislam_tpu_torch.frontend import nonlinear as tnl
from vislam_tpu_torch.frontend.pyramid import gaussian_taps
from vislam_tpu_torch.ops import fed_kernel as tfed

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vislam_tpu_torch", "ops", "csrc")


@pytest.fixture(scope="module")
def frame():
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=2, n_landmarks=300, seed=0))
    return seq["images"][0].astype(np.float32)


@pytest.mark.parametrize("T", [0.5, 0.78, 1.28, 3.84, 10.0])
def test_fed_tau_steps_equal_reference(T):
    assert tnl.fed_tau_steps(T) == jnl.fed_tau_steps(T)


@pytest.mark.parametrize("T", [0.78, 3.84])
def test_fed_twin_matches_pallas_and_evolve(T):
    """Against fed_evolve_pallas(interpret=True) on the whole field of a
    batch of two (edge extension once: the same border semantics), and
    against the XLA `evolve` 4n px in (tests/test_ops.py's 1e-4 on a [0, 1]
    field; measured 3e-6 at n = 8)."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (72, 104)).astype(np.float32)
    taus = tuple(jnl.fed_tau_steps(T))
    batch = np.stack([img, img * 0.5])
    ks = np.array([0.1, 0.2], np.float32)
    p = np.asarray(fed_evolve_pallas(jnp.asarray(batch), jnp.asarray(ks), taus, interpret=True))
    t = tfed.fed_evolve(torch.from_numpy(batch), torch.from_numpy(ks), taus).numpy()
    assert t.dtype == np.float32 and t.shape == batch.shape
    assert np.abs(t - p).max() < 1e-5
    b = 4 * len(taus)
    x = np.asarray(jnl.evolve(jnp.asarray(img), 0.1, T))
    assert np.abs(x[b:-b, b:-b] - t[0, b:-b, b:-b]).max() < 1e-4
    # An (H, W) field with a 0-d k: the first of the batch, to the round-off
    # of a convolution run at another batch size.
    one = tfed.fed_evolve(torch.from_numpy(img), torch.tensor(0.1), taus).numpy()
    np.testing.assert_allclose(one, t[0], rtol=0, atol=1e-6)


def _fed_by_schedule(x, k, taus, s):
    """What the kernel computes, launch by launch along fed_schedule: each
    launch's output tiles (the kernel's TILE) cut from its source with the
    schedule's halo, row and column indices clamped into the source (the
    edge extension, for the first launch), stepped by the plain twin's
    step, and cropped by the halo."""
    B, H, W = x.shape
    th, tw = tfed.TILE
    kb = k.reshape(B, 1, 1)
    src = x
    for ln in tfed.fed_schedule(len(taus), s):
        h, se, de = ln.halo, ln.src_ext, ln.dst_ext
        dH, dW = H + 2 * de, W + 2 * de
        dst = torch.empty(B, dH, dW)
        for ty in range(0, dH, th):
            for tx in range(0, dW, tw):
                # dst-local (r, c) is src-local (r - de + se, c - de + se)
                rows = (torch.arange(ty - h, ty + th + h) - de + se).clamp(0, src.shape[1] - 1)
                cols = (torch.arange(tx - h, tx + tw + h) - de + se).clamp(0, src.shape[2] - 1)
                t = src[:, rows][:, :, cols]
                for tau in taus[ln.first:ln.first + ln.steps]:
                    gx, gy = tfed.scharr_gradients(tfed.gaussian_blur(t, 1.0, radius=2))
                    t = tfed.diffusion_step(t, tfed.pm_g2(gx, gy, kb), tau)
                t = t[:, h:h + th, h:h + tw]
                dst[:, ty:ty + th, tx:tx + tw] = t[:, :dH - ty, :dW - tx]
        src = dst
    return src


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12])
def test_fed_schedule_tiles_equal_the_whole_field(n):
    """The kernel's launch schedule and halo arithmetic, on the host: the
    plain twin stepped launch by launch on clamped, haloed tiles of a
    ragged (not tile-multiple) batch of two with distinct k equals the plain
    twin on the whole field (the same float32 operations, so to round-off
    of convolutions at other sizes) and fed_evolve_pallas(interpret=True)
    within the 1e-5 of test_fed_twin_matches_pallas_and_evolve. A halo of
    4 s - 1 fails it. The steps are the first n of a long cycle, all under
    the explicit limit 0.25: a cycle's long last steps (6.1 at n = 12)
    amplify float32 round-off between the twin and the Pallas kernel to
    ~1.6e-4 whatever the schedule; whole cycles are held above."""
    taus = tuple(tnl.fed_tau_steps(40.0))[:n]
    assert len(taus) == n
    sched = tfed.fed_schedule(n)
    assert sum(ln.steps for ln in sched) == n and sched[-1].dst_ext == 0
    assert max(ln.steps for ln in sched) <= tfed.STEPS_PER_LAUNCH
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (2, 45, 83)).astype(np.float32)
    ks = np.array([0.1, 0.25], np.float32)
    x, k = torch.from_numpy(img), torch.from_numpy(ks)
    tiled = _fed_by_schedule(x, k, taus, tfed.STEPS_PER_LAUNCH).numpy()
    whole = tfed.fed_evolve_plain(x, k, taus).numpy()
    assert tiled.shape == img.shape
    np.testing.assert_allclose(tiled, whole, rtol=0, atol=1e-6)
    p = np.asarray(fed_evolve_pallas(jnp.asarray(img), jnp.asarray(ks), taus, interpret=True))
    assert np.abs(tiled - p).max() < 1e-5


def test_pm_g2_and_diffusion_step_match_reference():
    rng = np.random.default_rng(6)
    L, gx, gy = (rng.normal(size=(40, 56)).astype(np.float32) for _ in range(3))
    g = np.array(jnl.pm_g2(jnp.asarray(gx), jnp.asarray(gy), 0.7))
    np.testing.assert_allclose(
        tfed.pm_g2(torch.from_numpy(gx), torch.from_numpy(gy), 0.7).numpy(), g, rtol=1e-6)
    np.testing.assert_allclose(
        tfed.diffusion_step(torch.from_numpy(L), torch.from_numpy(g), 0.3).numpy(),
        np.asarray(jnl._diffusion_step(jnp.asarray(L), jnp.asarray(g), 0.3)),
        rtol=1e-6, atol=1e-6)


def _reference_tpu_branch(image, num_levels):
    """The reference's TPU path of nonlinear_scale_space, composed from its
    public functions with the Pallas kernels in interpret mode: k from the
    _gradmag2 kernel (4x4 mean pool, 70th percentile), the presmooth blur
    in the image dtype, fed_evolve_pallas from there on."""
    _, mag2 = harris_nms_pallas(image.astype(jnp.float32), interpret=True,
                                detector="_gradmag2")
    h, w = mag2.shape
    pooled = mag2[: h - h % 4, : w - w % 4].reshape(h // 4, 4, w // 4, 4).mean(axis=(1, 3))
    k = jnp.maximum(jnp.sqrt(jnp.maximum(jnp.quantile(pooled, 0.7), 0.0)), 1e-3)
    L = fed_evolve_pallas(j_blur(image, 1.0).astype(jnp.float32), k,
                          tuple(jnl.fed_tau_steps(0.78)), interpret=True)
    levels = [L]
    for _ in range(num_levels - 1):
        L = fed_evolve_pallas(L, k, tuple(jnl.fed_tau_steps(3.84)), interpret=True)
        h, w = L.shape
        L = L[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        k = k * 0.75
        levels.append(L)
    return float(k / 0.75 ** (num_levels - 1)), levels


def test_contrast_factor_matches_tpu_branch(frame):
    """k of a 480x752 frame: the TPU branch composed from the reference
    (1.50837 on this frame; the reference's CPU branch gives 1.55019, 2.7%
    apart, which is why the port takes one branch on every device). The
    pooled field agrees to float32 round-off, so k to 1e-5 relative."""
    k_ref, _ = _reference_tpu_branch(jnp.asarray(frame), 1)
    k = tnl.contrast_factor(torch.from_numpy(frame))
    assert k.shape == () and k.dtype == torch.float32
    assert abs(float(k) - k_ref) < 1e-5 * k_ref, (float(k), k_ref)
    assert abs(float(jnl.contrast_factor(jnp.asarray(frame))) - k_ref) > 0.02 * k_ref
    # The bf16 image the pipeline gives it: the statistic reads it in float32.
    k16 = tnl.contrast_factor(torch.from_numpy(frame).to(torch.bfloat16))
    assert abs(float(k16) - k_ref) < 1e-3 * k_ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonlinear_scale_space_matches_tpu_branch(frame, dtype):
    """Both levels of the KAZE scale space of a 480x752 frame against the
    composed TPU branch. float32: round-off through 12 FED steps (measured
    ~2e-5 on the 0-255 field; bound 1e-3). bfloat16: the presmooth blur
    rounds to bf16 in each framework, and where their float32 sums straddle
    a bf16 rounding boundary a pixel differs by one bf16 step (up to 1 at
    255); diffusion spreads that, so the levels are held to 2.0 max and
    0.01 mean absolute difference."""
    img = frame[:240, :376]
    j_img = jnp.asarray(img, jnp.dtype(dtype))
    _, ref = _reference_tpu_branch(j_img, 2)
    t = tnl.nonlinear_scale_space(torch.from_numpy(img.copy()).to(getattr(torch, dtype)), 2)
    assert len(t) == 2
    for a, b in zip(t, ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        d = np.abs(a.numpy() - b)
        if dtype == "float32":
            assert d.max() < 1e-3, d.max()
        else:
            assert d.max() < 2.0 and d.mean() < 0.01, (d.max(), d.mean())


def test_brief_pattern_is_bit_identical():
    np.testing.assert_array_equal(tbin.PATTERN, jbin._PATTERN)
    assert tbin.PATTERN.dtype == np.float32 and tbin.PATTERN.shape == (256, 2, 2)


def test_describe_binary_agrees_on_shared_keypoints(frame):
    """Same level, same keypoints (borders and clipped samples included):
    the bits agree on > 0.99 of the tests (a test whose two samples are
    within float32 round-off may flip; measured 1.0 on this frame), and
    every descriptor is a +-1/16 unit vector."""
    rng = np.random.default_rng(2)
    uv = rng.uniform(14, [frame.shape[1] - 14, frame.shape[0] - 14], (256, 2)).astype(np.float32)
    uv[0] = [3.0, 2.0]
    uv[1] = [frame.shape[1] - 2.5, frame.shape[0] - 1.2]
    ang = rng.uniform(-np.pi, np.pi, 256).astype(np.float32)
    ang[:128] = 0.0
    j = np.asarray(jbin.describe_binary(jnp.asarray(frame), jnp.asarray(uv), jnp.asarray(ang)))
    t = tbin.describe_binary(torch.from_numpy(frame.copy()), torch.from_numpy(uv),
                             torch.from_numpy(ang), torch.from_numpy(tbin.PATTERN)).numpy()
    assert t.shape == (256, 256) and t.dtype == np.float32
    assert set(np.unique(t)) == {np.float32(-1 / 16), np.float32(1 / 16)}
    assert (np.sign(t) == np.sign(j)).mean() > 0.99
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, rtol=1e-6)


def _cuda_floats(src: str, name: str) -> np.ndarray:
    with open(os.path.join(CSRC, src)) as f:
        text = f.read()
    body = re.search(name + r"\[\d+\]\s*=\s*\{([^}]*)\}", text).group(1)
    return np.array([float(v.strip().rstrip("f")) for v in body.split(",")], np.float32)


@pytest.mark.parametrize("src,name,sigma,radius", [
    ("response_nms.cu", "kG15r3", 1.5, 3),
    ("response_nms.cu", "kG10r3", 1.0, 3),
    ("response_nms.cu", "kG16r4", 1.6, 4),
    ("fed_evolve.cu", "kBlur", 1.0, 2),
])
def test_cuda_gaussian_taps_are_the_reference_float32_values(src, name, sigma, radius):
    """The CUDA sources carry the taps as literals; each parses to the
    float32 value the reference computes, bit for bit."""
    from vislam_tpu.ops.harris_kernel import _gauss_taps

    ref = np.array(_gauss_taps(radius, sigma), np.float32)
    np.testing.assert_array_equal(_cuda_floats(src, name), ref)
    np.testing.assert_array_equal(gaussian_taps(sigma, radius), ref)


def test_cuda_fast_ring_is_the_reference_ring():
    from vislam_tpu.frontend.detect import _FAST_RING

    with open(os.path.join(CSRC, "response_nms.cu")) as f:
        body = re.search(r"kRing\[16\]\[2\]\s*=\s*\{(.*?)\};", f.read(), re.S).group(1)
    ring = np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(16, 2)
    np.testing.assert_array_equal(ring, _FAST_RING)
