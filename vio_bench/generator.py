"""The traffic generator: B synthetic EuRoC-class sequences from one seed.

The scene follows the port's synthetic generator (`data/synthetic.py`):
a smooth analytic trajectory over a field of textured landmarks, with the
IMU derived from the same trajectory and white noise added at the
configured densities. Trajectory, IMU, landmarks and their projections
are computed on the host in numpy exactly as there (the same random
stream for a sequence's seed), and the frames are rendered on the
card: the background noise comes from a `torch.Generator` on the device
(so it differs from the host generator's), and each landmark's 8x8
bilinear block is built in float64 and rounded to float32 in the host
generator's order before the max-composite, so with the background noise
off the frames equal the host generator's bit for bit.

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

CAM_RATE_HZ = 20.0
IMU_RATE_HZ = 200.0
PATCH_HALF = 3


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole without distortion (a configuration's `camera`)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass(frozen=True)
class Traffic:
    """One traffic mix (a `traffic/<name>.json` file)."""

    sequences: int                  # B, stepped together
    frames: int                     # frames per pass (the first keyframe is one more)
    landmarks: int = 300
    trans_amp: tuple = (1.2, 0.8, 0.4)
    rot_amp: tuple = (0.06, 0.08, 0.15)
    start_s_max: float = 0.0        # the sequences' start times spread evenly over [0, this]
    background_noise: float = 6.0
    gravity: float = 9.81
    gt_scale: bool = True
    gyro_noise: float = 0.0         # white noise per IMU sample (rad/s)
    accel_noise: float = 0.0        # the same of the accelerometer (m/s^2)

    @classmethod
    def from_json(cls, d: dict) -> "Traffic":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields - {"why"}
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in fields})


def trajectory(traffic: Traffic, t: np.ndarray):
    """World position, velocity, acceleration and body->world rotation at
    times t (s); world z up, the camera looking along world +y."""
    ax_, ay_, az_ = traffic.trans_amp
    w1, w2, w3 = 2 * np.pi * 0.25, 2 * np.pi * 0.17, 2 * np.pi * 0.11
    pos = np.stack([ax_ * np.sin(w1 * t), ay_ * np.sin(w2 * t), az_ * np.sin(w3 * t)], -1)
    vel = np.stack([ax_ * w1 * np.cos(w1 * t), ay_ * w2 * np.cos(w2 * t),
                    az_ * w3 * np.cos(w3 * t)], -1)
    acc = np.stack([-ax_ * w1 ** 2 * np.sin(w1 * t), -ay_ * w2 ** 2 * np.sin(w2 * t),
                    -az_ * w3 ** 2 * np.sin(w3 * t)], -1)
    rr, rp, ry = traffic.rot_amp
    wr, wp, wy = 2 * np.pi * 0.21, 2 * np.pi * 0.13, 2 * np.pi * 0.09
    rpy = np.stack([rr * np.sin(wr * t), rp * np.sin(wp * t), ry * np.sin(wy * t)], -1)
    R_wb = Rotation.from_euler("ZYX", rpy[:, ::-1]).as_matrix()
    return pos, vel, acc, R_wb


def imu_noise(imu: dict) -> dict:
    """The white noise per sample at IMU_RATE_HZ of a configuration's `imu`
    (continuous noise densities, as a Kalibr sensor.yaml states them)."""
    root_hz = float(np.sqrt(IMU_RATE_HZ))
    return {"gyro_noise": imu["gyroscope_noise_density"] * root_hz,
            "accel_noise": imu["accelerometer_noise_density"] * root_hz}


def imu_measurements(traffic: Traffic, t_imu: np.ndarray, rng_imu):
    """Body-frame gyro (from relative rotations) and specific force
    (accelerometer, gravity included) at times t_imu, with white noise
    from `rng_imu` in the host generator's order."""
    dt_imu = float(t_imu[1] - t_imu[0]) if len(t_imu) > 1 else 1.0
    _, _, acc_i, R_wb_i = trajectory(traffic, t_imu)
    dR = np.einsum("nij,nik->njk", R_wb_i[:-1], R_wb_i[1:])
    rotvec = Rotation.from_matrix(dR).as_rotvec() / dt_imu
    gyro = np.vstack([rotvec, rotvec[-1:]])
    g_w = np.array([0.0, 0.0, -traffic.gravity])
    accel = np.einsum("nji,nj->ni", R_wb_i, acc_i - g_w)
    gyro = gyro + traffic.gyro_noise * rng_imu.standard_normal(gyro.shape)
    accel = accel + traffic.accel_noise * rng_imu.standard_normal(accel.shape)
    return gyro, accel


def smooth3(x: np.ndarray, axis: int) -> np.ndarray:
    """The [1/4, 1/2, 1/4] smoothing along `axis` with zeros outside, in
    float64 (np.convolve(row, kernel, "same") row by row: the taps are
    powers of two, so every product and sum here is exact and the order of
    the additions does not matter)."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, -1)
    pad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, 1)])
    return np.moveaxis(0.25 * pad[..., :-2] + 0.5 * pad[..., 1:-1] + 0.25 * pad[..., 2:], -1, axis)


def sequence_seed(seed: int, b: int) -> int:
    """Sequence b's generator seed, from the run's seed (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, b]).generate_state(1)[0])


class HostSequence(NamedTuple):
    """What the host computes of one sequence (frames 0..N; frame 0 is the
    first keyframe)."""

    gt_pos: np.ndarray      # (N + 1, 3)
    gt_vel: np.ndarray      # (N + 1, 3)
    gt_quat: np.ndarray     # (N + 1, 4) w, x, y, z
    R_wb: np.ndarray        # (N + 1, 3, 3)
    imu_gyro: np.ndarray    # (M, 3) float32
    imu_accel: np.ndarray   # (M, 3) float32
    landmarks: np.ndarray   # (L, 3)
    patches: np.ndarray     # (L, 7, 7) float64


def host_sequence(traffic: Traffic, seq_seed: int, start_s: float = 0.0) -> HostSequence:
    """One sequence's trajectory, IMU, landmarks and textures, in the host
    generator's random stream for `seq_seed` (frames from time start_s)."""
    rng = np.random.default_rng(seq_seed)
    n = traffic.frames + 1
    dt_cam, dt_imu = 1.0 / CAM_RATE_HZ, 1.0 / IMU_RATE_HZ
    t_cam = start_s + np.arange(n) * dt_cam
    n_imu = int(round((n - 1) * dt_cam / dt_imu)) + 1
    t_imu = start_s + np.arange(n_imu) * dt_imu
    L = traffic.landmarks
    lm = np.stack([rng.uniform(-6, 6, L), rng.uniform(-4, 4, L), rng.uniform(4.0, 12.0, L)], -1)
    pos, vel, _, R_wb = trajectory(traffic, t_cam)
    quat = np.roll(Rotation.from_matrix(R_wb).as_quat(), 1, axis=-1)
    rng_imu = np.random.default_rng(int(rng.integers(2 ** 62)))
    gyro, accel = imu_measurements(traffic, t_imu, rng_imu)
    psz = 2 * PATCH_HALF + 1
    patches = rng.uniform(40, 255, size=(L, psz, psz)).astype(np.float32)
    for axis in (1, 2):
        patches = smooth3(patches, axis)
    return HostSequence(pos, vel, quat, R_wb, gyro.astype(np.float32),
                        accel.astype(np.float32), lm, patches)


def projections(seq: HostSequence, cam: Camera):
    """Per frame, the visible landmarks' indices and their projections
    (u, v float64), as the host generator computes them."""
    ph = PATCH_HALF
    out = []
    for n in range(len(seq.gt_pos)):
        Xc = (seq.landmarks - seq.gt_pos[n]) @ seq.R_wb[n]
        z = Xc[:, 2]
        vis = z > 0.5
        u = cam.fx * Xc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * Xc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        vis &= (u > ph + 1) & (u < cam.width - ph - 2) & (v > ph + 1) & (v < cam.height - ph - 2)
        k = np.nonzero(vis)[0]
        out.append((k, u[k], v[k]))
    return out


def _splat(images, frame_ids, ui, vi, du, dv, pat):
    """Max-composite each landmark's 8x8 bilinear block into flat images
    (F, H, W) float32; the block is accumulated term by term in float64
    and rounded to float32 after each term, as the host generator's
    float32 block does."""
    F_, H, W = images.shape
    w = torch.stack([(1 - du) * (1 - dv), du * (1 - dv), (1 - du) * dv, du * dv], -1)
    z = torch.zeros(pat.shape[0], 8, 8, dtype=torch.float64, device=pat.device)
    terms = [z.clone() for _ in range(4)]
    terms[0][:, :-1, :-1] = w[:, 0, None, None] * pat
    terms[1][:, :-1, 1:] = w[:, 1, None, None] * pat
    terms[2][:, 1:, :-1] = w[:, 2, None, None] * pat
    terms[3][:, 1:, 1:] = w[:, 3, None, None] * pat
    blk = terms[0].float()
    for t in terms[1:]:
        blk = (blk.double() + t).float()
    r = torch.arange(8, device=pat.device)
    rows = vi[:, None, None] - PATCH_HALF + r[None, :, None]
    cols = ui[:, None, None] - PATCH_HALF + r[None, None, :]
    idx = (frame_ids[:, None, None] * H + rows) * W + cols
    images.view(-1).scatter_reduce_(0, idx.reshape(-1), blk.reshape(-1), "amax")


def render(seqs, cam: Camera, background_noise: float, generator: torch.Generator,
           device, chunk: int = 16) -> torch.Tensor:
    """(B, N + 1, H, W) float32 frames of host sequences, rendered on
    `device` in chunks of `chunk` sequences."""
    B, n = len(seqs), len(seqs[0].gt_pos)
    out = torch.empty((B, n, cam.height, cam.width), dtype=torch.float32, device=device)
    for lo in range(0, B, chunk):
        part = seqs[lo:lo + chunk]
        img = background_noise * torch.randn((len(part) * n, cam.height, cam.width),
                                             generator=generator, device=device,
                                             dtype=torch.float32) + 20.0
        fid, ui, vi, du, dv, pats = [], [], [], [], [], []
        for s, seq in enumerate(part):
            for f, (k, u, v) in enumerate(projections(seq, cam)):
                iu, iv = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
                fid.append(np.full(len(k), s * n + f))
                ui.append(iu)
                vi.append(iv)
                du.append(u - iu)
                dv.append(v - iv)
                pats.append(seq.patches[k])

        def dev(parts, dtype):
            return torch.as_tensor(np.concatenate(parts)).to(device=device, dtype=dtype)

        _splat(img, dev(fid, torch.int64), dev(ui, torch.int64), dev(vi, torch.int64),
               dev(du, torch.float64), dev(dv, torch.float64), dev(pats, torch.float64))
        out[lo:lo + len(part)] = img.clamp_(0.0, 255.0).to(torch.uint8).float().reshape(
            len(part), n, cam.height, cam.width)
    return out


class Batch(NamedTuple):
    """A pass's inputs on the device and the host's ground truth."""

    images: torch.Tensor    # (B, N + 1, H, W) float32; frame 0 the first keyframe
    imu: torch.Tensor       # (B, N, S, 6) float32, frame n's samples since frame n - 1
    imu_dt: torch.Tensor    # (B, N, S) float32, 0 on padded rows
    gt_pos: np.ndarray      # (B, N + 1, 3) float64
    gt_vel: np.ndarray      # (B, N + 1, 3)
    gt_quat: np.ndarray     # (B, N + 1, 4)


def imu_windows(seq: HostSequence, frames: int, window: int):
    """Frame n's IMU samples (n = 1..frames), padded to `window` rows with
    dt = 0, as the port's `make_sequence_inputs` stages them."""
    spf = int(round(IMU_RATE_HZ / CAM_RATE_HZ))
    imu = np.zeros((frames, window, 6), np.float32)
    dt = np.zeros((frames, window), np.float32)
    for n, j in enumerate(range(1, frames + 1)):
        lo, hi = (j - 1) * spf, j * spf
        imu[n, :spf] = np.concatenate([seq.imu_gyro[lo:hi], seq.imu_accel[lo:hi]], -1)
        dt[n, :spf] = 1.0 / IMU_RATE_HZ
    return imu, dt


def make_batch(traffic: Traffic, seed: int, cam: Camera, imu_window: int, device,
               log=lambda msg: None) -> Batch:
    """The traffic's B sequences for `seed`: host trajectories, IMU and
    landmarks, frames rendered on `device`; each frame's IMU rows padded to
    the engine's `imu_window`."""
    # Every seed steps the same set of trajectory segments (start times
    # evenly spread), in another order: the seed changes the scenes and
    # which sequence gets which segment, not the motion the batch holds.
    starts = np.random.default_rng([int(seed) % 2 ** 64, 2 ** 32]).permutation(
        (np.arange(traffic.sequences) + 0.5) / traffic.sequences * traffic.start_s_max)
    seqs = [host_sequence(traffic, sequence_seed(seed, b), float(starts[b]))
            for b in range(traffic.sequences)]
    log(f"{len(seqs)} host sequences")
    gen = torch.Generator(device=device)
    log("device ready")
    gen.manual_seed(int(np.random.SeedSequence([int(seed) % 2 ** 64, 2 ** 33])
                        .generate_state(1, np.uint64)[0]) >> 1)
    images = render(seqs, cam, traffic.background_noise, gen, device)
    win = [imu_windows(s, traffic.frames, imu_window) for s in seqs]
    imu = np.stack([w[0] for w in win])
    dt = np.stack([w[1] for w in win])
    return Batch(images=images,
                 imu=torch.as_tensor(imu).to(device), imu_dt=torch.as_tensor(dt).to(device),
                 gt_pos=np.stack([s.gt_pos for s in seqs]),
                 gt_vel=np.stack([s.gt_vel for s in seqs]),
                 gt_quat=np.stack([s.gt_quat for s in seqs]))
