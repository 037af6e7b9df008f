"""Adversarial synthetic imagery with exact ground truth (the port's own
copy of `vislam_tpu/data/adversarial.py`: numpy and scipy only, on the
port's `calib` and `data/synthetic`).

A closed textured box (5 walls) raycast per pixel, so every pixel has an
exact depth and every keypoint an exact ground-truth correspondence
(`AdversarialScene.gt_correspondence`), under the regimes that break
appearance matching: dense natural texture, repetitive brick walls (where
the IMU-rotation guided gate decides, MATCHABILITY.md), illumination
drift, motion blur, independently moving occluders and sensor noise. IMU
streams come from the same analytic trajectory
(`synthetic.imu_measurements`), so whole runs work on these sequences.
`make_adversarial_sequence` returns the schema of
`make_synthetic_sequence` plus "scene".

Host-side numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _Rot

from vislam_tpu_torch.calib.camera_model import CameraCalib
from vislam_tpu_torch.data.synthetic import (
    SyntheticConfig,
    _trajectory,
    imu_measurements,
    synthetic_calib,
)


# ---------------------------------------------------------------------------
# Procedural textures
# ---------------------------------------------------------------------------

def _upsample_bilinear(grid: np.ndarray, size: int) -> np.ndarray:
    """(n, n) -> (size, size) separable bilinear upsample."""
    n = grid.shape[0]
    xs = np.linspace(0.0, n - 1.0, size)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, n - 2)
    f = (xs - x0).astype(np.float32)
    cols = grid[:, x0] * (1 - f) + grid[:, x0 + 1] * f
    rows = cols[x0, :] * (1 - f[:, None]) + cols[x0 + 1, :] * f[:, None]
    return rows.astype(np.float32)


def value_noise_texture(rng, size: int = 1024, octaves: int = 8,
                        persistence: float = 0.8) -> np.ndarray:
    """Multi-octave value noise in [0, 1] — natural low-frequency base."""
    img = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = 2 ** (o + 2)
        if n >= size:
            break
        img += amp * _upsample_bilinear(
            rng.standard_normal((n + 1, n + 1)).astype(np.float32), size
        )
        amp *= persistence
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return img


def natural_texture(rng, size: int = 1024, n_rect: int = 300) -> np.ndarray:
    """Value noise + random alpha-blended panels/edges in [0, 1].

    Tuned so classical detectors respond as on real indoor imagery: at the
    rendered viewing scale, OpenCV SIFT/ORB at default thresholds each find
    ~500 keypoints per frame (pure value noise starves them — 7 SIFT kps).
    The rectangles play the role of real structure (posters, panels, bricks,
    cabling) whose corners/edges carry most real-scene features.
    """
    t = value_noise_texture(rng, size)
    for _ in range(n_rect):
        w = int(rng.uniform(6, 120))
        h = int(rng.uniform(6, 120))
        x = int(rng.integers(0, size - w))
        y = int(rng.integers(0, size - h))
        val = rng.uniform(0.0, 1.0)
        alpha = rng.uniform(0.4, 0.9)
        t[y:y + h, x:x + w] = (1 - alpha) * t[y:y + h, x:x + w] + alpha * val
    t += 0.02 * rng.standard_normal((size, size)).astype(np.float32)
    t -= t.min()
    t /= max(t.max(), 1e-9)
    return t


def brick_texture(rng, size: int = 1024, brick_v: int = 64, brick_u: int = 128,
                  variation: float = 0.10, grain: float = 0.05) -> np.ndarray:
    """Repetitive brick pattern in [0, 1] — the ambiguous-matching regime.

    Every brick has the same strong structure (the corners detectors fire
    on are indistinguishable by geometry), but each carries weak per-brick
    shading + static grain. A frontend only scores inliers here if its
    DESCRIPTOR can exploit the weak identity cues while its ratio/mutual
    chain suppresses the near-duplicate wrong bricks — exactly what the
    reference's nnFilter+symmetry chain (Matcher.cpp:96-169) is for. With
    identical bricks (variation→0) every matcher collapses to 0 inliers and
    the regime stops discriminating; these defaults keep it hard but fair.
    """
    v, u = np.mgrid[0:size, 0:size]
    row = v // brick_v
    u_off = u + (row % 2) * (brick_u // 2)
    mortar = ((v % brick_v) < 3) | ((u_off % brick_u) < 3)
    col = u_off // brick_u
    # Per-brick pseudo-random shade (hash of brick id) — weak identity cue.
    shade = variation * (
        np.sin(12.9898 * row + 78.233 * col) * 0.5
        + np.sin(5.1 * row * col + 1.7) * 0.5
    )
    tex = np.where(mortar, 0.25, 0.62 + shade).astype(np.float32)
    # Static grain: per-texel identity cue at descriptor scale.
    tex += grain * rng.standard_normal((size, size)).astype(np.float32)
    return np.clip(tex, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Scene geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plane:
    origin: np.ndarray   # (3,) world corner
    e1: np.ndarray       # (3,) unit edge direction 1
    e2: np.ndarray       # (3,) unit edge direction 2
    s1: float            # extent along e1 (m)
    s2: float            # extent along e2 (m)
    tex: np.ndarray      # (T, T) float32 in [0, 1]

    @property
    def normal(self) -> np.ndarray:
        return np.cross(self.e1, self.e2)


def _sample_tex(tex: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bilinear sample of tex at normalized plane coords a, b in [0, 1]."""
    T = tex.shape[0]
    x = np.clip(a, 0.0, 1.0) * (tex.shape[1] - 1)
    y = np.clip(b, 0.0, 1.0) * (T - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, tex.shape[1] - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, T - 2)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    v00 = tex[y0, x0]
    v01 = tex[y0, x0 + 1]
    v10 = tex[y0 + 1, x0]
    v11 = tex[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


@dataclasses.dataclass(frozen=True)
class AdversarialConfig:
    """Regime knobs. All default-off; presets() returns named combinations."""

    n_frames: int = 30
    seed: int = 0
    # Trajectory (same analytic family as SyntheticConfig).
    trans_amp: Tuple[float, float, float] = (1.5, 1.0, 0.6)
    rot_amp: Tuple[float, float, float] = (0.06, 0.08, 0.15)
    gravity: float = 9.81
    gyro_noise: float = 0.0
    accel_noise: float = 0.0
    gyro_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    accel_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Scene appearance.
    texture: str = "natural"        # natural | repetitive | mixed (one brick wall)
    tex_size: int = 1024
    # Illumination: image *= gain(t); gain = 1 + amp*sin(2*pi*f*t). The
    # shading field adds a linear intensity ramp whose direction rotates
    # over the run (a drifting light source).
    illum_gain_amp: float = 0.0
    illum_gain_hz: float = 0.23
    illum_shade_amp: float = 0.0
    # Motion blur: average of `blur_samples` renders across `exposure_s`.
    blur_samples: int = 1
    exposure_s: float = 0.025
    # Independently moving textured occluder boards (egomotion outliers).
    n_occluders: int = 0
    occluder_size: float = 1.4
    # Sensor.
    noise_sigma: float = 2.0        # gray levels


def presets() -> Dict[str, AdversarialConfig]:
    """The named hard regimes used by the matchability evaluation."""
    return {
        "natural": AdversarialConfig(),
        "illum": AdversarialConfig(illum_gain_amp=0.35, illum_shade_amp=0.45),
        "blur": AdversarialConfig(blur_samples=5, exposure_s=0.030),
        "repetitive": AdversarialConfig(texture="repetitive"),
        "occlusion": AdversarialConfig(n_occluders=4),
        "combined": AdversarialConfig(
            illum_gain_amp=0.25, illum_shade_amp=0.3, blur_samples=3,
            exposure_s=0.02, n_occluders=3, texture="mixed", noise_sigma=4.0,
        ),
    }


class AdversarialScene:
    """Raycast scene: closed textured box + moving occluder boards.

    Provides the exact-GT queries the matchability evaluation needs:
    cast() (pixel -> world point + depth + static flag) and
    gt_correspondence() (frame-i pixels -> frame-j pixels with a true-depth
    occlusion/visibility check).
    """

    def __init__(self, cfg: AdversarialConfig, calib: CameraCalib):
        self.cfg = cfg
        self.calib = calib
        rng = np.random.default_rng(cfg.seed + 77)

        def make_tex(kind: str):
            if kind == "repetitive":
                return brick_texture(rng, cfg.tex_size)
            return natural_texture(rng, cfg.tex_size)

        X, Y, Z = np.eye(3, dtype=np.float64)
        # Closed box: back wall + floor + ceiling + two side walls. Camera
        # path stays within |x|<2, |y|<1.5, |z|<1.
        hx, hy, zf = 9.0, 5.0, 14.0
        wall_kinds = ["natural"] * 5
        if cfg.texture == "repetitive":
            wall_kinds = ["repetitive"] * 5
        elif cfg.texture == "mixed":
            wall_kinds[0] = "repetitive"  # back wall repetitive, rest natural
        self.planes: List[_Plane] = [
            # back wall z=zf (normal -z toward camera)
            _Plane(np.array([-hx, -hy, zf]), X, Y, 2 * hx, 2 * hy,
                   make_tex(wall_kinds[0])),
            # floor y=+hy (image +v is world +y: floor is below)
            _Plane(np.array([-hx, hy, -2.0]), X, Z, 2 * hx, zf + 2.0,
                   make_tex(wall_kinds[1])),
            # ceiling y=-hy
            _Plane(np.array([-hx, -hy, -2.0]), X, Z, 2 * hx, zf + 2.0,
                   make_tex(wall_kinds[2])),
            # left wall x=-hx
            _Plane(np.array([-hx, -hy, -2.0]), Y, Z, 2 * hy, zf + 2.0,
                   make_tex(wall_kinds[3])),
            # right wall x=+hx
            _Plane(np.array([hx, -hy, -2.0]), Y, Z, 2 * hy, zf + 2.0,
                   make_tex(wall_kinds[4])),
        ]
        # Occluders: camera-facing square boards at z in [2.5, 4], with
        # independent sinusoidal drift (world-frame motion != egomotion).
        self.occ_params = []
        for k in range(cfg.n_occluders):
            self.occ_params.append({
                "center0": np.array([
                    rng.uniform(-2.5, 2.5), rng.uniform(-1.5, 1.5),
                    rng.uniform(2.8, 4.5),
                ]),
                "vel_amp": np.array([
                    rng.uniform(0.4, 1.0), rng.uniform(0.3, 0.8), 0.0,
                ]),
                "freq": rng.uniform(0.1, 0.3, 3),
                "phase": rng.uniform(0, 2 * np.pi, 3),
                "tex": natural_texture(rng, 256, n_rect=60),
            })
        # Trajectory poses at camera times.
        self._traj_cfg = SyntheticConfig(
            n_frames=cfg.n_frames, trans_amp=cfg.trans_amp,
            rot_amp=cfg.rot_amp, gravity=cfg.gravity,
            gyro_noise=cfg.gyro_noise, accel_noise=cfg.accel_noise,
            gyro_bias=cfg.gyro_bias, accel_bias=cfg.accel_bias,
        )
        dt_cam = 1.0 / (calib.rate_cam_hz or 20.0)
        self.t_cam = np.arange(cfg.n_frames) * dt_cam
        self.pos, self.vel, _, self.R_wb, self.rpy = _trajectory(
            self._traj_cfg, self.t_cam
        )

    # -- geometry ----------------------------------------------------------

    def _occ_planes(self, t: float) -> List[_Plane]:
        s = self.cfg.occluder_size
        out = []
        for p in self.occ_params:
            c = p["center0"] + p["vel_amp"] * np.sin(
                2 * np.pi * p["freq"] * t + p["phase"]
            )
            origin = c - 0.5 * s * np.array([1.0, 1.0, 0.0])
            out.append(_Plane(origin, np.eye(3)[0], np.eye(3)[1], s, s, p["tex"]))
        return out

    def pose_at(self, t: float):
        """Continuous-time pose (for sub-exposure blur sampling)."""
        pos, _, _, R_wb, _ = _trajectory(self._traj_cfg, np.array([t]))
        return pos[0], R_wb[0]

    def _cast_dirs(self, pos, R_wb, d_w, t: float, want_tex: bool):
        """Raycast world-frame directions (..., 3) from `pos` at scene time t.

        Returns (value or None, depth, static_mask). depth is the camera-z
        distance (d_w built from unnormalized camera dirs with z=1).
        """
        shape = d_w.shape[:-1]
        best_t = np.full(shape, np.inf, np.float32)
        best_val = np.zeros(shape, np.float32) if want_tex else None
        static = np.ones(shape, bool)
        planes = [(pl, True) for pl in self.planes]
        planes += [(pl, False) for pl in self._occ_planes(t)]
        for pl, is_static in planes:
            n = pl.normal
            denom = d_w @ n
            num = float((pl.origin - pos) @ n)
            with np.errstate(divide="ignore", invalid="ignore"):
                tt = np.where(np.abs(denom) > 1e-9, num / denom, np.inf)
            finite = np.isfinite(tt)
            # Masked lanes get t=0 for the coordinate math (kept invalid below).
            tt_safe = np.where(finite, tt, 0.0)
            X = pos + tt_safe[..., None] * d_w
            rel = X - pl.origin
            a = (rel @ pl.e1) / pl.s1
            b = (rel @ pl.e2) / pl.s2
            valid = finite & (tt_safe > 0.2) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
            tt = np.where(valid, tt_safe, np.inf).astype(np.float32)
            closer = tt < best_t
            if want_tex:
                val = _sample_tex(pl.tex, a, b)
                best_val = np.where(closer, val, best_val)
            static = np.where(closer, is_static, static)
            best_t = np.minimum(best_t, tt)
        return best_val, best_t, static

    def cast(self, frame: int, uv: np.ndarray):
        """Pixels (M, 2) in frame -> (X_w (M,3), depth (M,), static (M,), hit (M,))."""
        c = self.calib
        d_c = np.stack([
            (uv[:, 0] - c.cx) / c.fx, (uv[:, 1] - c.cy) / c.fy,
            np.ones(len(uv)),
        ], -1)
        d_w = d_c @ self.R_wb[frame].T
        _, depth, static = self._cast_dirs(
            self.pos[frame], self.R_wb[frame], d_w,
            float(self.t_cam[frame]), want_tex=False,
        )
        hit = np.isfinite(depth)
        d = np.where(hit, depth, 1.0)
        X = self.pos[frame] + d[:, None] * d_w
        return X, depth, static, hit

    def project(self, frame: int, X_w: np.ndarray):
        """World points (M,3) -> (uv (M,2), depth (M,)) in frame's camera."""
        c = self.calib
        Xc = (X_w - self.pos[frame]) @ self.R_wb[frame]
        z = Xc[:, 2]
        u = c.fx * Xc[:, 0] / np.maximum(z, 1e-9) + c.cx
        v = c.fy * Xc[:, 1] / np.maximum(z, 1e-9) + c.cy
        return np.stack([u, v], -1), z

    def gt_correspondence(self, i: int, uv_i: np.ndarray, j: int,
                          occl_tol: float = 0.05):
        """Ground-truth positions in frame j of frame-i pixels uv_i (M, 2).

        Returns (uv_j (M,2), valid (M,)). valid requires: the frame-i ray hit
        a STATIC surface, the point projects in front of camera j inside the
        image, and it is unoccluded in frame j (the frame-j ray first hits
        within occl_tol relative depth of the point).
        """
        c = self.calib
        X, _, static, hit = self.cast(i, uv_i)
        uv_j, z_j = self.project(j, X)
        valid = hit & static & (z_j > 0.2)
        valid &= ((uv_j[:, 0] >= 0) & (uv_j[:, 0] <= c.width - 1)
                  & (uv_j[:, 1] >= 0) & (uv_j[:, 1] <= c.height - 1))
        # Occlusion: recast from camera j toward the projected pixel.
        safe_uv = np.where(valid[:, None], uv_j, c.cx)
        _, depth_j, _, hit_j = self.cast(j, safe_uv)
        occluded = hit_j & (depth_j < (1.0 - occl_tol) * z_j)
        valid &= ~occluded
        return uv_j, valid

    # -- rendering ---------------------------------------------------------

    def _render_at(self, t: float, pos, R_wb) -> np.ndarray:
        c = self.calib
        u, v = np.meshgrid(
            np.arange(c.width, dtype=np.float64),
            np.arange(c.height, dtype=np.float64),
        )
        d_c = np.stack([(u - c.cx) / c.fx, (v - c.cy) / c.fy, np.ones_like(u)], -1)
        d_w = d_c @ R_wb.T
        val, _, _ = self._cast_dirs(pos, R_wb, d_w, t, want_tex=True)
        return val

    def render_frame(self, frame: int, rng) -> np.ndarray:
        cfg = self.cfg
        t0 = float(self.t_cam[frame])
        if cfg.blur_samples > 1:
            offs = np.linspace(-0.5, 0.5, cfg.blur_samples) * cfg.exposure_s
            acc = None
            for off in offs:
                pos, R = self.pose_at(t0 + off)
                img = self._render_at(t0 + off, pos, R)
                acc = img if acc is None else acc + img
            val = acc / cfg.blur_samples
        else:
            val = self._render_at(t0, self.pos[frame], self.R_wb[frame])

        # Illumination drift.
        gain = 1.0 + cfg.illum_gain_amp * np.sin(
            2 * np.pi * cfg.illum_gain_hz * t0
        )
        if cfg.illum_shade_amp > 0:
            theta = 2 * np.pi * 0.1 * t0
            c = self.calib
            uu = (np.arange(c.width) / c.width - 0.5)[None, :]
            vv = (np.arange(c.height) / c.height - 0.5)[:, None]
            shade = 1.0 + cfg.illum_shade_amp * (
                uu * np.cos(theta) + vv * np.sin(theta)
            )
            val = val * shade
        img = 20.0 + 215.0 * gain * val
        if cfg.noise_sigma > 0:
            img = img + cfg.noise_sigma * rng.standard_normal(img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)


def make_adversarial_sequence(
    cfg: AdversarialConfig = AdversarialConfig(),
    calib: Optional[CameraCalib] = None,
) -> Dict[str, np.ndarray]:
    """Render a full hard-regime sequence.

    Returns the same dict schema as make_synthetic_sequence (images, t_cam_ns,
    gt_*, imu_*) plus "scene": the AdversarialScene for exact-GT queries.
    """
    calib = calib or synthetic_calib()
    scene = AdversarialScene(cfg, calib)
    rng = np.random.default_rng(cfg.seed + 13)
    N = cfg.n_frames
    images = np.stack([scene.render_frame(n, rng) for n in range(N)])

    dt_cam = 1.0 / (calib.rate_cam_hz or 20.0)
    dt_imu = 1.0 / (calib.rate_imu_hz or 200.0)
    n_imu = int(round((N - 1) * dt_cam / dt_imu)) + 1
    t_imu = np.arange(n_imu) * dt_imu
    rng_imu = np.random.default_rng(cfg.seed + 1013)
    gyro, accel = imu_measurements(scene._traj_cfg, t_imu, rng_imu)

    quat = np.roll(_Rot.from_matrix(scene.R_wb).as_quat(), 1, axis=-1)
    t0_ns = 1_000_000_000_000
    return {
        "images": images,
        "t_cam_ns": (t0_ns + scene.t_cam * 1e9).astype(np.int64),
        "gt_pos": scene.pos,
        "gt_vel": scene.vel,
        "gt_quat": quat,
        "gt_rpy": scene.rpy,
        "imu_t_ns": (t0_ns + t_imu * 1e9).astype(np.int64),
        "imu_gyro": gyro.astype(np.float32),
        "imu_accel": accel.astype(np.float32),
        "calib": calib,
        "scene": scene,
    }
