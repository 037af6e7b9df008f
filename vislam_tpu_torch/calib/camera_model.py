"""Pinhole + radial-tangential camera model (port of
`vislam_tpu/calib/camera_model.py`).

`CameraCalib` stays a host-side numpy record; the projection functions
take tensors. Pixel coords are (u, v) = (col, row); normalized coords
x = (u - cx)/fx, y = (v - cy)/fy; distortion [k1, k2, p1, p2] (radtan).

Undistortion: `compute_undistort_maps` computes the sampling grid once on
the host (float32, as the reference does), `remap_bilinear` samples an
image at it wherever the image lives (on the card, every frame of a
distorted dataset).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """Static calibration record (host-side; arrays are plain numpy)."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple  # (k1, k2, p1, p2)
    width: int
    height: int
    # Camera -> body rigid transform (EUROC sensor.yaml T_BS for cam0).
    T_body_cam: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )
    rate_cam_hz: float = 20.0
    rate_imu_hz: float = 200.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)


def scale_calib(calib: CameraCalib, sx: float, sy: float) -> CameraCalib:
    """Rescale the intrinsics for a resized image."""
    return dataclasses.replace(
        calib,
        fx=calib.fx * sx,
        fy=calib.fy * sy,
        cx=calib.cx * sx,
        cy=calib.cy * sy,
        width=int(round(calib.width * sx)),
        height=int(round(calib.height * sy)),
    )


def distort_normalized(xn, dist):
    """Apply radtan distortion to normalized coords xn (...,2) -> (...,2)."""
    k1, k2, p1, p2 = dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xd, dist, iters: int = 8):
    """Invert radtan distortion by a fixed number of fixed-point steps."""
    k1, k2, p1, p2 = dist
    x = xd[..., 0]
    y = xd[..., 1]
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def project_points(X_cam, fx, fy, cx, cy, dist=None):
    """Camera-frame 3D points (...,3) -> pixel coords (...,2).

    Points behind the camera project to garbage; callers mask on z > 0.
    """
    z = X_cam[..., 2:3]
    safe_z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    xn = X_cam[..., :2] / safe_z
    if dist is not None:
        xn = distort_normalized(xn, dist)
    u = xn[..., 0] * fx + cx
    v = xn[..., 1] * fy + cy
    return torch.stack([u, v], dim=-1)


def unproject_pixels(uv, fx, fy, cx, cy, dist=None):
    """Pixels (...,2) -> unit-depth normalized rays (...,3) (z=1)."""
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xn = torch.stack([x, y], dim=-1)
    if dist is not None:
        xn = undistort_normalized(xn, dist)
    return torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def compute_undistort_maps(calib: CameraCalib, new_size=None, alpha: float = 0.0):
    """The (map_u, map_v) sampling grid and the rectified intrinsics.

    alpha = 0 crops to valid pixels, alpha = 1 keeps every source pixel.
    Computed on the host in float32 as the reference computes it. Returns
    (maps, new_calib): maps is float32 (H_out, W_out, 2) numpy, for each
    output pixel the source pixel to sample.
    """
    H_out, W_out = new_size if new_size is not None else (calib.height, calib.width)

    # Undistort a border ring of source pixels to find the valid output extent.
    n = 64
    us = np.linspace(0, calib.width - 1, n)
    vs = np.linspace(0, calib.height - 1, n)
    border = np.concatenate(
        [
            np.stack([us, np.zeros(n)], -1),
            np.stack([us, np.full(n, calib.height - 1)], -1),
            np.stack([np.zeros(n), vs], -1),
            np.stack([np.full(n, calib.width - 1), vs], -1),
        ]
    )
    rays = unproject_pixels(_f32(border), calib.fx, calib.fy, calib.cx, calib.cy,
                            calib.dist).numpy()
    xn = rays[:, :2]
    # Outer (all) and inner (inscribed) extents of the undistorted border.
    outer = (xn[:, 0].min(), xn[:, 0].max(), xn[:, 1].min(), xn[:, 1].max())
    top, bottom, left, right = xn[:n], xn[n:2 * n], xn[2 * n:3 * n], xn[3 * n:]
    inner = (left[:, 0].max(), right[:, 0].min(), top[:, 1].max(), bottom[:, 1].min())
    x0o, x1o, y0o, y1o = outer
    x0i, x1i, y0i, y1i = inner
    x0 = alpha * x0o + (1 - alpha) * x0i
    x1 = alpha * x1o + (1 - alpha) * x1i
    y0 = alpha * y0o + (1 - alpha) * y0i
    y1 = alpha * y1o + (1 - alpha) * y1i

    fx_new = (W_out - 1) / (x1 - x0)
    fy_new = (H_out - 1) / (y1 - y0)
    cx_new = -x0 * fx_new
    cy_new = -y0 * fy_new

    # For each output pixel: normalized coords under the new K -> distort -> source px.
    vv, uu = np.meshgrid(np.arange(H_out), np.arange(W_out), indexing="ij")
    xn_out = np.stack([(uu - cx_new) / fx_new, (vv - cy_new) / fy_new], axis=-1)
    xd = distort_normalized(_f32(xn_out), calib.dist).numpy()
    map_u = xd[..., 0] * calib.fx + calib.cx
    map_v = xd[..., 1] * calib.fy + calib.cy
    maps = np.stack([map_u, map_v], axis=-1).astype(np.float32)

    new_calib = CameraCalib(
        fx=float(fx_new), fy=float(fy_new), cx=float(cx_new), cy=float(cy_new),
        dist=(0.0, 0.0, 0.0, 0.0), width=W_out, height=H_out,
        T_body_cam=calib.T_body_cam,
        rate_cam_hz=calib.rate_cam_hz, rate_imu_hz=calib.rate_imu_hz,
    )
    return maps, new_calib


def remap_bilinear(image, maps):
    """Bilinear remap: sample `image` (H, W) or (H, W, C) at `maps`
    (Ho, Wo, 2) (u, v), both tensors on one device; float32 out.

    Floor, the four neighbours gathered with clamped indices, each zero
    where it lies outside the image (a constant border), then the lerp.
    """
    H, W = image.shape[0], image.shape[1]
    u = maps[..., 0]
    v = maps[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    flat = image.reshape(H * W, -1).float()

    def sample(vi, ui):
        valid = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        idx = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
        vals = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (flat.shape[1],))
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    du = du[..., None]
    dv = dv[..., None]
    out = (
        sample(v0i, u0i) * (1 - du) * (1 - dv)
        + sample(v0i, u0i + 1) * du * (1 - dv)
        + sample(v0i + 1, u0i) * (1 - du) * dv
        + sample(v0i + 1, u0i + 1) * du * dv
    )
    return out if image.dim() == 3 else out[..., 0]


def undistort_image(image, maps):
    """remap_bilinear(image, maps), with maps taken to the image's device."""
    return remap_bilinear(image, torch.as_tensor(maps, device=image.device))
