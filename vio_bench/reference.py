"""The plain reference of one VIO frame: what the step must output for a
frame, given the frame, its keyframe and the attitude, written from the
method's description in plain PyTorch (any device, no kernel, no vmap).

It covers, per frame: the scale space (the Gaussian pyramid, or the
nonlinear FED scale space with its contrast factor), the detector response
and its 5x5 NMS, the grid top-k with subpixel refinement, the SIFT-128
descriptors, the ratio + mutual match, the rotation-compensated translation
RANSAC with JAX's threefry categorical draws (the stream the program keys
its hypotheses with), the sign vote, the guided rescue re-match and its
acceptance, the disparity, the quality gate, the keyframe policy and the
GT-scaled pose composition (the IMU pose where the frame is not solved)
and the velocity update. Separately, over a whole sequence, the inertial
chain: the Madgwick attitude with the gyro/accel bias recalibration, the
preintegration of each frame's IMU rows, and the IMU prediction of the
translation since the keyframe. The reference follows the program's own
state where a frame needs it (which frame is the keyframe, its keyframe
pose, the velocity of the frame before); see PERF.md.

`Precision` says in what it computes: the configuration's (pyramid levels
in bfloat16, everything else in float32, TF32 off) or the control's, one
step below (levels in float8 e4m3, the float32 stages in bfloat16).

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Precision(NamedTuple):
    level: torch.dtype      # pyramid levels
    f: torch.dtype          # the float32 stages


STATED = Precision(torch.bfloat16, torch.float32)
CONTROL = Precision(torch.float8_e4m3fn, torch.bfloat16)

BIG = 1e9


# ------------------------------------------------------------ filters

def gauss_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def correlate(img, kernel):
    """2-D correlation of (N, H, W) with a small kernel, zeros outside."""
    k = torch.as_tensor(np.asarray(kernel, np.float32)).to(img.device, img.dtype)
    kh, kw = k.shape
    return F.conv2d(img[:, None], k[None, None], padding=(kh // 2, kw // 2))[:, 0]


def blur(img, sigma: float, radius: int, rounded=None):
    """Separable Gaussian blur, along x then along y, zeros outside; with
    `rounded`, the taps and each pass's result are rounded to that type
    (a blur of an image held in it)."""
    g = gauss_taps(sigma, radius)
    if rounded is not None:
        g = torch.as_tensor(g).to(rounded).float().numpy()
    x = correlate(img, g[None, :])
    if rounded is not None:
        x = x.to(rounded).to(img.dtype)
    x = correlate(x, g[:, None])
    return x if rounded is None else x.to(rounded).to(img.dtype)


SCHARR_X = np.array([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]], np.float32) / 32.0


def scharr(img):
    return correlate(img, SCHARR_X), correlate(img, SCHARR_X.T)


def shi_tomasi(img):
    """The smaller eigenvalue of the structure tensor (Scharr gradients,
    products blurred by G(1.5, r3))."""
    gx, gy = scharr(img)
    a, b, c = blur(gx * gx, 1.5, 3), blur(gx * gy, 1.5, 3), blur(gy * gy, 1.5, 3)
    return 0.5 * (a + c) - torch.sqrt((0.5 * (a - c)) ** 2 + b * b + 1e-12)


def hessian(img):
    """det of the Hessian of G(1.5, r3) * img by iterated Scharr."""
    gx, gy = scharr(blur(img, 1.5, 3))
    gxx, gxy = scharr(gx)
    gyy = scharr(gy)[1]
    return gxx * gyy - gxy * gxy


RESPONSES = {"shi_tomasi": shi_tomasi, "hessian": hessian}


def nms(resp, radius: int):
    pooled = F.max_pool2d(resp[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
    return torch.where(resp >= pooled, resp, torch.full_like(resp, -math.inf))


def mean2(img):
    """2x2 mean of the even-cropped image."""
    n, h, w = img.shape
    x = img[:, : h - h % 2, : w - w % 2].float()
    return x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


# ------------------------------------------------------------ scale spaces

def gaussian_levels(image, levels: int, p: Precision):
    """Level 0 is the image in the level type; each next one the 2x2 mean
    of the last, rounded to it."""
    out = [image.to(p.level)]
    for _ in range(levels - 1):
        out.append(mean2(out[-1]).to(p.level))
    return out


def fed_taus(T: float, tau_max: float = 0.25):
    """Fast explicit diffusion step sizes (Grewenig et al. 2010) reaching
    diffusion time T in one cycle."""
    n = int(np.ceil(np.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1
    c = 1.0 / (4.0 * n + 2.0)
    taus = [tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) * c) ** 2) for j in range(n)]
    s = T / sum(taus)
    return [float(t * s) for t in taus]


def fed_cycle(L, k, T: float):
    """Perona-Malik diffusion (g2 conductivity, gradients of G(1, r2) * L)
    over one FED cycle; the image is extended by its edge values once by
    the cycle's reach (4 px a step) and cropped after it."""
    taus = fed_taus(T)
    h = 4 * len(taus)
    n, H, W = L.shape
    x = F.pad(L[:, None], (h, h, h, h), mode="replicate")[:, 0]
    for tau in taus:
        gx, gy = scharr(blur(x, 1.0, 2))
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))
        xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        gp = F.pad(g[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        Hh, Ww = x.shape[-2:]
        flux = torch.zeros_like(x)
        for dv, du in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            flux = flux + 0.5 * (g + gp[:, 1 + dv:1 + dv + Hh, 1 + du:1 + du + Ww]) * (
                xp[:, 1 + dv:1 + dv + Hh, 1 + du:1 + du + Ww] - x)
        x = x + tau * flux
    return x[:, h:h + H, h:h + W]


def contrast_factor(image, p: Precision):
    """k: the 70th percentile (linear between ranks) of the 4x4-mean-pooled
    |grad G(1, r3) * image|^2, the image zero-padded once by 4 px and
    every stage run on the extended domain; sqrt, at least 1e-3."""
    x = F.pad(image.to(p.f)[:, None], (4, 4, 4, 4))[:, 0]
    gx, gy = scharr(blur(x, 1.0, 3))
    n, H, W = image.shape
    m = (gx * gx + gy * gy)[:, 4:4 + H, 4:4 + W]
    pooled = m[:, : H - H % 4, : W - W % 4].reshape(n, H // 4, 4, W // 4, 4).mean(dim=(2, 4))
    s = torch.sort(pooled.reshape(n, -1), dim=-1).values
    pos = 0.7 * (s.shape[-1] - 1)
    lo = int(math.floor(pos))
    w = pos - lo
    q = s[:, lo] * (1.0 - w) + s[:, min(lo + 1, s.shape[-1] - 1)] * w
    return torch.clamp(torch.sqrt(torch.clamp(q, min=0.0)), min=1e-3)


def nonlinear_levels(image, levels: int, p: Precision, sigma0: float = 1.6):
    """KAZE-style octaves: the image blurred by G(1, r3) in the level
    type, evolved to sigma0, then per octave evolved by 1.5 sigma0^2 and
    2x2-mean downsampled, k shrinking by 0.75; float32 from the evolution
    on."""
    img = image.to(p.level)
    k = contrast_factor(img, p)[:, None, None]
    L = fed_cycle(blur(img.to(p.f), 1.0, 3, rounded=p.level), k,
                  0.5 * max(sigma0 ** 2 - 1.0, 0.1))
    out = [L]
    for _ in range(levels - 1):
        L = mean2(fed_cycle(L, k, 1.5 * sigma0 ** 2)).to(p.f)
        k = k * 0.75
        out.append(L)
    return out


# ------------------------------------------------------------ features

class Features(NamedTuple):
    uv: torch.Tensor       # (n, K, 2) level-0 pixels
    desc: torch.Tensor     # (n, K, 128)
    level: torch.Tensor    # (n, K)
    mask: torch.Tensor     # (n, K) bool


def grid_topk(resp, rows: int, cols: int, k: int, border: int):
    """Per grid cell the k largest responses inside the border (equal
    values: the lower row-major index first) -> uv (n, cells*k, 2), score."""
    n, H, W = resp.shape
    r = torch.arange(H, device=resp.device)[:, None]
    c = torch.arange(W, device=resp.device)[None, :]
    inside = (r >= border) & (r < H - border) & (c >= border) & (c < W - border)
    resp = torch.where(inside, resp, torch.full_like(resp, -math.inf))
    ch, cw = H // rows, W // cols
    cells = resp[:, : ch * rows, : cw * cols].reshape(n, rows, ch, cols, cw)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(n, rows * cols, ch * cw)
    score, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    score, idx = score[..., :k], idx[..., :k]
    cell = torch.arange(rows * cols, device=resp.device)[:, None]
    v = (cell // cols) * ch + idx // cw
    u = (cell % cols) * cw + idx % cw
    return torch.stack([u, v], -1).reshape(n, -1, 2).to(resp.dtype), score.reshape(n, -1)


def refine_subpixel(resp, uv):
    """Per axis the vertex of the parabola through the response at the
    pixel and its two neighbours, within half a pixel."""
    n, H, W = resp.shape
    u = torch.clamp(uv[..., 0].long(), 1, W - 2)
    v = torch.clamp(uv[..., 1].long(), 1, H - 2)
    bi = torch.arange(n, device=resp.device)[:, None]

    def at(dv, du):
        return resp[bi, v + dv, u + du]

    c = at(0, 0)
    dx, dy = 0.5 * (at(0, 1) - at(0, -1)), 0.5 * (at(1, 0) - at(-1, 0))
    dxx, dyy = at(0, 1) + at(0, -1) - 2 * c, at(1, 0) + at(-1, 0) - 2 * c
    ou = torch.where(dxx.abs() > 1e-9, -dx / dxx, torch.zeros_like(c)).clamp(-0.5, 0.5)
    ov = torch.where(dyy.abs() > 1e-9, -dy / dyy, torch.zeros_like(c)).clamp(-0.5, 0.5)
    return uv + torch.stack([ou, ov], -1)


GRID, CELLS, NBINS, PATCH, MARGIN = 16, 4, 8, 32, 3


def _descriptor_geometry():
    """The 16x16 sample offsets (0.75 px apart: 1.5 x the 4 cells' span over
    the grid) and the (256, 16) spatial weights: trilinear cell weights
    times a Gaussian window of half the grid's width."""
    step = 1.5 * 2.0 * CELLS / GRID
    c = (GRID - 1) / 2.0
    ii, jj = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
    dy, dx = (ii - c) * step, (jj - c) * step
    cx = ((jj + 0.5) / GRID * CELLS - 0.5).reshape(-1)
    cy = ((ii + 0.5) / GRID * CELLS - 0.5).reshape(-1)
    sigma = GRID * step / 2.0
    gauss = np.exp(-(dx ** 2 + dy ** 2).reshape(-1) / (2.0 * sigma * sigma)).astype(np.float32)
    W = np.zeros((GRID * GRID, CELLS * CELLS), np.float32)
    x0, y0 = np.floor(cx).astype(int), np.floor(cy).astype(int)
    for sx, wx in ((x0, 1.0 - (cx - x0)), (x0 + 1, cx - x0)):
        for sy, wy in ((y0, 1.0 - (cy - y0)), (y0 + 1, cy - y0)):
            ok = (sx >= 0) & (sx < CELLS) & (sy >= 0) & (sy < CELLS)
            idx = np.clip(sy, 0, CELLS - 1) * CELLS + np.clip(sx, 0, CELLS - 1)
            np.add.at(W, (np.arange(GRID * GRID), idx), np.where(ok, wx * wy, 0.0) * gauss)
    return (dx[0].astype(np.float32), dy[:, 0].astype(np.float32), W)


_DX, _DY, _WSP = _descriptor_geometry()


def sift(level, uv):
    """Upright SIFT-128 of keypoints uv (n, K, 2) on level images (n, H, W):
    32x32 patches, blur G(0.6, r2) + Scharr, 16x16 bilinear samples, 8
    orientation bins by circular tent weights, the spatial weights, then
    L2-normalise, clip at 0.2, renormalise."""
    n, H, W = level.shape
    K = uv.shape[1]
    dt = level.dtype
    iu0 = torch.clamp(torch.floor(uv[..., 0]).long() - PATCH // 2 + 1, 0, W - PATCH)
    iv0 = torch.clamp(torch.floor(uv[..., 1]).long() - PATCH // 2 + 1, 0, H - PATCH)
    ar = torch.arange(PATCH, device=level.device)
    bi = torch.arange(n, device=level.device)[:, None, None, None]
    pat = level[bi, (iv0[..., None, None] + ar[:, None]), (iu0[..., None, None] + ar[None, :])]
    pat = pat.reshape(n * K, PATCH, PATCH)
    g = gauss_taps(0.6, 2)
    sm = correlate(correlate(pat, g[:, None]), g[None, :])
    s3 = np.array([3.0, 10.0, 3.0], np.float32) / 32.0
    d3 = np.array([-1.0, 0.0, 1.0], np.float32)
    gx = correlate(correlate(sm, s3[:, None]), d3[None, :])
    gy = correlate(correlate(sm, s3[None, :]), d3[:, None])
    lo, hi = float(MARGIN), PATCH - 1 - MARGIN - 1e-3
    dx = torch.as_tensor(_DX).to(level.device, dt)
    dy = torch.as_tensor(_DY).to(level.device, dt)
    lv = torch.clamp(uv[..., 1:2] + dy - iv0[..., None].to(dt), lo, hi).reshape(n * K, GRID)
    lu = torch.clamp(uv[..., 0:1] + dx - iu0[..., None].to(dt), lo, hi).reshape(n * K, GRID)
    v0, u0 = torch.floor(lv), torch.floor(lu)
    fv, fu = (lv - v0)[:, :, None], (lu - u0)[:, None, :]
    v0, u0 = v0.long()[:, :, None], u0.long()[:, None, :]
    ki = torch.arange(n * K, device=level.device)[:, None, None]

    def sample(f):
        return ((1 - fv) * ((1 - fu) * f[ki, v0, u0] + fu * f[ki, v0, u0 + 1])
                + fv * ((1 - fu) * f[ki, v0 + 1, u0] + fu * f[ki, v0 + 1, u0 + 1]))

    sx, sy = sample(gx).reshape(n * K, -1), sample(gy).reshape(n * K, -1)
    mag = torch.sqrt(sx * sx + sy * sy + 1e-12)
    obin = (torch.atan2(sy, sx) / (2.0 * math.pi) + 0.5) * NBINS - 0.5
    d = obin[..., None] - torch.arange(NBINS, device=level.device, dtype=dt)
    d = d - NBINS * torch.round(d / NBINS)
    hist = mag[..., None] * torch.clamp(1.0 - d.abs(), min=0.0)          # (nK, 256, 8)
    wsp = torch.as_tensor(_WSP).to(level.device, dt)
    desc = torch.einsum("ksb,sc->kcb", hist, wsp).reshape(n, K, CELLS * CELLS * NBINS)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)


def extract(images, fe: dict, p: Precision) -> Features:
    """Features of frames (n, H, W): detect on each used level, describe
    on the keypoint's own level; K = cells x (8 at level 0 + 4 above)."""
    levels = fe["levels_used"]
    if fe["scale_space"] == "nonlinear":
        pyr = nonlinear_levels(images, levels, p)
    else:
        pyr = gaussian_levels(images, levels, p)
    border = fe["patch_size"] // 2 + 4
    uvs, scores, lvls, descs = [], [], [], []
    for lv in range(levels):
        img = pyr[lv].to(p.f)
        resp = RESPONSES[fe["detector"]](img)
        k = fe["kp_per_cell"] if lv == 0 else fe["kp_per_cell_coarse"]
        uv, score = grid_topk(nms(resp, fe["nms_radius"]), fe["grid_rows"], fe["grid_cols"],
                              k, border)
        uv = refine_subpixel(resp, uv)
        descs.append(sift(img, uv))
        uvs.append(uv * float(2 ** lv))
        scores.append(score)
        lvls.append(torch.full(score.shape, lv, device=images.device))
    score = torch.cat(scores, 1)
    finite = torch.isfinite(score)
    top = torch.max(torch.where(finite, score, torch.zeros_like(score)), dim=1, keepdim=True).values
    mask = finite & (score > torch.clamp(fe["min_score"] * top, min=1e-12))
    return Features(torch.cat(uvs, 1), torch.cat(descs, 1), torch.cat(lvls, 1), mask)


# ------------------------------------------------------------ matching

class Matches(NamedTuple):
    idx: torch.Tensor      # (K,) B row of each A row
    mask: torch.Tensor     # (K,) bool


def match(da, ma, db, mb, ratio: float, uv_pred=None, uv_b=None, radius: float = 0.0):
    """Squared L2 distances; the nearest B row of each A row passes the
    Lowe ratio test on squared distances and the mutual check; with a
    radius, only pairs whose B keypoint lies in the disc around the A
    row's prediction are candidates."""
    d = torch.clamp((da * da).sum(-1)[:, None] + (db * db).sum(-1)[None, :] - 2.0 * da @ db.T,
                    min=0.0)
    ok = ma[:, None] & mb[None, :]
    if radius > 0.0:
        gap = uv_pred[:, None, :] - uv_b[None, :, :]
        ok = ok & ((gap * gap).sum(-1) <= radius * radius)
    d = torch.where(ok, d, torch.full_like(d, BIG))
    min1, arg1 = torch.min(d, dim=1)
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), arg1] = BIG
    min2 = d2.min(dim=1).values
    col = torch.argmin(d, dim=0)
    good = ma & (min1 < BIG * 0.5) & (min1 < ratio * ratio * torch.clamp(min2, min=1e-12))
    good = good & (col[arg1] == torch.arange(d.shape[0], device=d.device))
    return Matches(arg1, good)


# ------------------------------------------------------------ JAX's threefry stream

_M32 = 0xFFFFFFFF


def threefry(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), on int64 tensors
    holding uint32 values."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x1, x2 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def fold_in(key, d):
    """jax.random.fold_in (and split(key, n)[d]): key (..., 2) int64."""
    d = torch.as_tensor(d, dtype=torch.int64, device=key.device)
    h1, h2 = threefry(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(h1, h2), -1)


def prng_key(seed: int, device) -> torch.Tensor:
    """jax.random.PRNGKey of a 32-bit seed."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def categorical(key, logits, n: int, dt):
    """jax.random.categorical(key, logits, shape=(n,)): the argmax of
    logits + Gumbel(key, (n, M)), Gumbel = -log(-log(uniform in [tiny, 1)))
    from the top 23 bits of each counter's hash; logs in float64 rounded
    to the float32 (or the control's) type."""
    M = logits.shape[-1]
    i = torch.arange(n * M, dtype=torch.int64, device=logits.device)
    h1, h2 = threefry(key[0], key[1], torch.zeros_like(i), i)
    bits = ((h1 ^ h2) >> 9) | 0x3F800000
    u = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32) - 1.0
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.clamp(u + tiny, min=tiny)
    e = (-torch.log(u.double())).to(dt)
    g = (-torch.log(e.double())).to(dt)
    return torch.argmax(g.reshape(n, M) + logits.to(dt), dim=-1)


# ------------------------------------------------------------ two-view geometry

def rays(uv, cam):
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    r = torch.stack([x, y, torch.ones_like(x)], -1)
    return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)


class Solve(NamedTuple):
    t: torch.Tensor        # (3,) unit direction, frame-j coordinates
    inliers: torch.Tensor  # (M,) bool
    count: torch.Tensor    # () int


def ransac(ri, rj, R_ji, mask, key, uv_i, be: dict, dt):
    """The translation direction t is orthogonal to every epipolar normal
    n = r_j x R_ji r_i: hypotheses n_a x n_b from two categorical draws
    over the valid matches, scored by inliers |n.t| < thresh times the
    inliers' spatial spread^pow, the best refined as the smallest
    eigenvector of its inliers' scatter."""
    n = torch.linalg.cross(rj, ri @ R_ji.T, dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(nn, min=1e-12)
    w = (mask & (nn[:, 0] > 1e-5)).to(dt)
    logits = torch.log((w + 1e-9).float()).to(dt)
    H = be["ransac_hyps"]
    ia = categorical(fold_in(key, 0), logits, H, dt)
    ib = categorical(fold_in(key, 1), logits, H, dt)
    t = torch.linalg.cross(n[ia], n[ib], dim=-1)
    tn = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    t = t / torch.clamp(tn, min=1e-12)
    hyp_ok = (tn[:, 0] > 1e-6) & (ia != ib)
    thr = be["ransac_thresh"]
    inl = (torch.abs(t @ n.T) < thr).to(dt) * w
    votes = inl.sum(-1)
    ext = torch.stack([uv_i[:, 0].max() + 1.0, uv_i[:, 1].max() + 1.0])
    uvn = uv_i / ext
    cnt = torch.clamp(votes, min=1.0)[:, None]
    mu, m2 = (inl @ uvn) / cnt, (inl @ (uvn * uvn)) / cnt
    spread = torch.sqrt(torch.clamp((m2 - mu * mu).sum(-1), min=1e-12))
    score = torch.where(hyp_ok, votes * spread ** be["ransac_dispersion_pow"],
                        torch.full_like(votes, -1.0))
    best = t[torch.argmax(score)]
    sel = (torch.abs(n @ best) < thr) & (w > 0)
    S = (n[sel].T @ n[sel]).double() + 1e-9 * torch.eye(3, dtype=torch.float64,
                                                         device=n.device)
    t_ref = torch.linalg.eigh(S)[1][:, 0].to(dt)
    t_ref = t_ref * torch.sign(torch.dot(t_ref, best) + 1e-12)
    inliers = (torch.abs(n @ t_ref) < thr) & (w > 0)
    return Solve(t_ref, inliers, inliers.sum())


def sign_vote(ri, rj, R_ji, t, inliers):
    """t or -t, whichever puts more inliers' midpoint depths along r_j in
    front of the camera (ties: t)."""
    rot = ri @ R_ji.T
    a, b, c = (rot * rot).sum(-1), -(rot * rj).sum(-1), (rj * rj).sum(-1)
    r1, r2 = -(rot * t).sum(-1), (rj * t).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    dj = (a * r2 - b * r1) / det
    return t if int(((dj > 0) & inliers).sum()) >= int(((dj < 0) & inliers).sum()) else -t


def disparity(uv_i, uv_j, mask, R_ji, cam):
    """Mean pixel distance of the matches from where the rotation alone
    (the infinite-depth homography) puts them."""
    r = torch.stack([(uv_i[:, 0] - cam.cx) / cam.fx, (uv_i[:, 1] - cam.cy) / cam.fy,
                     torch.ones_like(uv_i[:, 0])], -1) @ R_ji.T
    z = torch.clamp(r[:, 2].abs(), min=1e-9) * torch.where(r[:, 2] < 0, -1.0, 1.0)
    du = uv_j[:, 0] - (r[:, 0] / z * cam.fx + cam.cx)
    dv = uv_j[:, 1] - (r[:, 1] / z * cam.fy + cam.cy)
    d = torch.sqrt(du * du + dv * dv)
    return (d * mask).sum() / torch.clamp(mask.sum(), min=1)


def predict_uv(uv, R_ji, cam):
    x = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                     torch.ones_like(uv[:, 0])], -1) @ R_ji.T
    z = torch.where(x[:, 2].abs() > 1e-6, x[:, 2], torch.full_like(x[:, 2], 1e-6))
    return torch.stack([x[:, 0] / z * cam.fx + cam.cx, x[:, 1] / z * cam.fy + cam.cy], -1)


class FrameOut(NamedTuple):
    num_matches: int
    num_inliers: int
    used_fallback: bool
    is_keyframe: bool
    t_dir: torch.Tensor    # (3,) float64
    p_wc: torch.Tensor     # (3,) float64
    v_w: torch.Tensor      # (3,) float64


def frame(feat_j: Features, feat_i: Features, R_ji, key, imu: "FrameImu", gt_norm, kf_R_wc,
          kf_p_wc, cam, cfg: dict, p: Precision) -> FrameOut:
    """One frame's outputs from its features (index 0 of feat_j) and its
    keyframe's (index 0 of feat_i). R_ji: the IMU's rotation keyframe ->
    frame; key: the frame's draw key (fold_in(sequence key, frame)); imu:
    the frame's IMU prediction (`predict`); gt_norm: the GT distance since
    the keyframe (the translation's scale: GT-scaled traffic)."""
    fe, be, en = cfg["frontend"], cfg["backend"], cfg["engine"]
    dt = p.f
    R_ji = R_ji.to(dt)
    uv_i, uv_b = feat_i.uv[0].to(dt), feat_j.uv[0].to(dt)
    K = uv_b.shape[0]
    kmask, fmask = feat_i.mask[0], feat_j.mask[0]
    fine = feat_i.level[0] == 0
    m = match(feat_i.desc[0], kmask, feat_j.desc[0], fmask, fe["ratio_thresh"])
    ri = rays(uv_i, cam)

    def solve(mt, k):
        uv_j = uv_b[torch.clamp(mt.idx, 0, K - 1)]
        rj = rays(uv_j, cam)
        s = ransac(ri, rj, R_ji, mt.mask & fine, k, uv_i, be, dt)
        return uv_j, rj, s._replace(t=sign_vote(ri, rj, R_ji, s.t, s.inliers))

    uv_j, rj, est = solve(m, key)
    t_pred = imu.t_pred.to(dt)
    imu_norm = torch.linalg.vector_norm(t_pred)
    t_pred_dir = t_pred / torch.clamp(imu_norm, min=1e-9)
    cos_est = torch.dot(est.t, t_pred_dir)
    dir_trig = bool((imu_norm > fe["fallback_dir_min_norm"]) & (cos_est < fe["fallback_dir_cos"]))
    triggered = (int(est.count) < fe["fallback_trigger_inliers"] or dir_trig) and \
        int(fmask.sum()) > 0
    mg = match(feat_i.desc[0], kmask, feat_j.desc[0], fmask, fe["ratio_thresh"],
               predict_uv(uv_i, R_ji, cam), uv_b, fe["guided_fallback_px"])
    uv_jg, _, est_g = solve(mg, fold_in(key, 7))
    # The GT-scale acceptance: more inliers by the margin, or, where the
    # direction was what triggered, a direction nearer the IMU's with most
    # of the inliers kept.
    better = int(est_g.count) > fe["fallback_win_margin"] * int(est.count)
    cos_g = torch.dot(est_g.t, t_pred_dir)
    better = better or (dir_trig and bool(cos_g > cos_est + 0.15)
                        and int(est_g.count) >= max(int(0.7 * int(est.count)), 8))
    take = triggered and better
    if take:
        m, uv_j, est = mg, uv_jg, est_g
    num_matches = int(m.mask.sum())
    disp = disparity(uv_i, uv_j, m.mask, R_ji, cam)
    kf_fine = int((kmask & fine).sum())
    solved = num_matches >= max(int(en["min_feature_ratio"] * kf_fine), 8) and int(est.count) >= 8
    rot_cos = 0.5 * (torch.trace(R_ji) - 1.0)
    is_kf = solved and bool((disp > en["kf_disparity_px"])
                            | (rot_cos < math.cos(math.radians(en["kf_rotation_deg"]))))
    t64, R64 = est.t.double(), R_ji.double()
    if solved:
        p_wc = kf_p_wc.double() - kf_R_wc.double() @ (R64.T @ (t64 * float(gt_norm)))
        v_target = (p_wc - kf_p_wc.double()) / max(float(imu.t_since_kf), 1e-3)
    else:
        p_wc = kf_p_wc.double() + imu.dp_since_kf.double()
        v_target = imu.v_imu.double()
    # The velocity moves towards its target by at most 20 m/s^2 x the
    # frame's time, and stays within the configuration's bound.
    v_prev = imu.v_prev.double()
    dv_max = 20.0 * max(float(imu.T), 1e-3)
    v_w = torch.clamp(v_prev + torch.clamp(v_target - v_prev, -dv_max, dv_max),
                      -en["max_velocity"], en["max_velocity"])
    return FrameOut(num_matches, int(est.count), take, is_kf, t64, p_wc, v_w)


# ------------------------------------------------------------ inertial chain

def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1,
    ).reshape(q.shape[:-1] + (3, 3))


def madgwick(q, gyro, accel, dt, beta: float, g: float):
    """Madgwick's IMU filter (2010) over the rows of one frame's window:
    gyro integration plus a normalised gradient step towards the measured
    gravity direction, weighted by exp(-((|a| - g) / (0.1 g))^2)."""
    for s in range(gyro.shape[-2]):
        w_, a = gyro[..., s, :], accel[..., s, :]
        an = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-9)
        qw, qx, qy, qz = q.unbind(-1)
        ax, ay, az = an.unbind(-1)
        f1 = 2 * (qx * qz - qw * qy) - ax
        f2 = 2 * (qw * qx + qy * qz) - ay
        f3 = 2 * (0.5 - qx * qx - qy * qy) - az
        grad = torch.stack([-2 * qy * f1 + 2 * qx * f2,
                            2 * qz * f1 + 2 * qw * f2 - 4 * qx * f3,
                            -2 * qw * f1 + 2 * qz * f2 - 4 * qy * f3,
                            2 * qx * f1 + 2 * qy * f2], -1)
        grad = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-12)
        amag = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        wgt = torch.exp(-((amag - g).abs() / g / 0.1) ** 2) * (amag > 1e-6).to(q.dtype)
        omega = torch.cat([torch.zeros_like(w_[..., :1]), w_], -1)
        q = q + (0.5 * quat_mul(q, omega) - beta * wgt * grad) * dt[..., s, None]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return q


class Attitude(NamedTuple):
    q: torch.Tensor         # (B, N, 4) after each frame
    bias_g: torch.Tensor    # (B, N, 3) the biases each frame's rows are corrected by
    bias_a: torch.Tensor


def attitude(q0, imu, imu_dt, en: dict, p: Precision) -> Attitude:
    """The inertial chain of B sequences over N frames: per frame the
    Madgwick update (beta 0.02) with the current biases removed, then the
    quasi-static bias recalibration (gyro towards the window's mean rate,
    accel towards the mean specific force less the expected gravity). Only
    the IMU enters, so this is the program's attitude at every frame.
    q0 (B, 4), imu (B, N, S, 6), imu_dt (B, N, S)."""
    dt = p.f
    q, imu, imu_dt = q0.to(dt), imu.to(dt), imu_dt.to(dt)
    g = en["gravity"]
    bg = torch.zeros(q.shape[:-1] + (3,), dtype=dt, device=q.device)
    ba = torch.zeros_like(bg)
    out, bgs, bas = [], [], []
    for n in range(imu.shape[1]):
        w_raw, a_raw, d = imu[:, n, :, :3], imu[:, n, :, 3:], imu_dt[:, n]
        q = madgwick(q, w_raw - bg[:, None], a_raw - ba[:, None], d, 0.02, g)
        out.append(q)
        bgs.append(bg)
        bas.append(ba)
        if not en["gyro_recalib"]:
            continue
        valid = (d > 0).to(dt)[..., None]
        cnt = valid.sum(1)
        nf = torch.clamp(cnt, min=1.0)
        wm, am = (w_raw * valid).sum(1) / nf, (a_raw * valid).sum(1) / nf
        ws = torch.sqrt(torch.clamp((((w_raw - wm[:, None]) ** 2) * valid).sum(1) / nf, min=0.0))
        as_ = torch.sqrt(torch.clamp((((a_raw - am[:, None]) ** 2) * valid).sum(1) / nf, min=0.0))
        still = ((cnt[:, 0] >= 4.0) & (ws.max(-1).values < en["recalib_gyro_std"])
                 & (as_.max(-1).values < en["recalib_accel_std"])
                 & ((torch.linalg.vector_norm(am, dim=-1) - g).abs() < en["recalib_accel_dev"])
                 & (torch.linalg.vector_norm(wm - bg, dim=-1) < 0.05))[:, None]
        dbg = torch.where(still, en["recalib_alpha"] * (wm - bg), torch.zeros_like(bg))
        if en["accel_recalib"]:
            f_exp = torch.einsum("bji,j->bi", quat_to_mat(q),
                                 torch.tensor([0.0, 0.0, g], dtype=dt, device=q.device))
            target = am - f_exp
            ok = still & (torch.linalg.vector_norm(target - ba, dim=-1, keepdim=True) < 0.5)
            ba = ba + torch.where(ok, en["recalib_accel_alpha"] * (target - ba),
                                  torch.zeros_like(ba))
        bg = bg + dbg
    return Attitude(torch.stack(out, 1), torch.stack(bgs, 1), torch.stack(bas, 1))


def hat(w):
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(w.shape[:-1] + (3, 3))


def rot_exp(w):
    """Rodrigues' formula, rotation vector (..., 3) -> (..., 3, 3), with
    sin(t)/t and 2 sin^2(t/2)/t^2 (their series under 1e-4 rad)."""
    t2 = (w * w).sum(-1)
    t = torch.sqrt(t2)
    small = t < 1e-4
    ts = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0, 2.0 * torch.sin(0.5 * ts) ** 2 / (ts * ts))
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def preintegrate(gyro, accel, dt):
    """Forster's preintegration of each frame's rows (..., S, 3), biases
    already removed: the velocity and position change in the first row's
    body frame and the time they span. Rows with dt = 0 change nothing."""
    dR = torch.eye(3, dtype=gyro.dtype, device=gyro.device).expand(gyro.shape[:-2] + (3, 3))
    dv = torch.zeros_like(gyro[..., 0, :])
    dp = torch.zeros_like(dv)
    T = torch.zeros_like(dt[..., 0])
    for s in range(gyro.shape[-2]):
        d = dt[..., s, None]
        acc = (dR @ accel[..., s, :, None])[..., 0]
        dp = dp + dv * d + 0.5 * acc * d * d
        dv = dv + acc * d
        dR = dR @ rot_exp(gyro[..., s, :] * d)
        T = T + dt[..., s]
    return dv, dp, T


class FrameImu(NamedTuple):
    """The IMU's part of each frame (P passes, B sequences, N frames)."""

    t_pred: torch.Tensor       # (P, B, N, 3) predicted keyframe -> frame translation, frame coords
    dp_since_kf: torch.Tensor  # (P, B, N, 3) IMU displacement since the keyframe, world
    v_imu: torch.Tensor        # (P, B, N, 3) the velocity the IMU alone propagates
    v_prev: torch.Tensor       # (P, B, N, 3) the velocity of the frame before
    t_since_kf: torch.Tensor   # (P, B, N) time since the keyframe, this frame's included
    T: torch.Tensor            # (B, N) this frame's integration time

    def at(self, p: int, b: int, n: int) -> "FrameImu":
        """Frame n of sequence b in pass p."""
        return FrameImu(*[x[p, b, n] for x in self[:5]], self.T[b, n])


def predict(att: Attitude, q0, v0, imu, imu_dt, v_out, kf_out, en: dict, cam_rate_hz: float,
            p: Precision) -> FrameImu:
    """The IMU prediction of every frame of every pass: each frame's rows
    preintegrated with the biases of `att`, then dead-reckoned from the
    frame before (its attitude and the velocity the program output there,
    v_out (P, B, N, 3); q0, v0 (B, ...) at the first keyframe) and summed
    since the last keyframe (kf_out (P, B, N), the program's flags)."""
    dt = p.f
    imu, imu_dt = imu.to(dt), imu_dt.to(dt)
    dv, dp, T = preintegrate(imu[..., :3] - att.bias_g[:, :, None].to(dt),
                             imu[..., 3:] - att.bias_a[:, :, None].to(dt), imu_dt)
    T = torch.where(T > 1e-6, T, torch.full_like(T, 1.0 / cam_rate_hz))
    q = att.q.to(dt)
    R_prev = quat_to_mat(torch.cat([q0.to(dt)[:, None], q[:, :-1]], 1))     # (B, N, 3, 3)
    v_prev = torch.cat([v0.to(dt)[None, :, None].expand(v_out.shape[0], -1, -1, -1),
                        v_out.to(dt)[:, :, :-1]], 2)                           # (P, B, N, 3)
    g_w = torch.tensor([0.0, 0.0, -en["gravity"]], dtype=dt, device=q.device)
    Tn = T[..., None]
    dp_step = v_prev * Tn + 0.5 * g_w * Tn * Tn + (R_prev @ dp[..., None])[..., 0]
    v_imu = v_prev + g_w * Tn + (R_prev @ dv[..., None])[..., 0]
    Tp = T.expand(v_out.shape[:3])
    since, t_since = [dp_step[:, :, 0]], [Tp[:, :, 0]]
    for n in range(1, T.shape[1]):
        keep = ~kf_out[:, :, n - 1]
        since.append(dp_step[:, :, n] + since[-1] * keep[..., None])
        t_since.append(Tp[:, :, n] + t_since[-1] * keep)
    since, t_since = torch.stack(since, 2), torch.stack(t_since, 2)
    t_pred = -(quat_to_mat(q).transpose(-1, -2) @ since[..., None])[..., 0]
    return FrameImu(t_pred, since, v_imu, v_prev, t_since, T)
