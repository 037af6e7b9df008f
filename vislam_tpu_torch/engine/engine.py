"""The VIO engine: the per-frame step (port of `vislam_tpu/engine/engine.py`:
GT scale or GT-free IMU scale, open loop or SLAM mode, IMU or vision-only
rotation, every frontend, upright or oriented, ungated or always gated),
and the host loop's API (`step_pipelined`, `step_host`, the packed result).

One frame: Madgwick attitude + IMU preintegration, feature extraction,
descriptor match against the keyframe (with `frontend.guided_gate_px`,
inside the IMU-rotation-predicted disc), IMU-rotation-compensated
translation RANSAC and its sign, the guided rescue re-match (ungated runs),
disparity, gyro/accel bias recalibration, the shadow depth chain, the
photometric refine of the relative pose (`engine.photometric_refine`,
`backend/photometric.py`), pose composition, the keyframe policy and the
window promotion; GT-free, the linear VI alignment of the window
(`engine/bootstrap.py`); in SLAM mode (`backend.refine_in_step`), the
window (VI-)BA (`engine/refine.py`) under any of its gauges.

No host sync inside a frame: every `lax.cond` of the reference on a device
value (the rescue, the promotion, the alignment, the in-step refine)
computes both branches and selects with `torch.where`, and no value on the
device steers Python control flow. So the rescue's gated re-match and
RANSAC, the alignment and the window BA run on every frame. Branches the
reference takes on the static config (the always-gated match, which has
no rescue; the photometric refine) are Python branches here too.

An unknown window-BA gauge name raises ValueError at construction
(`engine/refine.py::check_gauge`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vislam_tpu_torch import lie
from vislam_tpu_torch.backend.photometric import photometric_align
from vislam_tpu_torch.backend.triangulate import triangulate_midpoint
from vislam_tpu_torch.calib.camera_model import CameraCalib, unproject_pixels
from vislam_tpu_torch.engine.bootstrap import vi_align_window
from vislam_tpu_torch.engine.refine import check_gauge, refine_window
from vislam_tpu_torch.engine.state import EngineState, init_state, tree_where
from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry
from vislam_tpu_torch.frontend.essential import ransac_essential
from vislam_tpu_torch.frontend.features import Features, extract_features
from vislam_tpu_torch.frontend.match import match_descriptors
from vislam_tpu_torch.frontend.pyramid import build_pyramid
from vislam_tpu_torch.frontend.pose import (
    SPLIT_PATHS,
    ransac_translation,
    resolve_direction_sign,
    rotation_compensated_disparity,
)
from vislam_tpu_torch.inertial.filters import madgwick_scan
from vislam_tpu_torch.inertial.preintegration import (
    Preintegrated,
    bias_correct,
    compose,
    preintegrate,
)
from vislam_tpu_torch.ops.threefry_kernel import FrameKey, threefry_gumbel
from vislam_tpu_torch.utils import prng
from vislam_tpu_torch.utils.config import SystemConfig

class FrameResult(NamedTuple):
    """Per-frame outputs (field for field the reference's)."""

    p_wc: torch.Tensor         # (3,) camera position estimate
    R_wc: torch.Tensor         # (3, 3)
    q_wb: torch.Tensor         # (4,) body orientation from the filter
    v_w: torch.Tensor          # (3,)
    is_keyframe: torch.Tensor  # () bool
    num_matches: torch.Tensor  # () int32
    num_inliers: torch.Tensor  # () int32
    disparity: torch.Tensor    # () float32
    t_dir_cam: torch.Tensor    # (3,) translation direction (new-cam frame)
    used_fallback: torch.Tensor  # () bool, the rescue re-match was taken
    t_pred_cam: torch.Tensor   # (3,) IMU-predicted keyframe->frame translation


class HostFrameResult(NamedTuple):
    """Per-frame outputs on the host, unpacked from the one (37,) float32
    vector a host-loop step returns (`unpack_host_result`)."""

    p_wc: np.ndarray
    R_wc: np.ndarray
    q_wb: np.ndarray
    v_w: np.ndarray
    rpy: np.ndarray
    is_keyframe: bool
    num_matches: int
    num_inliers: int
    disparity: float
    t_dir_cam: np.ndarray
    used_fallback: bool
    t_pred_cam: np.ndarray
    shadow_p_wc: np.ndarray
    bootstrap_applies: int


def unpack_host_result(f: np.ndarray) -> HostFrameResult:
    """Decode the packed (37,) result vector (the reference's layout)."""
    return HostFrameResult(
        p_wc=f[0:3], R_wc=f[3:12].reshape(3, 3), q_wb=f[12:16],
        v_w=f[16:19], rpy=f[19:22],
        is_keyframe=bool(f[22] > 0.5),
        num_matches=int(f[23]), num_inliers=int(f[24]),
        disparity=float(f[25]), used_fallback=bool(f[26] > 0.5),
        t_dir_cam=f[27:30], t_pred_cam=f[30:33],
        shadow_p_wc=f[33:36], bootstrap_applies=int(f[36]),
    )


def pack_result(state: "EngineState", r: FrameResult) -> torch.Tensor:
    """A frame's result and the state's shadow position and bootstrap count
    as one (37,) float32 vector on the step's device."""
    f = [r.is_keyframe, r.num_matches, r.num_inliers, r.disparity, r.used_fallback]
    return torch.cat([
        r.p_wc, r.R_wc.reshape(-1), r.q_wb, r.v_w, lie.quat_to_rpy(r.q_wb),
        torch.stack([x.to(torch.float32) for x in f]),
        r.t_dir_cam, r.t_pred_cam, state.shadow_p_wc,
        state.bootstrap_applies.to(torch.float32).reshape(1),
    ])


def nanmedian(x):
    """Median of the non-NaN entries of a 1-D tensor, NaN if there are none.

    Averages the middle pair on an even count, as jnp.nanmedian does
    (torch.nanmedian takes the lower one), by sort and count: no host sync.
    """
    n = torch.sum(~torch.isnan(x)).float()
    s = torch.sort(x).values  # NaN sorts last
    q = 0.5 * (n - 1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    low = torch.clamp(torch.minimum(low, n - 1.0), min=0.0).long().reshape(1)
    high = torch.clamp(torch.minimum(high, n - 1.0), min=0.0).long().reshape(1)
    return s.index_select(0, low)[0] * lw + s.index_select(0, high)[0] * hw


def frame_key(seed: int, idx: int) -> np.ndarray:
    """The host key of frame `idx` of a run with `seed`: the reference's
    fold_in(PRNGKey(seed), idx), (2,) uint32."""
    return prng.fold_in(prng.prng_key(seed), idx)


# A frame's draws, as folds of its key (a FrameKey: the base key and the
# frame index, folded on the device): the translation RANSAC's split(key)
# -> (ka, kb); the rescue's split(fold_in(key, 7)); the essential RANSAC's
# key itself. The step draws each solve's indices in one launch of the
# categorical draw kernel (`ransac_translation` / `ransac_essential` with
# the key); these paths give the Gumbel fields of the same draws
# (`draw_fields`), for noise fed to a step.
RESCUE_FOLD = 7
MAIN_PATHS = SPLIT_PATHS
RESCUE_PATHS = tuple((RESCUE_FOLD,) + p for p in SPLIT_PATHS)
ESSENTIAL_PATHS = ((),)


def draw_fields(key: FrameKey, paths, size) -> torch.Tensor:
    """(J, *size) Gumbel fields of a frame key's J paths (plain PyTorch on
    the key's device)."""
    return threefry_gumbel(key.base.reshape(1, 2), key.index.reshape(1), paths, size)[0]


def require_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device where there is none
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


class VIOEngine:
    """Host wrapper owning the static config, the device and the constants
    the step needs on it. The device is the card unless the caller asks for
    another (`device="cpu"`); nothing is auto-detected and no path falls
    back to another device."""

    def __init__(self, calib: CameraCalib, cfg: SystemConfig = SystemConfig(),
                 seed: int = 0, *, device="cuda"):
        check_gauge(cfg.backend.online_gauge)
        self.device = require_device(device)
        self.calib = calib
        self.cfg = cfg
        self.seed = seed
        # Mirrors state.frame_idx (the reference's per-step key counter);
        # frame n draws under fold_in(PRNGKey(seed), n).
        self._step_counter = 0
        self._base_key = prng.key_tensor(prng.prng_key(seed), self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.R_bc = torch.as_tensor(np.asarray(calib.T_body_cam[:3, :3], np.float32),
                                    device=self.device)
        self.g_w = torch.tensor([0.0, 0.0, -cfg.engine.gravity], **f32)
        self.geom = DescriptorGeometry(self.device)

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, torch.float32)

    def initialize(self, image0, q_wb0=None, v_w0=None, p_w0=None) -> EngineState:
        """The first frame becomes the first keyframe."""
        img = self._to_device(image0)
        feat0 = extract_features(img, self.cfg.frontend, self.geom)
        q0 = self._to_device([1.0, 0.0, 0.0, 0.0] if q_wb0 is None else q_wb0)
        v0 = self._to_device(np.zeros(3) if v_w0 is None else v_w0)
        p0 = self._to_device(np.zeros(3) if p_w0 is None else p_w0)
        R_wc0 = lie.quat_to_mat(q0) @ self.R_bc
        return init_state(feat0, img, q0, v0, p0, R_wc0,
                          window_size=self.cfg.backend.window_size,
                          desc_dtype=getattr(torch, self.cfg.backend.window_desc_dtype))

    def set_step_counter(self, n: int) -> None:
        """Restore the per-step draw counter (= state.frame_idx) on resume."""
        self._step_counter = int(n)

    def _next_key(self) -> FrameKey:
        """The next frame's key: the counter goes up from pinned memory
        without waiting (no host sync), the base key is already there."""
        idx = torch.tensor([self._step_counter], dtype=torch.int32)
        self._step_counter += 1
        return FrameKey(self._base_key,
                        self._pinned(idx).to(self.device, non_blocking=True).reshape(()))

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        """t in page-locked memory when it goes to the card: a copy from
        pageable memory makes CUDA wait for the stream's queued work
        first, which stalls the host whenever the device runs behind it.
        In today's host-bound loop the queue is short and both copies cost
        about the same (scripts/torch_host_loop.py times the two)."""
        if self.device.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
            return t.pin_memory()
        return t

    def _upload(self, image, *vectors):
        """A frame's image (any dtype, cast to float32 on the device) and
        small float32 vectors (concatenated into one copy, split on the
        device), each copied from pinned memory without waiting."""
        img = self._pinned(torch.as_tensor(image)).to(self.device, non_blocking=True)
        img = img.to(torch.float32)
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(v, np.float32).reshape(-1) for v in vectors]))
        dev = self._pinned(flat).to(self.device, non_blocking=True)
        out, k = [], 0
        for v in vectors:
            shape = np.shape(v)
            n = int(np.prod(shape))
            out.append(dev[k:k + n].reshape(shape))
            k += n
        return (img, *out)

    def relocalize(self, state: EngineState, image, R_wc, p_wc) -> EngineState:
        """Re-anchor tracking at a known pose: the image becomes the first
        keyframe of a fresh window (its old contents disagree with the
        corrected pose); velocity and biases carry over, each set to 0 where
        it is not finite (this is also the divergence-recovery path)."""
        img = self._to_device(image)
        feat = extract_features(img, self.cfg.frontend, self.geom)
        R_wc = self._to_device(R_wc)
        p_wc = self._to_device(p_wc)
        q_wb = lie.mat_to_quat(R_wc @ self.R_bc.T)

        def finite(x):
            return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

        new = init_state(feat, img, q_wb, finite(state.v_w), p_wc, R_wc,
                         bias_g=finite(state.bias_g), bias_a=finite(state.bias_a),
                         window_size=self.cfg.backend.window_size,
                         desc_dtype=getattr(torch, self.cfg.backend.window_desc_dtype))
        return new._replace(frame_idx=state.frame_idx.clone(),
                            kf_count=state.kf_count + 1)

    def step_host_async(self, state: EngineState, image, imu, imu_dt,
                        gt_t_norm: float = -1.0):
        """Dispatch one frame without waiting: (new_state, packed), packed
        the (37,) result vector still on the device (decode it later with
        `unpack_host_result(packed.cpu().numpy())`). The image may be uint8
        (cast on the device)."""
        img, imu_d, dt_d = self._upload(image, imu, imu_dt)
        s, r = self._step(state, img, imu_d, dt_d, float(gt_t_norm), self._next_key())
        return s, pack_result(s, r)

    def step_host(self, state: EngineState, image, imu, imu_dt, gt_t_norm: float = -1.0):
        """One frame for a host loop: (new_state, HostFrameResult), one
        device-to-host copy."""
        s, flat = self.step_host_async(state, image, imu, imu_dt, gt_t_norm)
        return s, unpack_host_result(flat.cpu().numpy())

    def step_pipelined(self, state: EngineState, kf_gt_pos, image, imu, imu_dt, gt_p,
                       gt_on: float):
        """The host loop's step: (new_state, new_kf_gt_pos, packed), with no
        host feedback between frames. The GT position of the last keyframe
        rides a device carry (kf_gt_pos, updated where the frame is a
        keyframe, as `run_sequence_scan` carries it), so GT scale needs no
        fetch of the keyframe flag; gt_on (a host float) <= 0 selects the
        IMU scale. Frame j draws under `frame_key(seed, counter)`, as `step`
        and `run_sequence_scan` do."""
        img, imu_d, dt_d, gt_d = self._upload(image, imu, imu_dt, gt_p)
        kf_gt = self._pinned(torch.as_tensor(kf_gt_pos, dtype=torch.float32)).to(
            self.device, non_blocking=True)
        gt_norm = torch.linalg.vector_norm(gt_d - kf_gt) if gt_on > 0.0 else -1.0
        s, r = self._step(state, img, imu_d, dt_d, gt_norm, self._next_key())
        return s, torch.where(r.is_keyframe, gt_d, kf_gt), pack_result(s, r)

    def step(self, state: EngineState, image, imu, imu_dt, gt_t_norm: float = -1.0,
             noise=None, noise_rescue=None):
        """Process one frame. gt_t_norm (a host float): the GT distance since
        the last keyframe (GT scale), or < 0 for the IMU (GT-free) scale.

        noise / noise_rescue: optional (2, H, M) Gumbel noise for the main
        and the rescue RANSAC draws ((H, 8, M) for the essential-matrix
        RANSAC of vision-only rotation, which has no rescue); drawn under
        this frame's key (`frame_key(seed, frame index)`, the reference's)
        when not given.
        """
        gt_t_norm = float(gt_t_norm)
        return self._step(state, self._to_device(image), self._to_device(imu),
                          self._to_device(imu_dt), gt_t_norm, self._next_key(),
                          noise, noise_rescue)

    def _step(self, state: EngineState, image, imu, imu_dt, gt_t_norm,
              key: FrameKey | None, noise=None, noise_rescue=None):
        """The step body. gt_t_norm: a () device tensor or a float, >= 0 (GT
        scale), or a negative float (GT-free: IMU scale, the alignment).

        The RANSAC draws come from `noise` / `noise_rescue`, or where one is
        not given from `key` (the reference's keys: main split(key), rescue
        split(fold_in(key, 7)), essential key): each solve draws its
        hypotheses' indices in one launch once its logits exist (the
        rescue's after the guided re-match). Under `torch.func.vmap`
        (`run_batch_scan`) the key's base is mapped and each launch serves
        the whole batch."""
        gt_free = not torch.is_tensor(gt_t_norm) and gt_t_norm < 0
        cfg = self.cfg
        fe, be, en = cfg.frontend, cfg.backend, cfg.engine
        calib = self.calib
        fx, fy, cx, cy = calib.fx, calib.fy, calib.cx, calib.cy
        R_bc, g_w = self.R_bc, self.g_w
        kf_rot_thresh = float(np.cos(np.deg2rad(en.kf_rotation_deg)))
        kf = state.kf_feat

        # ---------------- inertial: orientation + preintegration
        gyro = imu[:, :3] - state.bias_g
        accel = imu[:, 3:] - state.bias_a
        q_wb, _ = madgwick_scan(state.q_wb, gyro, accel, imu_dt,
                                beta=0.02, gravity=en.gravity)
        pre = preintegrate(imu[:, :3], imu[:, 3:], imu_dt,
                           bias_gyro=state.bias_g, bias_accel=state.bias_a)

        # Relative camera rotation since the last keyframe.
        R_wb_j = lie.quat_to_mat(q_wb)
        R_wc_j_imu = R_wb_j @ R_bc
        R_ji_imu = R_wc_j_imu.T @ state.kf_R_wc

        def predict_uv(uv):
            """Keyframe pixels warped by the IMU rotation (the infinite-depth
            homography K R K^-1), |z| <= 1e-6 clamped."""
            x = (uv[:, 0] - cx) / fx
            y = (uv[:, 1] - cy) / fy
            w = torch.stack([x, y, torch.ones_like(x)], -1) @ R_ji_imu.T
            wz = torch.where(w[:, 2].abs() > 1e-6, w[:, 2], torch.full_like(w[:, 2], 1e-6))
            return torch.stack([w[:, 0] / wz * fx + cx, w[:, 1] / wz * fy + cy], -1)

        # ---------------- frontend
        feat = extract_features(image, fe, self.geom)
        Kb = feat.uv.shape[0]
        if fe.guided_gate_px > 0:
            # Always-on guided matching: candidates only inside the disc
            # around each keyframe keypoint's IMU-rotation prediction.
            m = match_descriptors(kf.desc, kf.mask, feat.desc, feat.mask,
                                  ratio=fe.ratio_thresh, mutual=fe.mutual_check,
                                  uv_pred=predict_uv(kf.uv), uv_b=feat.uv,
                                  gate_radius=fe.guided_gate_px)
        else:
            m = match_descriptors(kf.desc, kf.mask, feat.desc, feat.mask,
                                  ratio=fe.ratio_thresh, mutual=fe.mutual_check)
        fine_only = fe.solver_fine_only and fe.levels_used > 1
        uv_i = kf.uv
        uv_j = feat.uv[torch.clamp(m.idx_b, 0, Kb - 1).long()]
        num_matches = torch.sum(m.mask).to(torch.int32)
        solve_mask = m.mask & (kf.level == 0) if fine_only else m.mask

        def unit_rays(uv):
            r = unproject_pixels(uv, fx, fy, cx, cy)
            return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)

        rays_i = unit_rays(uv_i)
        rays_j = unit_rays(uv_j)

        # IMU displacement since the keyframe (empty IMU window: the frame
        # period stands in for the integration time).
        T = torch.where(pre.dt > 1e-6, pre.dt,
                        torch.full_like(pre.dt, 1.0 / max(calib.rate_cam_hz, 1.0)))
        R_wb_prev = lie.quat_to_mat(state.q_wb)
        dp_step = state.v_w * T + 0.5 * g_w * T * T + R_wb_prev @ pre.dp
        dp_since_kf = state.kf_dp_imu + dp_step
        imu_t_norm = torch.linalg.vector_norm(dp_since_kf)
        t_pred_cam = -(R_wc_j_imu.T @ dp_since_kf)
        t_pred_dir = t_pred_cam / torch.clamp(imu_t_norm, min=1e-9)

        # ---------------- two-view relative pose
        H_hyp = be.ransac_hyps
        vision = en.vision_rotation
        rescue = fe.guided_fallback_px > 0 and fe.guided_gate_px == 0 and not vision
        if key is None and (noise is None or (rescue and noise_rescue is None)):
            raise ValueError("the step needs noise and noise_rescue, or a key")
        used_fallback = torch.zeros((), dtype=torch.bool, device=self.device)
        if vision:
            # Vision-only rotation (no IMU): rotation and translation
            # direction from the essential matrix.
            est_e = ransac_essential(rays_i, rays_j, solve_mask, key=key, num_hyps=H_hyp,
                                     thresh=be.ransac_thresh, uv_i=uv_i,
                                     dispersion_pow=be.ransac_dispersion_pow, noise=noise)
            R_ji = est_e.R_ji
            t_dir = est_e.t_dir
            est_inliers = est_e.num_inliers
            est_inlier_mask = est_e.inlier_mask
        else:
            R_ji = R_ji_imu
            est = ransac_translation(rays_i, rays_j, R_ji, solve_mask, key=key, num_hyps=H_hyp,
                                     thresh=be.ransac_thresh, uv_i=uv_i,
                                     dispersion_pow=be.ransac_dispersion_pow, noise=noise)
            t_dir = resolve_direction_sign(rays_i, rays_j, R_ji, est.t_dir, est.inlier_mask)
            est_inliers = est.num_inliers
            est_inlier_mask = est.inlier_mask

        if rescue:
            # Rescue (ungated runs only; an always-gated match has nothing to
            # rescue): re-match inside the IMU-rotation-predicted disc and
            # re-solve; taken when the ungated solve is catastrophic (inlier
            # floor, or a direction far from the IMU's while the IMU says
            # the camera moved) AND the gated solve wins decisively. Both
            # branches run; the choice is a select. The direction-improvement
            # acceptance channel is GT scale only: GT-free, the IMU would be
            # both the arbiter and the scale source.
            cos_est = torch.dot(t_dir, t_pred_dir)
            dir_trig = (imu_t_norm > fe.fallback_dir_min_norm) & (cos_est < fe.fallback_dir_cos)
            triggered = ((est_inliers < fe.fallback_trigger_inliers) | dir_trig) \
                & (torch.sum(feat.mask) > 0)

            m_g = match_descriptors(kf.desc, kf.mask, feat.desc, feat.mask,
                                    ratio=fe.ratio_thresh, mutual=fe.mutual_check,
                                    uv_pred=predict_uv(uv_i), uv_b=feat.uv,
                                    gate_radius=fe.guided_fallback_px)
            uv_j_g = feat.uv[torch.clamp(m_g.idx_b, 0, Kb - 1).long()]
            rj_g = unit_rays(uv_j_g)
            g_solve_mask = m_g.mask & (kf.level == 0) if fine_only else m_g.mask
            key_g = None if key is None else key._replace(path=(RESCUE_FOLD,))
            est_g = ransac_translation(rays_i, rj_g, R_ji_imu, g_solve_mask, key=key_g,
                                       num_hyps=H_hyp, thresh=be.ransac_thresh, uv_i=uv_i,
                                       dispersion_pow=be.ransac_dispersion_pow,
                                       noise=noise_rescue)
            t_g = resolve_direction_sign(rays_i, rj_g, R_ji_imu, est_g.t_dir,
                                         est_g.inlier_mask)
            cos_g = torch.dot(t_g, t_pred_dir)
            better = est_g.num_inliers > fe.fallback_win_margin * est_inliers
            if not gt_free:
                better = better | (
                    dir_trig & (cos_g > cos_est + 0.15)
                    & (est_g.num_inliers
                       >= torch.clamp((0.7 * est_inliers).to(torch.int32), min=8)))
            take = triggered & better

            def sel(a, b):
                return torch.where(take, a, b)

            m = m._replace(idx_b=sel(m_g.idx_b, m.idx_b), mask=sel(m_g.mask, m.mask))
            uv_j = sel(uv_j_g, uv_j)
            rays_j = sel(rj_g, rays_j)
            t_dir = sel(t_g, t_dir)
            est_inliers = sel(est_g.num_inliers, est_inliers)
            est_inlier_mask = sel(est_g.inlier_mask, est_inlier_mask)
            used_fallback = take
            num_matches = torch.sum(m.mask).to(torch.int32)

        disparity = rotation_compensated_disparity(uv_i, uv_j, m.mask, R_ji, fx, fy, cx, cy)

        # Compose this frame's preintegration onto the keyframe->current factor.
        acc = Preintegrated(
            dR=state.kf_pre_dR, dv=state.kf_pre_dv, dp=state.kf_pre_dp,
            dt=state.kf_time, J_dR_bg=state.kf_pre_J_R_bg, J_dv_bg=state.kf_pre_J_v_bg,
            J_dv_ba=state.kf_pre_J_v_ba, J_dp_bg=state.kf_pre_J_p_bg,
            J_dp_ba=state.kf_pre_J_p_ba,
        )
        pre_acc = compose(acc, pre, dt_b=T)
        pre_acc = pre_acc._replace(dR=lie.orthonormalize(pre_acc.dR))

        # Gyro + accel bias recalibration on quasi-static frames.
        bias_g_new = state.bias_g
        bias_a_new = state.bias_a
        if en.gyro_recalib and not vision:
            w_raw = imu[:, :3]
            a_raw = imu[:, 3:]
            validw = (imu_dt > 0).float()[:, None]
            n = torch.sum(validw)
            nf = torch.clamp(n, min=1.0)
            w_mean = torch.sum(w_raw * validw, 0) / nf
            w_std = torch.sqrt(torch.clamp(
                torch.sum((w_raw - w_mean) ** 2 * validw, 0) / nf, min=0.0))
            a_mean = torch.sum(a_raw * validw, 0) / nf
            a_std = torch.sqrt(torch.clamp(
                torch.sum((a_raw - a_mean) ** 2 * validw, 0) / nf, min=0.0))
            a_dev = torch.abs(torch.linalg.vector_norm(a_mean) - en.gravity)
            still = ((n >= 4.0) & (torch.max(w_std) < en.recalib_gyro_std)
                     & (torch.max(a_std) < en.recalib_accel_std)
                     & (a_dev < en.recalib_accel_dev)
                     & (torch.linalg.vector_norm(w_mean - state.bias_g) < 0.05))
            zero3 = torch.zeros_like(state.bias_g)
            dbg = torch.where(still, en.recalib_alpha * (w_mean - state.bias_g), zero3)
            bias_g_new = state.bias_g + dbg
            dba = zero3
            if en.accel_recalib:
                f_exp = R_wb_j.T @ (-g_w)   # (0,0,+g) in body coords
                ba_target = a_mean - f_exp
                ba_ok = still & (torch.linalg.vector_norm(ba_target - state.bias_a) < 0.5)
                dba = torch.where(ba_ok, en.recalib_accel_alpha * (ba_target - state.bias_a),
                                  zero3)
                bias_a_new = state.bias_a + dba
            pre_acc = bias_correct(pre_acc, dbg, dba)

        # Shadow depth chain: the step length chained through the keyframe's
        # triangulated depths (the GT-free bootstrap's consistently scaled
        # shadow trajectory; maintained in GT-scale mode as well).
        chain = en.vi_align_bootstrap and not vision
        s_shadow = imu_t_norm
        if chain:
            _, d_i_u, d_j_u, gap_u = triangulate_midpoint(rays_i, rays_j, R_ji, t_dir)
            chain_pair_ok = (m.mask & est_inlier_mask & (d_i_u > 1e-3) & (d_j_u > 1e-3)
                             & (gap_u < 0.08 * d_i_u)
                             & torch.isfinite(d_i_u) & torch.isfinite(d_j_u))
            ok_ratio = chain_pair_ok & state.kf_depth_valid
            ratio = state.kf_depths / torch.clamp(d_i_u, min=1e-6)
            s_med = nanmedian(torch.where(ok_ratio, ratio, torch.full_like(ratio, math.nan)))
            s_chain_ok = ((torch.sum(ok_ratio) >= 12) & torch.isfinite(s_med)
                          & (s_med > 1e-4) & (s_med < 1e4))
            s_unseeded = torch.clamp(imu_t_norm, 0.005, 0.5)
            s_fallback = torch.where(state.shadow_scale > 0.0, state.shadow_scale, s_unseeded)
            s_shadow = torch.where(s_chain_ok, s_med, s_fallback)
        # GT or IMU scale; frame-j coords: X_j = R_ji X_i + t_ji
        scale = imu_t_norm if gt_free else gt_t_norm
        t_ji = t_dir * scale
        if en.photometric_refine:
            # Direct refinement of (R_ji, t_ji) after RANSAC: depths of the
            # triangulated inliers, coarse-to-fine alignment of the
            # keyframe's pyramid to this frame's, guarded acceptance; the
            # scale stays pinned and the refined direction is taken.
            _, d_i, d_j, gap = triangulate_midpoint(rays_i, rays_j, R_ji, t_ji)
            pts_ok = (est_inlier_mask & (d_i > be.min_depth) & (d_i < be.max_depth)
                      & (d_j > be.min_depth) & (gap < 0.05 * d_i))
            pres = photometric_align(
                build_pyramid(state.kf_image, fe.num_levels), build_pyramid(image, fe.num_levels),
                uv_i, d_i * rays_i[:, 2], pts_ok, R_ji, t_ji, fx, fy, cx, cy,
                levels=(2, 1, 0), iters_per_level=5)
            drot = torch.linalg.vector_norm(lie.so3_log(pres.R @ R_ji.T))
            den = torch.clamp(scale, min=1e-6) if torch.is_tensor(scale) else max(scale, 1e-6)
            dt_rel = torch.linalg.vector_norm(pres.t - t_ji) / den
            ok_ref = (torch.isfinite(pres.t).all() & torch.isfinite(pres.R).all()
                      & (pres.num_valid >= 30) & (drot < 0.05) & (dt_rel < 0.5))
            R_ji = torch.where(ok_ref, lie.orthonormalize(pres.R), R_ji)
            t_ref_dir = pres.t / torch.clamp(torch.linalg.vector_norm(pres.t), min=1e-9)
            t_ji = torch.where(ok_ref, t_ref_dir * scale, t_ji)

        # ---------------- relative pose -> world pose
        R_cw_i = state.kf_R_wc.T
        t_cw_i = -state.kf_R_wc.T @ state.kf_p_wc
        R_cw_j = R_ji @ R_cw_i
        t_cw_j = R_ji @ t_cw_i + t_ji
        R_wc_j = lie.orthonormalize(R_cw_j.T)
        p_wc_j = -R_cw_j.T @ t_cw_j

        # Solution quality gate against the fine-level keyframe keypoints;
        # a weak frame keeps the IMU pose.
        kf_valid_fine = torch.sum(kf.mask & (kf.level == 0))
        enough = num_matches >= torch.clamp(
            (en.min_feature_ratio * kf_valid_fine).to(torch.int32), min=8)
        solved = enough & (est_inliers >= 8)
        R_wc_j = torch.where(solved, R_wc_j, R_wc_j_imu)
        p_wc_j = torch.where(solved, p_wc_j, state.kf_p_wc + dp_since_kf)

        # ---------------- keyframe policy
        rot_cos = 0.5 * (torch.trace(R_ji) - 1.0)
        is_kf = solved & ((disparity > en.kf_disparity_px) | (rot_cos < kf_rot_thresh))

        # ---------------- state update
        win = state.window
        Wn = win.uv.shape[0]
        full = win.count >= Wn
        slot = torch.clamp(win.count, max=Wn - 1)
        at_slot = torch.arange(Wn, device=self.device) == slot
        R_cw_new = R_wc_j.T
        t_cw_new = -R_wc_j.T @ p_wc_j
        t_since_kf = state.kf_time + T

        # Velocity: vision displacement since the keyframe over the time
        # since it (solved, GT scale), else IMU propagation (GT-free the
        # velocity is the scale source and must not be re-estimated from
        # the IMU-scaled vision); rate-limited and clamped.
        v_imu = state.v_w + g_w * T + (R_wb_prev @ pre.dv)
        if gt_free:
            v_new = v_imu
        else:
            v_vis = (p_wc_j - state.kf_p_wc) / torch.clamp(t_since_kf, min=1e-3)
            v_new = torch.where(solved, v_vis, v_imu)
        dv_max = 20.0 * torch.clamp(T, min=1e-3)
        v_new = state.v_w + torch.clamp(v_new - state.v_w, min=-dv_max, max=dv_max)
        v_new = torch.clamp(v_new, -en.max_velocity, en.max_velocity)

        if vision:
            # The attitude follows the vision pose (the filter has nothing
            # to integrate without an IMU).
            q_wb = torch.where(solved, lie.mat_to_quat(lie.orthonormalize(R_wc_j @ R_bc.T)),
                               q_wb)

        shadow_p_j = state.shadow_kf_p_wc + dp_since_kf
        if chain:
            t_cw_i_sh = -R_cw_i @ state.shadow_kf_p_wc
            t_cw_j_sh = R_ji @ t_cw_i_sh + t_dir * s_shadow
            shadow_p_j = torch.where(solved, -R_cw_j.T @ t_cw_j_sh, shadow_p_j)

        # Promotion: computed every frame, selected by is_kf.
        def roll_if_full(x):
            return torch.where(full, torch.roll(x, -1, dims=0), x)

        def set_slot(x, v):
            sel_ = at_slot.reshape((Wn,) + (1,) * (x.dim() - 1))
            return torch.where(sel_, v.to(x.dtype)[None], x)

        imu_valid_r = roll_if_full(win.imu_valid)
        imu_valid_r = torch.where(full & (torch.arange(Wn, device=self.device) == 0),
                                  torch.zeros_like(imu_valid_r), imu_valid_r)
        promoted = win._replace(
            uv=set_slot(roll_if_full(win.uv), feat.uv),
            desc=set_slot(roll_if_full(win.desc), feat.desc),
            kp_mask=set_slot(roll_if_full(win.kp_mask), feat.mask),
            R_cw=set_slot(roll_if_full(win.R_cw), R_cw_new),
            t_cw=set_slot(roll_if_full(win.t_cw), t_cw_new),
            valid=set_slot(roll_if_full(win.valid), torch.ones((), dtype=torch.bool,
                                                               device=self.device)),
            count=torch.clamp(win.count + 1, max=Wn),
            v_w=set_slot(roll_if_full(win.v_w), v_new),
            imu_dR=set_slot(roll_if_full(win.imu_dR), pre_acc.dR),
            imu_dv=set_slot(roll_if_full(win.imu_dv), pre_acc.dv),
            imu_dp=set_slot(roll_if_full(win.imu_dp), pre_acc.dp),
            imu_dt=set_slot(roll_if_full(win.imu_dt), t_since_kf),
            imu_valid=set_slot(imu_valid_r, (pre.dt > 1e-6) & (slot > 0)),
            imu_J_R_bg=set_slot(roll_if_full(win.imu_J_R_bg), pre_acc.J_dR_bg),
            imu_J_v_bg=set_slot(roll_if_full(win.imu_J_v_bg), pre_acc.J_dv_bg),
            imu_J_v_ba=set_slot(roll_if_full(win.imu_J_v_ba), pre_acc.J_dv_ba),
            imu_J_p_bg=set_slot(roll_if_full(win.imu_J_p_bg), pre_acc.J_dp_bg),
            imu_J_p_ba=set_slot(roll_if_full(win.imu_J_p_ba), pre_acc.J_dp_ba),
            imu_bg_ref=set_slot(roll_if_full(win.imu_bg_ref), bias_g_new),
            imu_ba_ref=set_slot(roll_if_full(win.imu_ba_ref), bias_a_new),
        )
        if chain:
            # Each matched landmark's depth in the promoted keyframe (unit-
            # baseline depth x shadow step), scattered to its new keypoint
            # row; several matches on one row keep the largest.
            tgt = torch.clamp(m.idx_b, 0, Kb - 1).long()
            vals = torch.where(chain_pair_ok, d_j_u * s_shadow, torch.zeros_like(d_j_u))
            depth_p = torch.zeros(Kb, dtype=torch.float32, device=self.device) \
                .scatter_reduce(0, tgt, vals, reduce="amax", include_self=True)
            hits = torch.zeros(Kb, dtype=torch.float32, device=self.device) \
                .scatter_add(0, tgt, chain_pair_ok.float())
            valid_p = (hits > 0) & (depth_p > 1e-6)
            shadow_win_p = set_slot(roll_if_full(state.shadow_win_p), shadow_p_j)
        else:
            depth_p, valid_p, shadow_win_p = (state.kf_depths, state.kf_depth_valid,
                                              state.shadow_win_p)

        def on_kf(a, b):
            return torch.where(is_kf, a, b)

        new_window = type(win)(*[on_kf(a, b) for a, b in zip(promoted, win)])
        new_kf_feat = Features(*[on_kf(a, b) for a, b in zip(feat, kf)])
        eye3 = torch.eye(3, dtype=torch.float32, device=self.device)
        zero33 = torch.zeros((3, 3), dtype=torch.float32, device=self.device)
        zero3 = torch.zeros(3, dtype=torch.float32, device=self.device)
        evict = is_kf & full
        # GT-scale steps are metric by construction: both latches set. GT-free
        # they latch in the alignment; under VI-BA the promotion-count
        # deadline also engages.
        vi_aligned = vi_engaged = torch.ones((), dtype=torch.bool, device=self.device)
        if gt_free:
            vi_aligned, vi_engaged = state.vi_aligned, state.vi_engaged
            if be.vi_factors:
                vi_engaged = vi_engaged | (state.kf_count + is_kf.to(torch.int32)
                                           > be.vi_two_phase_max_kfs)
        new_state = EngineState(
            q_wb=q_wb,
            v_w=v_new,
            bias_g=bias_g_new,
            bias_a=bias_a_new,
            R_wc=R_wc_j,
            p_wc=p_wc_j,
            kf_R_wc=on_kf(R_wc_j, state.kf_R_wc),
            kf_p_wc=on_kf(p_wc_j, state.kf_p_wc),
            kf_feat=new_kf_feat,
            # Read only by the photometric refine: written only with it on.
            kf_image=on_kf(image, state.kf_image) if en.photometric_refine else state.kf_image,
            window=new_window,
            frame_idx=state.frame_idx + 1,
            kf_count=state.kf_count + is_kf.to(torch.int32),
            kf_time=on_kf(torch.zeros_like(t_since_kf), t_since_kf),
            kf_dp_imu=on_kf(zero3, dp_since_kf),
            kf_pre_dR=on_kf(eye3, pre_acc.dR),
            kf_pre_dv=on_kf(zero3, pre_acc.dv),
            kf_pre_dp=on_kf(zero3, pre_acc.dp),
            kf_pre_J_R_bg=on_kf(zero33, pre_acc.J_dR_bg),
            kf_pre_J_v_bg=on_kf(zero33, pre_acc.J_dv_bg),
            kf_pre_J_v_ba=on_kf(zero33, pre_acc.J_dv_ba),
            kf_pre_J_p_bg=on_kf(zero33, pre_acc.J_dp_bg),
            kf_pre_J_p_ba=on_kf(zero33, pre_acc.J_dp_ba),
            # Marginalization-prior handoff on eviction (pending -> active).
            marg_H=torch.where(evict, state.marg_pend_H, state.marg_H),
            marg_R_cw=torch.where(evict, state.marg_pend_R_cw, state.marg_R_cw),
            marg_t_cw=torch.where(evict, state.marg_pend_t_cw, state.marg_t_cw),
            marg_v=torch.where(evict, state.marg_pend_v, state.marg_v),
            marg_pend_H=torch.where(evict, torch.zeros_like(state.marg_pend_H),
                                    state.marg_pend_H),
            marg_pend_R_cw=state.marg_pend_R_cw,
            marg_pend_t_cw=state.marg_pend_t_cw,
            marg_pend_v=state.marg_pend_v,
            vi_aligned=vi_aligned,
            kf_depths=on_kf(depth_p, state.kf_depths),
            kf_depth_valid=on_kf(valid_p, state.kf_depth_valid),
            shadow_win_p=on_kf(shadow_win_p, state.shadow_win_p),
            shadow_p_wc=shadow_p_j,
            shadow_kf_p_wc=on_kf(shadow_p_j, state.shadow_kf_p_wc),
            shadow_scale=torch.where(solved, torch.clamp(s_shadow, 1e-4, 1e4),
                                     state.shadow_scale),
            origin_p_wc=state.origin_p_wc,
            shadow_origin_p=state.shadow_origin_p,
            bootstrap_applies=state.bootstrap_applies,
            # Under VI-BA the promotion-count deadline also engages.
            vi_engaged=vi_engaged,
        )
        if en.vi_align_bootstrap and gt_free and not vision:
            # GT-free supervision on promotion (the reference's cond): the
            # alignment runs on every frame and is kept where it applies.
            # Under VI-BA it stops once the BA is engaged.
            need_align = is_kf & (torch.sum(new_state.window.imu_valid)
                                  >= en.vi_align_min_factors)
            if be.vi_factors:
                need_align = need_align & ~new_state.vi_engaged
            aligned = vi_align_window(new_state, R_bc, en.gravity,
                                      min_factors=en.vi_align_min_factors,
                                      min_excitation=en.vi_align_min_excitation,
                                      engage_min_excitation=en.vi_engage_min_excitation)
            new_state = tree_where(need_align, aligned, new_state)
        if be.refine_in_step:
            # The in-step window (VI-)BA on promotion (every refine_stride-th).
            refine_now = is_kf
            if be.refine_stride > 1:
                refine_now = is_kf & (new_state.kf_count % be.refine_stride == 0)
            refined = refine_window(new_state, cfg, fx, fy, cx, cy, R_bc=R_bc)
            new_state = tree_where(refine_now, refined, new_state)
        result = FrameResult(
            p_wc=new_state.p_wc if be.refine_in_step else p_wc_j,
            R_wc=new_state.R_wc if be.refine_in_step else R_wc_j,
            q_wb=q_wb,
            v_w=new_state.v_w if be.refine_in_step else v_new,
            is_keyframe=is_kf,
            num_matches=num_matches,
            num_inliers=est_inliers,
            disparity=disparity,
            t_dir_cam=t_dir,
            used_fallback=used_fallback,
            t_pred_cam=t_pred_cam,
        )
        return new_state, result
