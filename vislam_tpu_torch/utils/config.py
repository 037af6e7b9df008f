"""Typed system configuration — field for field the reference's
`vislam_tpu/utils/config.py`, same names, same defaults (a test holds
`dataclasses.asdict` of both equal). The rationale for each default lives
beside the reference's fields; only what the port adds is said here.

Shape-determining fields are static Python ints.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Detection / description / matching configuration."""

    # shi_tomasi | harris | dog | hessian | fast
    detector: str = "shi_tomasi"
    image_dtype: str = "bfloat16"   # pyramid dtype; the response runs in f32
    scale_space: str = "gaussian"   # gaussian | nonlinear (KAZE/AKAZE)
    num_levels: int = 4
    levels_used: int = 2            # K = 512 (level 0) + 256 (level 1) = 768
    grid_rows: int = 8
    grid_cols: int = 8
    kp_per_cell: int = 8
    kp_per_cell_coarse: int = 4
    nms_radius: int = 2
    harris_k: float = 0.04
    min_score: float = 0.02
    descriptor: str = "sift"        # sift | brief
    patch_size: int = 16
    oriented: bool = False
    ratio_thresh: float = 0.8
    mutual_check: bool = True
    # Kernel switches of the reference. The port's kernels are chosen by the
    # tensor's device instead (CUDA tensor -> kernel), so these are carried
    # for config parity only.
    use_pallas_matcher: bool = False
    use_pallas_detector: bool = True
    guided_gate_px: float = 0.0
    guided_fallback_px: float = 60.0
    fallback_trigger_inliers: int = 12
    fallback_win_margin: float = 1.5
    fallback_dir_cos: float = 0.4
    fallback_dir_min_norm: float = 0.03
    max_matches: int = 512
    match_cell_rows: int = 7
    match_cell_cols: int = 7
    solver_fine_only: bool = True

    @property
    def kp_per_cell_by_level(self):
        """Per-level per-cell budgets: full at level 0, coarse above."""
        return tuple(
            self.kp_per_cell if lvl == 0 else self.kp_per_cell_coarse
            for lvl in range(self.levels_used)
        )

    @property
    def max_keypoints(self) -> int:
        cells = self.grid_rows * self.grid_cols
        return cells * sum(self.kp_per_cell_by_level)

    @property
    def desc_dim(self) -> int:
        return 256 if self.descriptor == "brief" else 128


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Two-view solver + sliding-window BA configuration."""

    ransac_hyps: int = 512
    ransac_thresh: float = 0.02
    ransac_dispersion_pow: float = 1.25
    window_size: int = 10
    window_desc_dtype: str = "bfloat16"
    max_landmarks: int = 512
    lm_iters: int = 12
    lm_lambda0: float = 1e-3
    max_anchor_trans: float = 0.10
    max_anchor_rot: float = 0.035
    online_gauge: str = "ends"
    marg_discount: float = 0.5
    marg_max_trace: float = 1e6
    vi_factors: bool = False
    refine_in_step: bool = False
    refine_stride: int = 1
    vi_two_phase_max_kfs: int = 20
    vi_w_rot: float = 1e4
    vi_w_vel: float = 1e2
    vi_w_pos: float = 1e2
    max_anchor_vel: float = 0.5
    estimate_bias: bool = True
    vi_w_bg_prior: float = 1e4
    vi_w_ba_prior: float = 3e3
    max_bias_g_step: float = 0.005
    max_bias_a_step: float = 0.05
    bias_min_factors: int = 4
    bias_g_deadband: float = 0.0015
    bias_a_deadband: float = 0.015
    huber_delta: float = 2.0
    reproj_gate: float = 8.0
    reproj_gate_mad: float = 3.0
    tri_gap_rel: float = 0.05
    min_depth: float = 0.05
    max_depth: float = 200.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Keyframe policy + engine behavior."""

    kf_disparity_px: float = 22.0
    kf_rotation_deg: float = 5.0
    min_feature_ratio: float = 0.35
    use_gt_scale: bool = True
    vision_rotation: bool = False
    photometric_refine: bool = False
    imu_window: int = 16
    gravity: float = 9.81
    max_velocity: float = 30.0
    gyro_recalib: bool = True
    recalib_gyro_std: float = 0.01
    recalib_accel_std: float = 0.10
    recalib_accel_dev: float = 0.30
    recalib_alpha: float = 0.10
    accel_recalib: bool = True
    recalib_accel_alpha: float = 0.05
    vi_align_bootstrap: bool = True
    vi_align_min_factors: int = 4
    vi_align_min_excitation: float = 0.5
    vi_engage_min_excitation: float = 1.5


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    image_height: int = 480
    image_width: int = 768
    dtype: str = "float32"
