"""Engine state (port of `vislam_tpu/engine/state.py`): the same NamedTuples,
field for field, so a reference state converts 1:1 (`utils/convert.py`).
The meaning of each field is documented beside the reference's."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.frontend.features import Features


class KeyframeWindow(NamedTuple):
    """Fixed-size rolling keyframe window (newest at slot count-1 until full;
    then slots roll left on each promotion)."""

    uv: torch.Tensor       # (W, K, 2)
    desc: torch.Tensor     # (W, K, D) (bf16 by default)
    kp_mask: torch.Tensor  # (W, K) bool
    R_cw: torch.Tensor     # (W, 3, 3)
    t_cw: torch.Tensor     # (W, 3)
    valid: torch.Tensor    # (W,) bool
    count: torch.Tensor    # () int32
    v_w: torch.Tensor      # (W, 3)
    imu_dR: torch.Tensor   # (W, 3, 3)
    imu_dv: torch.Tensor   # (W, 3)
    imu_dp: torch.Tensor   # (W, 3)
    imu_dt: torch.Tensor   # (W,)
    imu_valid: torch.Tensor  # (W,) bool
    imu_J_R_bg: torch.Tensor  # (W, 3, 3)
    imu_J_v_bg: torch.Tensor  # (W, 3, 3)
    imu_J_v_ba: torch.Tensor  # (W, 3, 3)
    imu_J_p_bg: torch.Tensor  # (W, 3, 3)
    imu_J_p_ba: torch.Tensor  # (W, 3, 3)
    imu_bg_ref: torch.Tensor  # (W, 3)
    imu_ba_ref: torch.Tensor  # (W, 3)


class EngineState(NamedTuple):
    q_wb: torch.Tensor        # (4,) body orientation
    v_w: torch.Tensor         # (3,)
    bias_g: torch.Tensor      # (3,)
    bias_a: torch.Tensor      # (3,)
    R_wc: torch.Tensor        # (3, 3) camera-to-world
    p_wc: torch.Tensor        # (3,)
    kf_R_wc: torch.Tensor     # (3, 3)
    kf_p_wc: torch.Tensor     # (3,)
    kf_feat: Features
    kf_image: torch.Tensor    # (H, W) f32
    window: KeyframeWindow
    frame_idx: torch.Tensor   # () int32
    kf_count: torch.Tensor    # () int32
    kf_time: torch.Tensor     # () f32
    kf_dp_imu: torch.Tensor   # (3,)
    kf_pre_dR: torch.Tensor   # (3, 3)
    kf_pre_dv: torch.Tensor   # (3,)
    kf_pre_dp: torch.Tensor   # (3,)
    kf_pre_J_R_bg: torch.Tensor  # (3, 3)
    kf_pre_J_v_bg: torch.Tensor  # (3, 3)
    kf_pre_J_v_ba: torch.Tensor  # (3, 3)
    kf_pre_J_p_bg: torch.Tensor  # (3, 3)
    kf_pre_J_p_ba: torch.Tensor  # (3, 3)
    marg_H: torch.Tensor         # (9, 9)
    marg_R_cw: torch.Tensor      # (3, 3)
    marg_t_cw: torch.Tensor      # (3,)
    marg_v: torch.Tensor         # (3,)
    marg_pend_H: torch.Tensor    # (9, 9)
    marg_pend_R_cw: torch.Tensor  # (3, 3)
    marg_pend_t_cw: torch.Tensor  # (3,)
    marg_pend_v: torch.Tensor     # (3,)
    vi_aligned: torch.Tensor      # () bool
    kf_depths: torch.Tensor       # (K,) f32
    kf_depth_valid: torch.Tensor  # (K,) bool
    shadow_win_p: torch.Tensor    # (W, 3)
    shadow_p_wc: torch.Tensor     # (3,)
    shadow_kf_p_wc: torch.Tensor  # (3,)
    shadow_scale: torch.Tensor    # ()
    origin_p_wc: torch.Tensor     # (3,)
    shadow_origin_p: torch.Tensor  # (3,)
    bootstrap_applies: torch.Tensor  # () int32
    vi_engaged: torch.Tensor      # () bool


def tree_where(cond, a, b):
    """torch.where(cond, a, b) over two states of the same structure
    (nested NamedTuples of tensors); a leaf both share is kept as is."""
    if isinstance(a, tuple):
        return type(a)(*[tree_where(cond, x, y) for x, y in zip(a, b)])
    return a if a is b else torch.where(cond, a, b)


def tree_to(tree, device):
    """Every tensor of nested NamedTuples (or a tensor) moved to `device`;
    other leaves as they are."""
    if isinstance(tree, tuple):
        return type(tree)(*[tree_to(x, device) for x in tree])
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def stack_states(states) -> EngineState:
    """Per-sequence states (nested NamedTuples of tensors of one structure)
    -> one state whose every leaf has a leading batch dimension B, the
    input of `engine/batch.py::run_batch_scan`."""
    first = states[0]
    if isinstance(first, tuple):
        return type(first)(*[stack_states(leaves) for leaves in zip(*states)])
    return torch.stack(states)


def unstack_states(state) -> list:
    """A batched state (leading B on every leaf) -> its B per-sequence
    states, each leaf a view of the batched one."""
    if isinstance(state, tuple):
        return [type(state)(*leaves) for leaves in zip(*[unstack_states(x) for x in state])]
    return list(state.unbind(0))


def _eye_stack(W, device):
    return torch.eye(3, dtype=torch.float32, device=device).repeat(W, 1, 1)


def init_window(W: int, K: int, D: int, desc_dtype=torch.float32,
                device=None) -> KeyframeWindow:
    f32 = dict(dtype=torch.float32, device=device)
    z33 = torch.zeros((W, 3, 3), **f32)
    return KeyframeWindow(
        uv=torch.zeros((W, K, 2), **f32),
        desc=torch.zeros((W, K, D), dtype=desc_dtype, device=device),
        kp_mask=torch.zeros((W, K), dtype=torch.bool, device=device),
        R_cw=_eye_stack(W, device),
        t_cw=torch.zeros((W, 3), **f32),
        valid=torch.zeros((W,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        v_w=torch.zeros((W, 3), **f32),
        imu_dR=_eye_stack(W, device),
        imu_dv=torch.zeros((W, 3), **f32),
        imu_dp=torch.zeros((W, 3), **f32),
        imu_dt=torch.zeros((W,), **f32),
        imu_valid=torch.zeros((W,), dtype=torch.bool, device=device),
        imu_J_R_bg=z33.clone(),
        imu_J_v_bg=z33.clone(),
        imu_J_v_ba=z33.clone(),
        imu_J_p_bg=z33.clone(),
        imu_J_p_ba=z33.clone(),
        imu_bg_ref=torch.zeros((W, 3), **f32),
        imu_ba_ref=torch.zeros((W, 3), **f32),
    )


def init_state(feat0: Features, image0, q_wb0, v_w0, p_wc0, R_wc0,
               bias_g=None, bias_a=None, window_size: int = 10,
               desc_dtype=torch.float32) -> EngineState:
    """State at frame 0; feat0 becomes the first keyframe. All tensors live
    on feat0's device; q_wb0, v_w0, p_wc0, R_wc0 are float32 tensors there."""
    dev = feat0.uv.device
    K, D = feat0.desc.shape
    win = init_window(window_size, K, D, desc_dtype=desc_dtype, device=dev)
    R_cw0 = R_wc0.T
    t_cw0 = -R_wc0.T @ p_wc0
    win.uv[0] = feat0.uv
    win.desc[0] = feat0.desc.to(desc_dtype)
    win.kp_mask[0] = feat0.mask
    win.R_cw[0] = R_cw0
    win.t_cw[0] = t_cw0
    win.valid[0] = True
    win.count.fill_(1)
    win.v_w[0] = v_w0
    f32 = dict(dtype=torch.float32, device=dev)
    z3 = torch.zeros(3, **f32)
    eye = torch.eye(3, **f32)
    z33 = torch.zeros((3, 3), **f32)
    shadow_win = torch.zeros((window_size, 3), **f32)
    shadow_win[0] = p_wc0
    return EngineState(
        q_wb=q_wb0.clone(),
        v_w=v_w0.clone(),
        bias_g=z3.clone() if bias_g is None else bias_g.clone(),
        bias_a=z3.clone() if bias_a is None else bias_a.clone(),
        R_wc=R_wc0.clone(),
        p_wc=p_wc0.clone(),
        kf_R_wc=R_wc0.clone(),
        kf_p_wc=p_wc0.clone(),
        kf_feat=feat0,
        kf_image=image0.float(),
        window=win,
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        kf_count=torch.ones((), dtype=torch.int32, device=dev),
        kf_time=torch.zeros((), **f32),
        kf_dp_imu=z3.clone(),
        kf_pre_dR=eye.clone(),
        kf_pre_dv=z3.clone(),
        kf_pre_dp=z3.clone(),
        kf_pre_J_R_bg=z33.clone(),
        kf_pre_J_v_bg=z33.clone(),
        kf_pre_J_v_ba=z33.clone(),
        kf_pre_J_p_bg=z33.clone(),
        kf_pre_J_p_ba=z33.clone(),
        marg_H=torch.zeros((9, 9), **f32),
        marg_R_cw=eye.clone(),
        marg_t_cw=z3.clone(),
        marg_v=z3.clone(),
        marg_pend_H=torch.zeros((9, 9), **f32),
        marg_pend_R_cw=eye.clone(),
        marg_pend_t_cw=z3.clone(),
        marg_pend_v=z3.clone(),
        vi_aligned=torch.zeros((), dtype=torch.bool, device=dev),
        kf_depths=torch.zeros((K,), **f32),
        kf_depth_valid=torch.zeros((K,), dtype=torch.bool, device=dev),
        shadow_win_p=shadow_win,
        shadow_p_wc=p_wc0.clone(),
        shadow_kf_p_wc=p_wc0.clone(),
        shadow_scale=torch.zeros((), **f32),
        origin_p_wc=p_wc0.clone(),
        shadow_origin_p=p_wc0.clone(),
        bootstrap_applies=torch.zeros((), dtype=torch.int32, device=dev),
        vi_engaged=torch.zeros((), dtype=torch.bool, device=dev),
    )
