"""Offline sequence processing (port of `vislam_tpu/engine/batch.py`): the
step looped over a sequence staged on the device.

The reference runs the frame loop as one lax.scan; here it is a Python loop
over frames whose inputs already live on the device, with the GT-scale
bookkeeping (distance since the last keyframe) carried on the device too,
so no frame waits on the host. GT-free sequences (use_gt_scale False) run
every frame on the IMU scale (the reference's gt_norm = -1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vislam_tpu_torch.engine.engine import (
    FrameResult,
    VIOEngine,
    frame_generator,
    require_device,
)
from vislam_tpu_torch.engine.state import EngineState


class SequenceInputs(NamedTuple):
    """Per-frame inputs staged on the device; leading dim N = frames."""

    images: torch.Tensor   # (N, H, W) float32
    imu: torch.Tensor      # (N, S, 6)
    imu_dt: torch.Tensor   # (N, S)
    gt_pos: torch.Tensor   # (N, 3) (zeros if unused)
    use_gt_scale: bool     # host flag


def make_sequence_inputs(seq: dict, start: int = 1, end: Optional[int] = None,
                         imu_window: int = 16, use_gt_scale: bool = True,
                         imu_rate: float = 200.0, cam_rate: float = 20.0,
                         *, device="cuda") -> SequenceInputs:
    """Stage a synthetic-generator dict (`data/synthetic.py`) on `device`
    (the card unless the caller asks for another)."""
    device = require_device(device)
    end = len(seq["images"]) if end is None else end
    spf = int(round(imu_rate / cam_rate))
    N = end - start
    imu = np.zeros((N, imu_window, 6), np.float32)
    dt = np.zeros((N, imu_window), np.float32)
    for n, j in enumerate(range(start, end)):
        lo, hi = (j - 1) * spf, j * spf
        imu[n, :spf] = np.concatenate(
            [seq["imu_gyro"][lo:hi], seq["imu_accel"][lo:hi]], -1
        )
        dt[n, :spf] = 1.0 / imu_rate

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    return SequenceInputs(
        images=dev(seq["images"][start:end]),
        imu=dev(imu),
        imu_dt=dev(dt),
        gt_pos=dev(seq["gt_pos"][start:end]),
        use_gt_scale=bool(use_gt_scale),
    )


def run_sequence_scan(eng: VIOEngine, state0: EngineState, inputs: SequenceInputs,
                      kf_gt_pos0=None, seed: int = 0, noises=None):
    """Run the step over every frame of `inputs`.

    Returns (final_state, FrameResult with leading dim N). Frame n draws its
    RANSAC hypotheses from `frame_generator(seed, n)`, or takes
    noises[n] = (noise, noise_rescue) when given.
    """
    state = state0
    kf_gt_pos = state0.p_wc.clone() if kf_gt_pos0 is None else \
        torch.as_tensor(kf_gt_pos0, dtype=torch.float32).to(eng.device)
    results = []
    for n in range(inputs.images.shape[0]):
        gt_p = inputs.gt_pos[n]
        gt_norm = torch.linalg.vector_norm(gt_p - kf_gt_pos) if inputs.use_gt_scale else -1.0
        noise, noise_rescue = (None, None) if noises is None else noises[n]
        state, res = eng._step(state, inputs.images[n], inputs.imu[n], inputs.imu_dt[n],
                               gt_norm, frame_generator(seed, n, eng.device),
                               noise, noise_rescue)
        kf_gt_pos = torch.where(res.is_keyframe, gt_p, kf_gt_pos)
        results.append(res)
    return state, FrameResult(*[torch.stack(f) for f in zip(*results)])
