"""Offline sequence processing (port of `vislam_tpu/engine/batch.py`): the
step looped over a sequence staged on the device (a synthetic sequence, or a
dataset's frames through `stage_dataset`), and over B sequences stepped
together.

The reference runs the frame loop as one lax.scan; here it is a Python loop
over frames whose inputs already live on the device, with the GT-scale
bookkeeping (distance since the last keyframe) carried on the device too,
so no frame waits on the host. GT-free sequences (use_gt_scale False) run
every frame on the IMU scale (the reference's gt_norm = -1).

`run_batch_scan` is the multi-sequence throughput mode: each frame is one
`torch.func.vmap` call of the step over the B sequences, so every launch
of the step serves the whole batch; the kernels' custom ops fold the
mapped dimension into their own batch (`ops/*_kernel.py`), the draws'
too: one launch draws every sequence's hypotheses.

Keys are the reference's: a sequence run with `seed` keys frame n with
fold_in(PRNGKey(seed), n) (its scan's fold_in(base_key, idx)), and entry b
of a batch run with `seed` takes the base key split(PRNGKey(seed), B)[b]
(`sequence_key`), so entry b equals `run_sequence_scan(..., key=
sequence_key(seed, b))`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vislam_tpu_torch.engine.engine import (
    FrameKey,
    FrameResult,
    VIOEngine,
    require_device,
)
from vislam_tpu_torch.engine.state import EngineState
from vislam_tpu_torch.utils import prng


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


def stage_dataset(dataset, start: int, end: int, imu_window: int = 16,
                  use_gt_scale: bool = True, undistort=None, *,
                  device="cuda") -> SequenceInputs:
    """Stage a dataset reader's frames [start, end) on `device` (port of
    the reference's `stage_dataset`): any reader with `frame_window(j)`
    (EuRoC, KITTI, TUM). Each image goes up as uint8 and is cast there;
    `undistort` (uint8 image -> float32 image on the device) remaps it.
    GT scale needs GT on every frame; else the inputs are GT-free."""
    device = require_device(device)
    images, imu, imu_dt, gt_pos = [], [], [], []
    have_gt = True
    for j in range(start, end):
        fw = dataset.frame_window(j)
        img = torch.as_tensor(fw.image).to(device)
        images.append(undistort(img) if undistort is not None else img.to(torch.float32))
        imu.append(fw.imu)
        imu_dt.append(fw.imu_dt)
        if fw.gt_pos is None:
            have_gt = False
            gt_pos.append(np.zeros(3, np.float32))
        else:
            gt_pos.append(np.asarray(fw.gt_pos, np.float32))

    def dev(x):
        return torch.from_numpy(np.stack(x)).to(device)

    return SequenceInputs(
        images=torch.stack(images),
        imu=dev(imu),
        imu_dt=dev(imu_dt),
        gt_pos=dev(gt_pos),
        use_gt_scale=bool(use_gt_scale and have_gt),
    )


def run_sequence_scan(eng: VIOEngine, state0: EngineState, inputs: SequenceInputs,
                      kf_gt_pos0=None, seed: int = 0, noises=None, key=None):
    """Run the step over every frame of `inputs`.

    Returns (final_state, FrameResult with leading dim N). Frame n draws its
    RANSAC hypotheses under fold_in(base, n), base the key `key` ((2,)
    uint32, e.g. `sequence_key`) or PRNGKey(seed) (the reference's scan), or
    takes noises[n] = (noise, noise_rescue) when given. The base key and
    the frame indices go to the device once, before the frames.
    """
    state = state0
    kf_gt_pos = state0.p_wc.clone() if kf_gt_pos0 is None else \
        torch.as_tensor(kf_gt_pos0, dtype=torch.float32).to(eng.device)
    N = inputs.images.shape[0]
    base = prng.key_tensor(prng.prng_key(seed) if key is None else key, eng.device)
    index = torch.arange(N, dtype=torch.int32, device=eng.device)
    results = []
    for n in range(N):
        gt_p = inputs.gt_pos[n]
        gt_norm = torch.linalg.vector_norm(gt_p - kf_gt_pos) if inputs.use_gt_scale else -1.0
        noise, noise_rescue = (None, None) if noises is None else noises[n]
        state, res = eng._step(state, inputs.images[n], inputs.imu[n], inputs.imu_dt[n],
                               gt_norm, FrameKey(base, index[n]), noise, noise_rescue)
        kf_gt_pos = torch.where(res.is_keyframe, gt_p, kf_gt_pos)
        results.append(res)
    return state, FrameResult(*[torch.stack(f) for f in zip(*results)])


def make_batch_inputs(inputs: Sequence[SequenceInputs]) -> SequenceInputs:
    """B sequences' staged inputs of one length -> one SequenceInputs with
    leading dims (B, N); use_gt_scale, a host flag, is shared by the batch
    (as in the reference's run_batch_scan)."""
    flags = {i.use_gt_scale for i in inputs}
    if len(flags) != 1:
        raise ValueError("the sequences of a batch share use_gt_scale")
    return SequenceInputs(*[torch.stack(f) for f in zip(*[i[:4] for i in inputs])],
                          use_gt_scale=flags.pop())


def batch_keys(seed: int, B: int, offset: int = 0) -> np.ndarray:
    """The base keys (B, 2) uint32 of entries offset .. offset + B - 1 of a
    batch run with `seed`: the reference's split(PRNGKey(seed), total)
    rows, which do not depend on the batch's size (partitionable mode)."""
    return prng.split(prng.prng_key(seed), offset + B)[offset:]


def sequence_key(seed: int, b: int) -> np.ndarray:
    """The base key (2,) uint32 of entry b of a batch run with `seed` (the
    reference's split(PRNGKey(seed), B)[b]): entry b of run_batch_scan
    equals run_sequence_scan(..., key=sequence_key(seed, b))."""
    return batch_keys(seed, 1, b)[0]


def run_batch_scan(eng: VIOEngine, states0: EngineState, inputs_batch: SequenceInputs,
                   kf_gt_pos0, seed: int = 0, noises=None, offset: int = 0):
    """Run the step over B sequences together (port of the reference's
    `run_batch_scan`, `vislam_tpu/engine/batch.py:139-161`).

    states0: an EngineState with a leading B on every leaf
    (`engine/state.py::stack_states`); inputs_batch: (B, N, ...) inputs
    (`make_batch_inputs`), use_gt_scale shared; kf_gt_pos0: (B, 3), each
    sequence's GT position at its first keyframe. Each frame is ONE
    torch.func.vmap call of the step over the batch: GT scale with a
    batched distance since each sequence's last keyframe (kept on the
    device), GT-free with the host float -1.0 for every sequence.

    Sequence b draws frame n's hypotheses under fold_in(sequence_key(seed,
    offset + b), n), so entry b equals run_sequence_scan(...,
    key=sequence_key(seed, offset + b)); offset is entry 0's index in a
    larger batch (`parallel/batch_runner.py` runs a slice of one). Each
    frame's draws of the whole batch are one launch (the draw op's vmap
    rule). `noises[b][n] = (noise, noise_rescue)` overrides them (stacked
    once, before the frames; with vision-only rotation noise is (H, 8, M)
    and noise_rescue None).
    Returns (final state (B, ...), FrameResult (B, N, ...)).
    """
    B, N = inputs_batch.images.shape[:2]
    kf_gt_pos = torch.as_tensor(kf_gt_pos0, dtype=torch.float32).to(eng.device)
    rescue = not eng.cfg.engine.vision_rotation
    drawn = noises is None
    if drawn:
        base = prng.key_tensor(batch_keys(seed, B, offset), eng.device)
        index = torch.arange(N, dtype=torch.int32, device=eng.device)
        given = [[None] * N, [None] * N]
    else:
        given = [torch.stack([torch.stack([nz[j] for nz in row]) for row in noises], 1)
                 if j == 0 or rescue else [None] * N
                 for j in (0, 1)]          # (N, B, ...) each
    gt_scale = inputs_batch.use_gt_scale

    def step(state, image, imu, imu_dt, gt_norm, base, index, noise, noise_rescue):
        key = FrameKey(base, index) if drawn else None
        return eng._step(state, image, imu, imu_dt, gt_norm if gt_scale else -1.0, key,
                         noise, noise_rescue)

    batched = torch.func.vmap(step, in_dims=(0, 0, 0, 0, 0 if gt_scale else None,
                                             0 if drawn else None, None,
                                             None if drawn else 0,
                                             0 if rescue and not drawn else None))
    state, results = states0, []
    for n in range(N):
        gt_p = inputs_batch.gt_pos[:, n]
        gt_norm = torch.linalg.vector_norm(gt_p - kf_gt_pos, dim=-1) if gt_scale else None
        state, res = batched(state, inputs_batch.images[:, n], inputs_batch.imu[:, n],
                             inputs_batch.imu_dt[:, n], gt_norm,
                             base if drawn else None, index[n] if drawn else None,
                             given[0][n], given[1][n])
        kf_gt_pos = torch.where(res.is_keyframe[:, None], gt_p, kf_gt_pos)
        results.append(res)
    return state, FrameResult(*[torch.stack(f, 1) for f in zip(*results)])
