"""Keyframe-map persistence (port of `vislam_tpu/backend/mapio.py`): the
archive the loop and relocalization paths read, saved by one run and
loaded by a later one. The format is the reference's, so a map written by
either package loads in the other: one compressed .npz of the stacked
per-keyframe arrays and a schema version. Host-side numpy only."""

from __future__ import annotations

from typing import List

import numpy as np

from vislam_tpu_torch.backend.trajectory_opt import KeyframeRecord

_VERSION = 1


def save_map(path: str, keyframes: List[KeyframeRecord]) -> None:
    """Write the keyframe archive to `path` (.npz, compressed)."""
    if not keyframes:
        raise ValueError("empty keyframe archive")
    np.savez_compressed(
        path,
        version=np.int64(_VERSION),
        frame_index=np.asarray([k.frame_index for k in keyframes], np.int64),
        R_wc=np.stack([k.R_wc for k in keyframes]).astype(np.float32),
        p_wc=np.stack([k.p_wc for k in keyframes]).astype(np.float32),
        uv=np.stack([k.uv for k in keyframes]).astype(np.float32),
        desc=np.stack([k.desc for k in keyframes]).astype(np.float32),
        kp_mask=np.stack([k.kp_mask for k in keyframes]).astype(bool),
    )


def load_map(path: str) -> List[KeyframeRecord]:
    """Load a keyframe archive written by save_map (of either package)."""
    with np.load(path) as z:
        v = int(z["version"])
        if v != _VERSION:
            raise ValueError(f"map schema version {v} != {_VERSION}")
        return [KeyframeRecord(frame_index=int(z["frame_index"][i]), R_wc=z["R_wc"][i],
                               p_wc=z["p_wc"][i], uv=z["uv"][i], desc=z["desc"][i],
                               kp_mask=z["kp_mask"][i])
                for i in range(len(z["frame_index"]))]
