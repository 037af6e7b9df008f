"""EuRoC MAV dataset reader with camera/IMU/ground-truth time sync (port of
`vislam_tpu/data/euroc.py`; host-side numpy, images through `data/png.py`).

Directory scan with filename-stem nanosecond timestamps, comma CSVs with
'#' comments, the start aligned to the first image both the IMU and the GT
streams cover, and per frame the IMU rows between consecutive image
timestamps and the nearest GT row.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from vislam_tpu_torch.data.png import read_png_grey


def _read_csv(path: str) -> np.ndarray:
    """Comma CSV -> float64 array, skipping '#' comment lines."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(";", ",").split(",") if x != ""])
    if not rows:
        raise ValueError(f"no data rows in {path}")
    return np.asarray(rows, dtype=np.float64)


@dataclasses.dataclass
class FrameWindow:
    """Everything the engine consumes for one frame step (i -> j)."""

    index: int
    t_ns: int                      # timestamp of frame j
    image: np.ndarray              # (H, W) uint8 grey (a pinned uint8 tensor
                                   # from PrefetchLoader(pin_memory=True))
    imu: np.ndarray                # (S, 6) float32 [gyro xyz, accel xyz], zero-padded
    imu_dt: np.ndarray             # (S,) float32 integration dt per sample (0 where padded)
    imu_count: int                 # valid rows in imu
    gt_pos: Optional[np.ndarray]   # (3,) float64 or None
    gt_quat: Optional[np.ndarray]  # (4,) [w,x,y,z] or None
    gt_vel: Optional[np.ndarray]   # (3,) or None
    gt_bias_gyro: Optional[np.ndarray]   # (3,) or None (EuRoC GT cols 11-13)
    gt_bias_accel: Optional[np.ndarray]  # (3,) or None (cols 14-16)


class EurocDataset:
    """Reader for the EuRoC MAV directory layout: the sequence root (holding
    mav0/) or mav0 itself. Ground truth is optional."""

    def __init__(self, root: str, imu_window: int = 16):
        if os.path.isdir(os.path.join(root, "mav0")):
            root = os.path.join(root, "mav0")
        self.root = root
        self.imu_window = imu_window

        cam_dir = os.path.join(root, "cam0", "data")
        names = sorted(n for n in os.listdir(cam_dir) if not n.startswith("."))
        if len(names) < 15:
            raise ValueError(f"too few images ({len(names)}) in {cam_dir}")
        self.image_paths = [os.path.join(cam_dir, n) for n in names]
        self.image_t_ns = np.array(
            [int(os.path.splitext(n)[0]) for n in names], dtype=np.int64
        )

        imu_raw = _read_csv(os.path.join(root, "imu0", "data.csv"))
        self.imu_t_ns = imu_raw[:, 0].astype(np.int64)
        self.imu_data = imu_raw[:, 1:7].astype(np.float32)  # gyro(3), accel(3)

        gt_csv = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gt_csv):
            gt_raw = _read_csv(gt_csv)
            self.gt_t_ns = gt_raw[:, 0].astype(np.int64)
            self.gt_data = gt_raw[:, 1:]
        else:
            self.gt_t_ns = None
            self.gt_data = None

        self.start_index = self._align_start()

    def _align_start(self) -> int:
        """First image index covered by both the IMU and the GT streams (at
        least 1: a frame step needs a previous frame)."""
        t0 = self.imu_t_ns[0]
        if self.gt_t_ns is not None:
            t0 = max(t0, self.gt_t_ns[0])
        idx = int(np.searchsorted(self.image_t_ns, t0, side="left"))
        return max(idx, 1)

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_image(self, idx: int) -> np.ndarray:
        return read_png_grey(self.image_paths[idx])

    def _gt_nearest(self, t_ns: int):
        """Nearest GT row by timestamp."""
        if self.gt_t_ns is None:
            return None
        k = int(np.searchsorted(self.gt_t_ns, t_ns))
        if k > 0 and (
            k >= len(self.gt_t_ns)
            or abs(int(self.gt_t_ns[k - 1]) - t_ns) < abs(int(self.gt_t_ns[k]) - t_ns)
        ):
            k -= 1
        return self.gt_data[k]

    def frame_window(self, j: int) -> FrameWindow:
        """The step data for frame j (IMU rows in (t_{j-1}, t_j])."""
        t_i = int(self.image_t_ns[j - 1])
        t_j = int(self.image_t_ns[j])
        lo = int(np.searchsorted(self.imu_t_ns, t_i, side="right"))
        hi = int(np.searchsorted(self.imu_t_ns, t_j, side="right"))
        count = min(hi - lo, self.imu_window)
        S = self.imu_window
        imu = np.zeros((S, 6), np.float32)
        imu_dt = np.zeros((S,), np.float32)
        if count > 0:
            imu[:count] = self.imu_data[lo: lo + count]
            ts = self.imu_t_ns[lo: lo + count].astype(np.float64)
            prev = np.concatenate([[float(t_i)], ts[:-1]])
            imu_dt[:count] = ((ts - prev) * 1e-9).astype(np.float32)

        gt = self._gt_nearest(t_j)
        return FrameWindow(
            index=j,
            t_ns=t_j,
            image=self.load_image(j),
            imu=imu,
            imu_dt=imu_dt,
            imu_count=count,
            gt_pos=None if gt is None else gt[0:3].copy(),
            gt_quat=None if gt is None else gt[3:7].copy(),
            gt_vel=None if gt is None else (gt[7:10].copy() if gt.shape[0] >= 10 else None),
            gt_bias_gyro=None if gt is None or gt.shape[0] < 13 else gt[10:13].copy(),
            gt_bias_accel=None if gt is None or gt.shape[0] < 16 else gt[13:16].copy(),
        )

    def static_imu_prefix(self, max_seconds: float = 2.5) -> Tuple[np.ndarray, np.ndarray]:
        """(gyro, accel) samples of the first `max_seconds`: the bias
        calibration window."""
        t_end = self.imu_t_ns[0] + int(max_seconds * 1e9)
        n = int(np.searchsorted(self.imu_t_ns, t_end))
        return self.imu_data[:n, :3].copy(), self.imu_data[:n, 3:].copy()
