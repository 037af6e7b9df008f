"""TUM RGB-D dataset reader (port of `vislam_tpu/data/tum.py`):

  <root>/rgb.txt            '# ...' then 'timestamp filename' lines
  <root>/groundtruth.txt    'timestamp tx ty tz qx qy qz qw'
  <root>/accelerometer.txt  'timestamp ax ay az' (optional; no gyro)

Frame windows carry accel-only IMU rows (gyro zeros); the colour images
read as grey (`data/png.py`). The FrameWindow interface of EurocDataset.
"""

from __future__ import annotations

import os

import numpy as np

from vislam_tpu_torch.data.euroc import FrameWindow
from vislam_tpu_torch.data.png import read_png_grey


def _read_tum_table(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


class TumDataset:
    def __init__(self, root: str, imu_window: int = 16):
        self.root = root
        self.imu_window = imu_window

        rgb = _read_tum_table(os.path.join(root, "rgb.txt"))
        self.image_t_ns = np.array([int(float(r[0]) * 1e9) for r in rgb], np.int64)
        self.image_paths = [os.path.join(root, r[1]) for r in rgb]

        gt_path = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_path):
            gt = _read_tum_table(gt_path)
            self.gt_t_ns = np.array([int(float(r[0]) * 1e9) for r in gt], np.int64)
            arr = np.array([[float(x) for x in r[1:8]] for r in gt])
            self.gt_p = arr[:, 0:3]
            # TUM order is qx qy qz qw -> [w, x, y, z].
            self.gt_q = np.concatenate([arr[:, 6:7], arr[:, 3:6]], axis=1)
        else:
            self.gt_t_ns = None

        acc_path = os.path.join(root, "accelerometer.txt")
        if os.path.exists(acc_path):
            acc = _read_tum_table(acc_path)
            self.acc_t_ns = np.array([int(float(r[0]) * 1e9) for r in acc], np.int64)
            self.acc = np.array([[float(x) for x in r[1:4]] for r in acc], np.float32)
        else:
            self.acc_t_ns = None
        self.start_index = 1

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_image(self, idx: int) -> np.ndarray:
        return read_png_grey(self.image_paths[idx])

    def _gt_nearest(self, t_ns: int):
        if self.gt_t_ns is None:
            return None, None
        k = int(np.searchsorted(self.gt_t_ns, t_ns))
        k = min(max(k, 0), len(self.gt_t_ns) - 1)
        if k > 0 and abs(int(self.gt_t_ns[k - 1]) - t_ns) < abs(int(self.gt_t_ns[k]) - t_ns):
            k -= 1
        return self.gt_p[k], self.gt_q[k]

    def frame_window(self, j: int) -> FrameWindow:
        t_i = int(self.image_t_ns[j - 1])
        t_j = int(self.image_t_ns[j])
        S = self.imu_window
        imu = np.zeros((S, 6), np.float32)
        imu_dt = np.zeros((S,), np.float32)
        count = 0
        if self.acc_t_ns is not None:
            lo = int(np.searchsorted(self.acc_t_ns, t_i, side="right"))
            hi = int(np.searchsorted(self.acc_t_ns, t_j, side="right"))
            count = min(hi - lo, S)
            if count > 0:
                imu[:count, 3:] = self.acc[lo: lo + count]
                ts = self.acc_t_ns[lo: lo + count].astype(np.float64)
                prev = np.concatenate([[float(t_i)], ts[:-1]])
                imu_dt[:count] = ((ts - prev) * 1e-9).astype(np.float32)
        gt_pos, gt_quat = self._gt_nearest(t_j)
        return FrameWindow(
            index=j, t_ns=t_j, image=self.load_image(j),
            imu=imu, imu_dt=imu_dt, imu_count=count,
            gt_pos=gt_pos, gt_quat=gt_quat, gt_vel=None,
            gt_bias_gyro=None, gt_bias_accel=None,
        )
