"""KITTI odometry dataset reader (port of `vislam_tpu/data/kitti.py`):

  <root>/sequences/<seq>/image_0/%06d.png   (image_2, colour, if absent)
  <root>/sequences/<seq>/times.txt          (seconds per frame)
  <root>/poses/<seq>.txt                    (3x4 GT pose per line, cam0)

KITTI has no IMU in the odometry kit: frame windows carry an empty IMU
block, and the CLI runs it with vision-only rotation. The FrameWindow
interface of EurocDataset.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vislam_tpu_torch.data.euroc import FrameWindow
from vislam_tpu_torch.data.png import read_png_grey
from vislam_tpu_torch.lie import mat_to_quat


class KittiDataset:
    def __init__(self, root: str, sequence: str = "00", imu_window: int = 16):
        self.imu_window = imu_window
        seq_dir = os.path.join(root, "sequences", sequence)
        img_dir = os.path.join(seq_dir, "image_0")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(seq_dir, "image_2")  # colour
        names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
        self.image_paths = [os.path.join(img_dir, n) for n in names]

        times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
        self.image_t_ns = (times * 1e9).astype(np.int64)

        poses_file = os.path.join(root, "poses", f"{sequence}.txt")
        if os.path.exists(poses_file):
            raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
            self.gt_R = raw[:, :, :3]   # cam0 -> world
            self.gt_p = raw[:, :, 3]
        else:
            self.gt_R = None
            self.gt_p = None
        self.start_index = 1

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_image(self, idx: int) -> np.ndarray:
        return read_png_grey(self.image_paths[idx])

    def frame_window(self, j: int) -> FrameWindow:
        S = self.imu_window
        gt_pos = gt_quat = None
        if self.gt_p is not None and j < len(self.gt_p):
            gt_pos = self.gt_p[j].copy()
            # float32, as the reference converts it.
            R = torch.as_tensor(self.gt_R[j], dtype=torch.float32)
            gt_quat = mat_to_quat(R).numpy().astype(np.float64)
        return FrameWindow(
            index=j,
            t_ns=int(self.image_t_ns[j]),
            image=self.load_image(j),
            imu=np.zeros((S, 6), np.float32),
            imu_dt=np.zeros((S,), np.float32),
            imu_count=0,
            gt_pos=gt_pos,
            gt_quat=gt_quat,
            gt_vel=None,
            gt_bias_gyro=None,
            gt_bias_accel=None,
        )
