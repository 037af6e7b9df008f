"""Trajectory metrics, files and smoothing (port of vislam_tpu.eval)."""

from vislam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
from vislam_tpu_torch.eval.smooth import smooth_bootstrap_prefix
from vislam_tpu_torch.eval.traj_io import (
    read_trajectory_csv,
    read_trajectory_tum,
    write_trajectory_csv,
    write_trajectory_tum,
)
