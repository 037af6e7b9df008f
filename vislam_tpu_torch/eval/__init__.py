"""Trajectory metrics, files, smoothing and the VIO runner (port of
vislam_tpu.eval; `eval.matchability` is imported on its own)."""

from vislam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse, umeyama_alignment
from vislam_tpu_torch.eval.runner import run_vio_sequence
from vislam_tpu_torch.eval.smooth import smooth_bootstrap_prefix
from vislam_tpu_torch.eval.traj_io import (
    read_trajectory_csv,
    read_trajectory_tum,
    write_trajectory_csv,
    write_trajectory_tum,
)

__all__ = [
    "ate_rmse",
    "rpe_rmse",
    "umeyama_alignment",
    "write_trajectory_csv",
    "read_trajectory_csv",
    "write_trajectory_tum",
    "read_trajectory_tum",
    "run_vio_sequence",
    "smooth_bootstrap_prefix",
]
