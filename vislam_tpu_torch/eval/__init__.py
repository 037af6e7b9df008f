"""Trajectory metrics (port of vislam_tpu.eval.metrics)."""

from vislam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
