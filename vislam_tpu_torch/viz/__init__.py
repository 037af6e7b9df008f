"""Offline plots and live trajectory snapshots (port of `vislam_tpu/viz`).
matplotlib is imported only when a figure is drawn."""

from vislam_tpu_torch.viz.live import LiveViz
from vislam_tpu_torch.viz.plots import draw_matches, plot_state_comparison, plot_trajectory

__all__ = ["plot_trajectory", "plot_state_comparison", "draw_matches", "LiveViz"]
