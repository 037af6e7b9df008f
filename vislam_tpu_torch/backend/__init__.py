"""Triangulation and the window bundle adjustments (port of vislam_tpu.backend:
triangulate, ba, vi_ba)."""
