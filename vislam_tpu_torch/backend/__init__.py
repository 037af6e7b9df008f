"""Triangulation (port of vislam_tpu.backend.triangulate)."""
