"""Camera model (port of vislam_tpu.calib)."""
