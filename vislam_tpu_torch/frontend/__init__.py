"""Detection, description, matching, two-view pose (port of vislam_tpu.frontend)."""
