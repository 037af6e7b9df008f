"""Synthetic sequences (port of vislam_tpu.data.synthetic)."""

from vislam_tpu_torch.data.synthetic import (
    SyntheticConfig,
    make_synthetic_sequence,
    synthetic_calib,
)
