"""Dataset readers, the PNG codec, the prefetching loader, synthetic
sequences and adversarial imagery (port of vislam_tpu.data)."""

from vislam_tpu_torch.data.adversarial import (
    AdversarialConfig,
    AdversarialScene,
    make_adversarial_sequence,
    presets,
)
from vislam_tpu_torch.data.euroc import EurocDataset, FrameWindow
from vislam_tpu_torch.data.kitti import KittiDataset
from vislam_tpu_torch.data.loader import PrefetchLoader
from vislam_tpu_torch.data.synthetic import (
    SyntheticConfig,
    make_synthetic_sequence,
    synthetic_calib,
    write_euroc_fixture,
)
from vislam_tpu_torch.data.tum import TumDataset

__all__ = [
    "EurocDataset",
    "KittiDataset",
    "TumDataset",
    "FrameWindow",
    "PrefetchLoader",
    "SyntheticConfig",
    "make_synthetic_sequence",
    "write_euroc_fixture",
    "synthetic_calib",
    "AdversarialConfig",
    "AdversarialScene",
    "make_adversarial_sequence",
    "presets",
]
