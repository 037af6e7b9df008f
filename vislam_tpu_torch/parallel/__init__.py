"""Distributed paths on torch.distributed (port of `vislam_tpu/parallel/`):
process groups and meshes (`mesh.py`), the landmark-sharded (VI-)BA
(`dist_ba.py`) and sequence-sharded batches (`batch_runner.py`)."""

from vislam_tpu_torch.parallel.dist_ba import (
    dist_bundle_adjust,
    dist_vi_bundle_adjust,
    shard_problem,
)
from vislam_tpu_torch.parallel.mesh import device_count, launch, make_mesh

__all__ = [
    "make_mesh",
    "device_count",
    "launch",
    "dist_bundle_adjust",
    "dist_vi_bundle_adjust",
    "shard_problem",
]
