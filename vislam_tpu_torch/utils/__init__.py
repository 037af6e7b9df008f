"""Configuration, stage timing, checkpoints, state conversion, the random
stream and the debugging switches (port of vislam_tpu.utils)."""

from vislam_tpu_torch.utils.config import (
    BackendConfig,
    EngineConfig,
    FrontendConfig,
    SystemConfig,
)
from vislam_tpu_torch.utils.timing import StageTimer

__all__ = [
    "FrontendConfig",
    "BackendConfig",
    "EngineConfig",
    "SystemConfig",
    "StageTimer",
]
