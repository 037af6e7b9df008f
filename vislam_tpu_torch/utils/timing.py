"""Per-stage timing statistics (port of `vislam_tpu/utils/timing.py`).

Host wall clock per named stage, the running mean printed as the CLI's
stage report. A stage that launches device work and does not wait for it
measures the host's dispatch, not the device: time the device with CUDA
events or torch.profiler.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StageTimer:
    """Accumulates wall-time statistics per named stage."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.count[name]
        return 1000.0 * self.total[name] / c if c else 0.0

    def report(self) -> str:
        """Per-stage mean latency table."""
        lines = ["stage                     mean_ms   calls"]
        for name in sorted(self.total):
            lines.append(f"{name:<24} {self.mean_ms(name):>8.3f} {self.count[name]:>7d}")
        return "\n".join(lines)
