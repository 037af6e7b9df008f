"""The device trace of a traced window (torch.profiler, CUDA activity) and
what the per-layer readers take from it: every device operation's name,
start and duration (kernels, copies and fills), the union of their
intervals (the device's busy time), the kernels among them, and the
traced window's length on the host clock."""

from __future__ import annotations

import time
from typing import NamedTuple


class Kernel(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


COPIES = ("Memcpy", "Memset")


class Trace(NamedTuple):
    ops: list               # [Kernel]: every device operation, in start order
    window_s: float         # host clock, synchronised at both ends
    steps: int              # batched steps run inside it

    @property
    def kernels(self) -> list:
        """The operations that are kernels (one per launch): not copies or fills."""
        return [k for k in self.ops if not k.name.startswith(COPIES)]

    @property
    def busy_s(self) -> float:
        """The union of the operations' intervals: time in which the device worked."""
        busy, end = 0, None
        for k in self.ops:
            s, e = k.start_ns, k.start_ns + k.dur_ns
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def device_s(self, match) -> float:
        """Summed durations of the kernels whose name `match` accepts."""
        return sum(k.dur_ns for k in self.kernels if match(k.name)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the n operations with the most time."""
        tot: dict = {}
        for k in self.ops:
            tot[k.name] = tot.get(k.name, 0) + k.dur_ns
        return [[name[:160], ns * 1e-9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[what lay on either side, seconds] of the n longest gaps in which no
        operation ran (the host was issuing what came after)."""
        gaps, end, prev = [], None, None
        for k in self.ops:
            if end is not None and k.start_ns > end:
                gaps.append([f"after {prev[:70]} / before {k.name[:70]}", (k.start_ns - end) * 1e-9])
            if end is None or k.start_ns + k.dur_ns > end:
                end, prev = k.start_ns + k.dur_ns, k.name
        return sorted(gaps, key=lambda g: -g[1])[:n]


def traced(run, steps: int) -> Trace:
    """Run `run()` (which enqueues `steps` batched steps) under the profiler,
    synchronised before and after, and keep its device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = [(str(e.activity_type()).lower() if hasattr(e, "activity_type") else "",
               Kernel(e.name(), e.start_ns(), e.duration_ns()))
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    # Kernels, copies and fills; where the events carry activity types, the
    # device's annotations of host ranges (record_function) are left out.
    typed = any("kernel" in kind for kind, _ in events)
    ops = sorted((k for kind, k in events
                  if not typed or any(t in kind for t in ("kernel", "memcpy", "memset"))),
                 key=lambda k: k.start_ns)
    return Trace(ops, window, steps)
