"""Background-prefetching frame loader (port of `vislam_tpu/data/loader.py`).

A worker thread reads the next FrameWindows (PNG decode, IMU and GT
slicing) while the main thread steps the current one; zlib's inflate
releases the GIL. With `pin_memory=True` each image is handed over as a
uint8 tensor in page-locked host memory, so the main thread's
`image.to("cuda", non_blocking=True)` queues its copy and returns at once
(the step casts to float32 on the card). Each pinned image is a fresh
block from PyTorch's caching host allocator, which records the copy's
stream on the block and does not hand it out again before that copy has
completed; nothing here reuses a buffer by hand.

`read_seconds` / `frames_read` accumulate the worker's time per frame.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import torch

from vislam_tpu_torch.data.euroc import FrameWindow


class PrefetchLoader:
    """Iterate FrameWindows for frames [start, end) with background prefetch."""

    def __init__(self, dataset, start: Optional[int] = None, end: Optional[int] = None,
                 depth: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.start = dataset.start_index if start is None else max(start, 1)
        self.end = len(dataset) if end is None else min(end, len(dataset))
        self.depth = depth
        self.pin_memory = pin_memory
        self.read_seconds = 0.0
        self.frames_read = 0

    def __len__(self) -> int:
        return max(0, self.end - self.start)

    def _read(self, j: int) -> FrameWindow:
        t0 = time.perf_counter()
        fw = self.dataset.frame_window(j)
        if self.pin_memory:
            fw.image = torch.from_numpy(fw.image).pin_memory()
        self.read_seconds += time.perf_counter() - t0
        self.frames_read += 1
        return fw

    def __iter__(self) -> Iterator[FrameWindow]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for j in range(self.start, self.end):
                    if not put(self._read(j)):
                        return
            except Exception as e:  # surfaced to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
