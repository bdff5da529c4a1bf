"""Named phase timers that wait for the device before stopping the clock
(counterpart of ``sessionsimilaritysearch_tpu/utils/profiling.py:20``
``PhaseTimer``). PyTorch returns before CUDA work finishes, so a timer
that does not synchronize measures the enqueue."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulating named phase timers; on a CUDA device each phase ends
    with ``torch.cuda.synchronize``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }
