"""Profiling helpers (counterpart of
``sessionsimilaritysearch_tpu/utils/profiling.py``): named phase timers that
wait for the device before stopping the clock, ``trace`` spans and a
``device_profile`` context.

PyTorch returns before CUDA work finishes, so a timer that does not
synchronize measures the enqueue. JAX's ``trace`` (a
``jax.profiler.TraceAnnotation``) becomes ``torch.profiler.record_function``,
which a ``torch.profiler`` trace shows as a span with the device time of
the kernels launched inside it; JAX's ``device_profile`` (a TensorBoard
trace) becomes a ``torch.profiler.profile`` that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulating named phase timers on ``device``. With ``sync`` (the
    default) each phase ends with ``torch.cuda.synchronize`` on a CUDA
    device, so it counts the device work queued inside it.

    >>> timer = PhaseTimer(device)
    >>> with timer("embed"): emb = encode(batch)
    >>> emb = timer.timed("embed", encode, batch)
    >>> timer.summary()
    """

    def __init__(self, device: torch.device, sync: bool = True):
        self.device = torch.device(device)
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _wait(self) -> None:
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._wait()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kw):
        """Run ``fn(*args, **kw)``, wait for the device (with ``sync``),
        record the wall time under ``name`` and return ``fn``'s output."""
        with self(name):
            return fn(*args, **kw)

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }


@contextlib.contextmanager
def trace(name: str):
    """A named span in a ``torch.profiler`` trace
    (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Profile the block: CPU activity, and CUDA activity when a card is
    present. On exit the trace is written to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, open it in Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` (``key_averages()`` and the rest)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
