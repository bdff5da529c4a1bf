"""What a traced run reads from ``torch.profiler``: the device's kernels,
copies and sets with their times, the benchmark's own spans
(``record_function`` names starting with ``portbench.``), and the host's
operations, all from the profiler's Chrome trace on one clock."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


def export_events(prof) -> list:
    """The profiler's trace events, through a Chrome trace written to the
    run's temporary directory and removed."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """Times are seconds on the profiler's clock. ``window`` is the span
    from the first benchmark span's start to the last one's end."""

    def __init__(self, events: Sequence[dict]):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6, e["name"])
                             for e in x if e.get("cat") in DEVICE_CATS)
        self.spans = sorted((float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6,
                             e["name"][len(SPAN_PREFIX):])
                            for e in x if e.get("cat") == "user_annotation"
                            and e["name"].startswith(SPAN_PREFIX))
        self.host_ops = sorted((float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6, e["name"])
                               for e in x if e.get("cat") == "cpu_op")
        if self.spans:
            self.t0 = self.spans[0][0]
            self.t1 = max(s + d for s, d, _ in self.spans)
        else:
            self.t0 = self.t1 = 0.0
        self._span_starts = [s for s, _, _ in self.spans]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_of(self, t: float) -> Optional[str]:
        """The benchmark span that holds time ``t``, or None."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        if i >= 0:
            s, d, name = self.spans[i]
            if t <= s + d:
                return name
        return None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _merge((max(s, self.t0), min(s + d, self.t1)) for s, d, _ in self.device
                      if s + d > self.t0 and s < self.t1)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_time(self, patterns: Optional[Sequence[str]] = None,
                    span: Optional[str] = None, exclude: Sequence[str] = ()) -> float:
        """Summed device time of the operations whose name holds one of
        ``patterns`` (all when None) and none of ``exclude``, run inside
        benchmark span ``span`` (any when None) and inside the window."""
        total = 0.0
        for s, d, name in self.device:
            if s + d <= self.t0 or s >= self.t1:
                continue
            if patterns is not None and not any(p in name for p in patterns):
                continue
            if any(p in name for p in exclude):
                continue
            if span is not None and self.span_of(s + 0.5 * d) != span:
                continue
            total += d
        return total

    def count(self, span: str) -> int:
        return sum(1 for _, _, name in self.spans if name == span)

    def top_device_ops(self, n: int = 10) -> list:
        acc = defaultdict(float)
        for s, d, name in self.device:
            if self.t0 <= s < self.t1:
                acc[name] += d
        return [[name[:160], t] for name, t in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time in the window, summed by what the host was doing
        in the middle of each gap: ``<span>: <host operation>``."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        starts = [s for s, _, _ in self.host_ops]
        acc = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            op = "host code outside operators"
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost operator running at ``mid``: the latest start
            # among those that cover it, within a short look back
            for j in range(i, max(i - 64, -1), -1):
                s, d, name = self.host_ops[j]
                if s <= mid <= s + d:
                    op = name
                    break
            acc[f"{self.span_of(mid) or 'between spans'}: {op}"] += b - a
        return [[k[:160], v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
