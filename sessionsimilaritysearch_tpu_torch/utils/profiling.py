"""Profiling helpers (counterpart of
``sessionsimilaritysearch_tpu/utils/profiling.py``): the spans and counters
of the serving path, named phase timers and a ``device_profile`` context.

**Spans.** ``trace(name)`` marks a stretch of the program. While no
``torch.profiler`` records, it costs one flag check and records nothing.
While one records (any ``torch.profiler.profile``, or
:func:`device_profile`), it opens a ``record_function(name)`` range on a
thread the profiler traces, which the Chrome trace shows on the clock of
the device's kernels, and keeps a :class:`Span` in memory: name, parent,
request id, thread and host start and end (``time.perf_counter_ns``). With
``device=`` a CUDA device it also records a pair of timing events on the
current stream, read by :meth:`Span.device_ms` after the caller's
synchronize; no span synchronizes. The outermost span of a thread takes a
new request id and its children inherit it; work handed to another thread
is handed its parent (:func:`current`, :func:`attach`). The program's spans
are named ``sss.<layer>.<stage>``: the engine's verbs ``sss.search``,
``sss.embed``, ``sss.search_embeddings`` and ``sss.insert``; the embedding
loop's ``sss.embed.wait`` (the request waiting on the loader),
``sss.embed.build`` (the loader thread's graph build, in memory only: the
profiler does not trace that thread), ``sss.embed.prepare`` (the keyword
lookup), ``sss.embed.upload`` and ``sss.embed.forward`` (with device
events); the encoder's ``sss.encoder.text`` / ``gnn`` / ``pooling``; the
dense scan's ``sss.index.chunk`` with ``sss.index.score``, ``select`` and
``merge`` inside; the two-stage index's ``sss.index.stage1`` and
``sss.index.rerank``; and ``sss.index.to_host``, the answer's copy back.

:func:`records` holds the latest profiling session's spans only: each
profiler's start ends the list of the one before (torch's
``_run_on_profiler_start`` hook, wrapped at import), and so does a span
that finds the profiler on after it was last seen off. At most
``MAX_RECORDS`` are kept; :func:`dropped` counts the rest. Nothing is
written to disk.

**Counters.** ``count(name, n)`` adds to a process-wide counter, always:
``embed.sessions`` (sessions embedded), ``embed.upload_bytes`` (the host
arrays an embedding batch uploads), ``index.chunks`` and
``index.rows_scanned`` (the chunked scan), ``index.rerank_candidates``
(query x pool rows re-ranked). :func:`counters` reads them;
``counters(profiled=True)`` the part counted while the latest profiling
session recorded. ``SessionSearchEngine.stats()`` reports them.

To record the spans of a run, profile it::

    with device_profile("traces/") as prof:   # or torch.profiler.profile()
        D, I = engine.search(sessions, k=100)
    torch.cuda.synchronize()
    spans = profiling.records()

**PhaseTimer** keeps named host-clock totals; with ``sync`` a phase ends
in ``torch.cuda.synchronize`` and so counts the device work queued inside
it (PyTorch returns before CUDA work finishes, so without it a phase
measures the enqueue). JAX's ``trace`` (a ``jax.profiler.TraceAnnotation``)
becomes the ``record_function`` range; JAX's ``device_profile`` (a
TensorBoard trace) becomes a ``torch.profiler.profile`` that writes a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 1_000_000


class Span:
    """One recorded span. ``parent`` is the enclosing :class:`Span` (on
    this thread, or handed over by :func:`attach`) or None; ``request`` the
    id its outermost span took; ``thread`` the ``threading.get_ident()`` of
    the thread that ran it; ``start_ns`` / ``end_ns`` ``perf_counter_ns``
    (``end_ns`` None while open)."""

    __slots__ = ("name", "parent", "request", "thread", "start_ns", "end_ns", "_events")

    def __init__(self, name: str, parent: Optional["Span"], request: int):
        self.name, self.parent, self.request = name, parent, request
        self.thread = threading.get_ident()
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self._events = None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's device events, or None when it
        recorded none. The device must have passed the end event (call it
        after a synchronize)."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def __repr__(self) -> str:
        return f"Span({self.name!r}, request={self.request}, host_ms={self.host_ms})"


class _Recorder:
    """The process's spans and counters (module-level: spans are opened
    deep inside ops that take no tracer argument, as the ``ops``
    modules' launch counters are kept)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.requests = itertools.count(1)
        self.seen_off = True
        self.spans: List[Span] = []
        self.dropped = 0
        self.counts: Dict[str, int] = defaultdict(int)
        self.profiled: Dict[str, int] = defaultdict(int)

    def session(self) -> None:
        """Called while the profiler records: a fresh list when it was
        last seen off. The caller holds the lock."""
        if self.seen_off:
            self.seen_off = False
            self.spans, self.dropped = [], 0
            self.profiled = defaultdict(int)

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def _ends_the_session(start):
    def on_profiler_start():
        _REC.seen_off = True
        start()

    on_profiler_start.__wrapped__ = start
    return on_profiler_start


_start_hook = getattr(_autograd_profiler, "_run_on_profiler_start", None)
if _start_hook is not None and not hasattr(_start_hook, "__wrapped__"):
    _autograd_profiler._run_on_profiler_start = _ends_the_session(_start_hook)


class _Open:
    """A span while the profiler records (see :func:`trace`)."""

    __slots__ = ("name", "device", "span", "range")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        span = Span(self.name, parent,
                    parent.request if parent is not None else next(_REC.requests))
        with _REC.lock:
            _REC.session()
            if len(_REC.spans) < MAX_RECORDS:
                _REC.spans.append(span)
            else:
                _REC.dropped += 1
        stack.append(span)
        self.span = span
        # only a thread the profiler traces records the range
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            span._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            span._events[0].record(stream)
        return span

    def __exit__(self, *exc):
        span = self.span
        if span._events is not None:
            span._events[1].record(torch.cuda.current_stream(self.device))
        if self.range is not None:
            self.range.__exit__(*exc)
        span.end_ns = time.perf_counter_ns()
        _REC.stack().pop()
        return False


def trace(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` around a ``with`` block (see the module
    docstring). ``device``: the block's device; a CUDA device adds the
    span's device interval. With no profiler recording, a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        _REC.seen_off = True
        return _OFF
    return _Open(name, device)


def current() -> Optional[Span]:
    """The innermost open span of this thread, to hand to another thread
    (:func:`attach`); None when no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    stack = _REC.stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def attach(parent: Optional[Span]):
    """This thread's spans inside the block become children of ``parent``
    (a span of another thread, from :func:`current`), in its request."""
    if parent is None:
        yield
        return
    stack = _REC.stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (and to the profiling session's
    share of it while a profiler records)."""
    with _REC.lock:
        _REC.counts[name] += n
        if _autograd_profiler._is_profiler_enabled:
            _REC.session()
            _REC.profiled[name] += n
        else:
            _REC.seen_off = True


def counters(profiled: bool = False) -> Dict[str, int]:
    """The counters since the process started (or the last :func:`reset`);
    with ``profiled``, what was counted while the latest profiling session
    recorded."""
    with _REC.lock:
        return dict(_REC.profiled if profiled else _REC.counts)


def records() -> List[Span]:
    """The spans of the latest profiling session, in the order they
    opened (a parent before its children)."""
    with _REC.lock:
        return list(_REC.spans)


def dropped() -> int:
    """Spans of the latest profiling session not kept (past
    ``MAX_RECORDS``)."""
    return _REC.dropped


def reset() -> None:
    """Clears the spans and the counters."""
    with _REC.lock:
        _REC.spans, _REC.dropped = [], 0
        _REC.counts = defaultdict(int)
        _REC.profiled = defaultdict(int)


class PhaseTimer:
    """Accumulating named phase timers on ``device``. With ``sync`` (the
    default) each phase ends with ``torch.cuda.synchronize`` on a CUDA
    device, so it counts the device work queued inside it; without, it
    counts host seconds.

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
def device_profile(log_dir: str):
    """Profile the block: CPU activity, and CUDA activity when a card is
    present. On exit the trace is written to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, open it in Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` (``key_averages()`` and the rest);
    the block's spans are in :func:`records` afterwards."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
