"""The program's own spans and counters in a traced run, for the readers
of the metrics that need them. The program keeps them in memory
(``sessionsimilaritysearch_tpu_torch.utils.profiling``: ``records()``, the
spans of the latest profiling session, and ``counters(profiled=True)``,
what was counted while it recorded); the run's profiler is that session.
A value is a mean over the profiled requests, whose number is the count of
the program's ``sss.search_embeddings`` spans (one a request, as the
driver's ``index`` span is). Every function returns None in an untraced
run, and where the program keeps no such spans or counters."""

from __future__ import annotations

from typing import Iterable, Optional


def _profiling():
    try:
        from sessionsimilaritysearch_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("records", "counters")):
        return None
    return profiling


def _spans(run):
    prof = _profiling() if run.trace is not None else None
    return None if prof is None else prof.records()


def requests(run) -> Optional[int]:
    """The profiled requests: the program's ``sss.search_embeddings``
    spans, or None where there are none."""
    spans = _spans(run)
    n = sum(1 for s in spans if s.name == "sss.search_embeddings") if spans else 0
    return n or None


def host_ms(run, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds a request in the spans named ``names``, summed."""
    n = requests(run)
    if n is None:
        return None
    names = set(names)
    found = [s.host_ms for s in _spans(run) if s.name in names]
    if not found or any(t is None for t in found):
        return None
    return sum(found) / n


def device_ms(run, name: str) -> Optional[float]:
    """Device milliseconds a request between the device events of the
    spans ``name``; None where a span recorded none (a CPU run)."""
    n = requests(run)
    if n is None:
        return None
    found = [s.device_ms() for s in _spans(run) if s.name == name]
    if not found or any(t is None for t in found):
        return None
    return sum(found) / n


def counter(run, name: str) -> Optional[float]:
    """Counter ``name``, counted while the run's profiler recorded, a
    request."""
    n = requests(run)
    if n is None:
        return None
    value = _profiling().counters(profiled=True).get(name)
    return None if value is None else value / n
