"""The closed-loop driver: one client sends its next request of query
sessions when the last one is answered, through ``engine.search``. A mix
that names ``"driver": "closed"`` in its ``traffic/<mix>.json`` is run by
this module; its parameters:

- ``request_sessions``: sessions a request holds;
- ``k``: neighbours asked for per session;
- ``session_len``: ``[min, max]`` actions per query session;
- ``distinct_sessions``: the pool of query sessions the requests draw from
  (made once in set-up);
- ``warmup_requests``: requests sent before the window, as set-up;
- ``kept_per_request``: answers kept per request for the check, drawn from
  the seed; ``judged_sessions``: how many of the kept ones are checked.

A request's latency runs from its send to its answer. Everything is drawn
from the seed: the same seed gives the same sessions and requests.

A driver module gives ``Mix(params, seed, catalog, max_requests)`` with
``pool`` (the query sessions), ``k``, ``session_ids(r)``, ``keep_rows(r)``,
``warmup(engine, spans)`` and ``window(engine, seconds, spans, first)``,
which returns a :class:`Window`; a driver that sends the same requests
through other verbs of the engine subclasses :class:`Mix` and overrides
``serve``. ``spans(name)`` times a stretch of a request in a span of its
own; ``spans.traced`` says whether the run is traced; ``spans.between()``
is called between requests.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from portbench.traffic.sessions import SessionGenerator


class Window:
    """What a window recorded: per request its number, sessions, latency
    and whether it failed; the kept answers (pool ids, D rows, I rows)."""

    def __init__(self):
        self.requests: List[int] = []
        self.latency_s: List[float] = []
        self.sessions: List[int] = []
        self.failed: List[int] = []
        self.kept_ids: List[np.ndarray] = []
        self.kept_D: List[np.ndarray] = []
        self.kept_I: List[np.ndarray] = []
        self.t0 = self.t1 = 0.0
        self.errors: List[str] = []

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def attempted(self) -> int:
        return int(sum(self.sessions))

    @property
    def n_failed(self) -> int:
        return int(sum(self.failed))


class Mix:
    """The requests of one run: request ``r`` holds the next
    ``request_sessions`` of a seed-drawn order of the pool, cycled."""

    def __init__(self, params: dict, seed: int, catalog: SessionGenerator,
                 max_requests: int):
        self.p = params
        ss = np.random.SeedSequence([seed, 0x7AFF1C])
        rng = np.random.default_rng(ss)
        lo, hi = params["session_len"]
        catalog.rng = np.random.default_rng(ss.spawn(1)[0])
        self.pool = [catalog.session(lo, hi) for _ in range(params["distinct_sessions"])]
        self.k = int(params["k"])
        self.size = int(params["request_sessions"])
        self.max_requests = max_requests
        self._order = rng.permutation(len(self.pool))
        self._keep_rng = np.random.default_rng(ss.spawn(2)[1])

    def session_ids(self, r: int) -> np.ndarray:
        pos = r * self.size + np.arange(self.size)
        return self._order[pos % len(self.pool)]

    def sessions(self, r: int) -> list:
        return [self.pool[i] for i in self.session_ids(r)]

    def keep_rows(self, r: int) -> np.ndarray:
        """The rows of request ``r`` whose answers are kept for the check."""
        return np.sort(self._keep_rng.choice(
            self.size, min(self.size, int(self.p["kept_per_request"])), replace=False))

    def serve(self, engine, sessions: list, spans):
        """One request: ``engine.search`` untraced; traced, its two halves
        in spans of their own, ``embed`` to the device and
        ``search_embeddings`` to host arrays."""
        if not spans.traced:
            return engine.search(sessions, self.k)
        with spans("embed"):
            emb = engine.embed(sessions, out="device")
        with spans("index"):
            return engine.search_embeddings(emb, self.k)

    def warmup(self, engine, spans) -> int:
        """Sends the warm-up requests; returns how many."""
        n = int(self.p["warmup_requests"])
        for r in range(n):
            self.serve(engine, self.sessions(r), spans)
        return n

    def window(self, engine, seconds: float, spans, first: int,
               clock=time.perf_counter) -> Window:
        """Sends requests from ``first`` on until ``seconds`` have passed
        since the window opened. A request that raises counts as failed,
        with all its sessions."""
        w = Window()
        w.t0 = clock()
        r = first
        while clock() - w.t0 < seconds:
            if r >= self.max_requests:
                raise RuntimeError(f"the traffic ran out of requests ({r}) in the window")
            sess = self.sessions(r)
            start = clock()
            try:
                D, I = self.serve(engine, sess, spans)
                ok = True
            except Exception as e:  # a failed request counts, the window goes on
                w.errors.append(f"{type(e).__name__}: {e}")
                ok = False
            w.latency_s.append(clock() - start)
            w.requests.append(r)
            w.sessions.append(len(sess))
            w.failed.append(0 if ok else len(sess))
            if ok:
                rows = self.keep_rows(r)
                w.kept_ids.append(self.session_ids(r)[rows])
                w.kept_D.append(np.asarray(D)[rows])
                w.kept_I.append(np.asarray(I)[rows])
            r += 1
            spans.between()
        w.t1 = clock()
        return w
