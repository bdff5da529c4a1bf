"""The closed-loop driver on a fake engine: the same seed gives the same
requests, requests go back to back, a failed request counts with all its
sessions, and a traced run marks each request's two halves."""

import contextlib
import time

import numpy as np
import pytest

from portbench.traffic.closed import Mix
from portbench.traffic.sessions import SessionGenerator

PARAMS = {"driver": "closed", "request_sessions": 8, "k": 3, "session_len": [1, 20],
          "distinct_sessions": 50, "warmup_requests": 1, "kept_per_request": 2,
          "judged_sessions": 10}


def _mix(seed, **kw):
    return Mix(dict(PARAMS, **kw), seed, SessionGenerator(300, seed=1), 2000)


def _answer(n, k):
    return np.zeros((n, k), np.float32), np.tile(np.arange(k), (n, 1))


class Engine:
    def __init__(self, delay=0.002, refuse=()):
        self.delay, self.refuse, self.calls = delay, set(refuse), []

    def search(self, sessions, k):
        self.calls.append("search")
        time.sleep(self.delay)
        if len(self.calls) in self.refuse:
            raise RuntimeError("refused")
        return _answer(len(sessions), k)

    def embed(self, sessions, out):
        self.calls.append("embed")
        return len(sessions)

    def search_embeddings(self, n, k):
        self.calls.append("search_embeddings")
        return _answer(n, k)


class Spans:
    def __init__(self, traced=False):
        self.traced, self.names, self.betweens = traced, [], 0

    @contextlib.contextmanager
    def __call__(self, name):
        self.names.append(name)
        yield

    def between(self):
        self.betweens += 1


def test_same_seed_same_requests_other_seed_other_requests():
    a, b, c = _mix(2**40 + 1), _mix(2**40 + 1), _mix(7)
    assert a.pool == b.pool and a.pool != c.pool
    for r in range(20):
        assert np.array_equal(a.session_ids(r), b.session_ids(r))
        assert np.array_equal(a.keep_rows(r), b.keep_rows(r))
    assert all(1 <= len(s) <= 21 for s in a.pool)  # a search-only session gets a click
    # every request holds request_sessions distinct pool sessions
    assert all(len(set(a.session_ids(r))) == 8 for r in range(20))


def test_closed_loop_sends_back_to_back_and_keeps_answers():
    m, eng, spans = _mix(3), Engine(), Spans()
    first = m.warmup(eng, spans)
    w = m.window(eng, 0.2, spans, first)
    assert first == 1 and w.requests[0] == 1 and w.requests == list(range(1, 1 + len(w.requests)))
    assert w.seconds >= 0.2 and w.n_failed == 0
    assert 20 < len(w.sessions) < 100 and set(w.sessions) == {8}
    assert len(w.kept_ids) == len(w.sessions) and all(len(k) == 2 for k in w.kept_ids)
    assert spans.betweens == len(w.sessions) and set(eng.calls) == {"search"}
    assert min(w.latency_s) >= 0.002


def test_a_failed_request_counts_with_its_sessions():
    m, eng = _mix(4), Engine(refuse={3})
    w = m.window(eng, 0.1, Spans(), 1)
    assert w.n_failed == 8 and len(w.kept_ids) == len(w.sessions) - 1
    assert w.errors == ["RuntimeError: refused"]


@pytest.mark.parametrize("traced", [False, True])
def test_a_traced_run_marks_embed_and_index(traced):
    m, eng, spans = _mix(5), Engine(), Spans(traced)
    D, I = m.serve(eng, m.sessions(0), spans)
    assert D.shape == I.shape == (8, 3)
    assert eng.calls == (["embed", "search_embeddings"] if traced else ["search"])
    assert spans.names == (["embed", "index"] if traced else [])
