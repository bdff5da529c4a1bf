"""The serving path's spans and counters (``utils.profiling``): nothing is
recorded and no ``record_function`` entered while no profiler records; under
``torch.profiler`` a tiny engine search gives one request's spans, each
inside its parent, the loader thread's graph build handed the request's
``sss.embed``; the counters equal hand counts; the engine's timer does not
wait for the device; two profiling sessions keep their spans apart."""

import glob
import json
import math

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine
from sessionsimilaritysearch_tpu_torch.evalharness import harness
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.utils import profiling
from sessionsimilaritysearch_tpu_torch.utils.profiling import device_profile, trace

N, Q, CHUNK, BATCH, POOL = 40, 10, 16, 8, 16
EMBED_CHILDREN = {"sss.embed.wait", "sss.embed.build", "sss.embed.prepare",
                  "sss.embed.upload", "sss.embed.forward"}
CHUNK_CHILDREN = ["sss.index.score", "sss.index.select", "sss.index.merge"]


@pytest.fixture(scope="module")
def parts():
    torch.manual_seed(0)
    cfg = tiny_test_config()
    data = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(N)
    return cfg, get_tokenizer(cfg.vocab_size), build_graph_encoder(cfg, "cpu"), data


def _engine(parts, **kw):
    cfg, tok, enc, data = parts
    eng = SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim, capacity=64,
                              device="cpu", batch_size=BATCH, **kw)
    eng.add_sessions(data)
    if kw.get("prefilter") is None:
        eng.index.chunk_size = CHUNK
    return eng


@pytest.fixture(scope="module")
def dense(parts):
    return _engine(parts)


@pytest.fixture(scope="module")
def twostage(parts):
    return _engine(parts, prefilter="binary", pool=POOL)


def _profiled(fn):
    """``fn()`` under ``torch.profiler.profile``; its spans and counters."""
    with torch.profiler.profile():
        out = fn()
    return out, profiling.records(), profiling.counters(profiled=True)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_no_profiler_records_nothing_and_enters_no_range(dense, parts, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.reset()
    dense.search(parts[3][:Q], k=5)
    assert profiling.records() == [] and profiling.dropped() == 0
    assert entered == []
    assert trace("sss.anything") is trace("sss.other")  # one shared no-op
    assert profiling.current() is None
    with torch.profiler.profile():
        dense.search(parts[3][:Q], k=5)
    assert "sss.search" in entered  # the same path, profiled, enters them


def test_engine_timer_does_not_synchronize(dense, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: calls.append(a))
    assert dense.timer.sync is False
    timer = profiling.PhaseTimer(torch.device("cuda"), sync=dense.timer.sync)
    with timer("encode"):
        pass
    assert calls == [] and timer.counts["encode"] == 1
    with profiling.PhaseTimer(torch.device("cuda"))("encode"):  # the default still waits
        pass
    assert len(calls) == 1


def test_profiled_search_spans_one_request(dense, parts):
    (D, I), spans, counts = _profiled(lambda: dense.search(parts[3][:Q], k=5))
    assert D.shape == I.shape == (Q, 5)
    assert len({s.request for s in spans}) == 1
    names = _by_name(spans)
    (root,) = names["sss.search"]
    (emb,) = names["sss.embed"]
    (se,) = names["sss.search_embeddings"]
    assert root.parent is None and emb.parent is root and se.parent is root
    assert EMBED_CHILDREN <= set(names)
    batches = math.ceil(Q / BATCH)
    assert len(names["sss.embed.build"]) == len(names["sss.embed.forward"]) == batches
    # one wait a batch and the one that finds the loader done
    assert len(names["sss.embed.wait"]) == batches + 1
    for s in spans:
        if s.name in EMBED_CHILDREN:
            assert s.parent is emb, s
    request_thread = root.thread
    assert {s.thread for s in names["sss.embed.build"]} != {request_thread}
    assert all(s.thread == request_thread for s in spans if s.name != "sss.embed.build")
    chunks = names["sss.index.chunk"]
    assert len(chunks) == math.ceil(N / CHUNK)
    for c in chunks:
        assert c.parent is se
        assert [s.name for s in spans if s.parent is c] == CHUNK_CHILDREN
    (to_host,) = names["sss.index.to_host"]
    assert to_host.parent is se
    assert names["sss.embed.forward"][0].device_ms() is None  # no device events on the CPU
    assert counts["index.chunks"] == len(chunks) and counts["embed.sessions"] == Q


def test_every_child_lies_inside_its_parent(dense, parts):
    _, spans, _ = _profiled(lambda: dense.search(parts[3][:Q], k=5))
    assert spans and all(s.end_ns is not None for s in spans)
    for s in spans:
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns, s


def test_request_thread_ranges_in_the_chrome_trace(dense, parts, tmp_path):
    with device_profile(str(tmp_path)):
        dense.search(parts[3][:Q], k=5)
    spans = profiling.records()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    request_thread = _by_name(spans)["sss.search"][0].thread
    on_request = {s.name for s in spans if s.thread == request_thread}
    assert {"sss.search", "sss.embed.wait", "sss.index.select"} <= on_request <= ranges
    assert "sss.embed.build" not in ranges  # the loader thread: in memory only


def test_counters_equal_hand_counts(dense, parts, monkeypatch):
    uploaded = []
    real = harness._upload

    def counting(a, device):
        uploaded.append(np.ascontiguousarray(a).nbytes)
        return real(a, device)

    monkeypatch.setattr(harness, "_upload", counting)
    profiling.reset()
    dense.search(parts[3][:Q], k=5)
    counts = profiling.counters()
    assert counts["embed.upload_bytes"] == sum(uploaded) > 0
    assert counts["index.rows_scanned"] == dense.index.ntotal == N
    assert counts["index.chunks"] == math.ceil(N / CHUNK)
    assert counts["embed.sessions"] == Q
    assert "index.rerank_candidates" not in counts


def test_twostage_spans_and_rerank_candidates(twostage, parts):
    profiling.reset()
    _, spans, counts = _profiled(lambda: twostage.search(parts[3][:Q], k=5))
    names = _by_name(spans)
    (se,) = names["sss.search_embeddings"]
    (s1,) = names["sss.index.stage1"]
    (rr,) = names["sss.index.rerank"]
    assert s1.parent is se and rr.parent is se and s1.end_ns <= rr.start_ns
    assert counts["index.rerank_candidates"] == Q * POOL
    assert profiling.counters()["index.rerank_candidates"] == Q * POOL


def test_two_profiling_sessions_do_not_mix(dense, parts):
    _, first, _ = _profiled(lambda: dense.search(parts[3][:Q], k=5))
    dense.search(parts[3][:2], k=5)  # unprofiled between them
    with torch.profiler.profile():
        dense.search(parts[3][:3], k=3)
    second, counts = profiling.records(), profiling.counters(profiled=True)
    assert len({s.request for s in second}) == 1
    assert {s.request for s in first}.isdisjoint({s.request for s in second})
    assert counts["embed.sessions"] == 3
    # the profiler's start ends the list, with no span between the sessions
    with torch.profiler.profile():
        dense.search(parts[3][:4], k=3)
    third = profiling.records()
    assert len({s.request for s in third}) == 1
    assert {s.request for s in third}.isdisjoint({s.request for s in second})
    assert profiling.counters(profiled=True)["embed.sessions"] == 4


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    with torch.profiler.profile():
        for _ in range(8):
            with trace("sss.test"):
                pass
    assert len(profiling.records()) == 5 and profiling.dropped() == 3
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_attach_hands_the_parent_to_another_thread():
    import threading

    got = []
    with torch.profiler.profile():
        with trace("sss.root"):
            parent = profiling.current()

            def work():
                with profiling.attach(parent), trace("sss.child"):
                    pass
                with trace("sss.orphan"):
                    pass
                got.append(True)

            t = threading.Thread(target=work)
            t.start()
            t.join()
    spans = _by_name(profiling.records())
    (root,), (child,), (orphan,) = spans["sss.root"], spans["sss.child"], spans["sss.orphan"]
    assert got and child.parent is root and child.request == root.request
    assert orphan.parent is None and orphan.request != root.request
    assert child.thread != root.thread


def test_stats_keeps_its_keys_and_adds_counters(dense, parts):
    dense.search(parts[3][:2], k=3)
    s = dense.stats()
    assert {"encode", "search", "insert", "ntotal", "pending", "counters"} <= set(s)
    assert set(s["search"]) == {"total_s", "count", "mean_ms"}
    assert s["ntotal"] == N and s["pending"] == 0
    assert s["counters"]["embed.sessions"] >= 2


def test_counters_lose_no_update_across_threads():
    import sys
    import threading

    threads, adds = 16, 2000
    profiling.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("t", 1) for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counters()["t"] == threads * adds
