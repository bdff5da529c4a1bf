"""The embedding loop and the end-to-end evaluation harness (counterpart of
``sessionsimilaritysearch_tpu/evalharness/harness.py:33-600``).

Pipeline: embed corpus -> build index -> embed queries -> timed exact top-K
search -> quality report. Modes:

- 'model':  a session encoder + cosine ``DenseIndex`` (K1);
- 'binary': hash codes + ``BinaryIndex`` (Hamming; K4 packed, K1 sign);
- 'STAN' / 'SKNN': sparse CPU baselines via scipy.

The catalog tables serve the flagship encoder's forward without its text
backbone: ``build_title_table`` embeds each catalog title once,
``build_keyword_table`` each distinct search keyword, and
``make_cached_encode_fn`` gathers from them. The keyword ids of a batch are
read from the host batch before the upload (``CachedEncodeFn.prepare``), so
the ingest loop needs no device-to-host copy per batch.

Timings separate embed / build / search and report queries/sec. Device
work is synchronized before each clock read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.evalharness import metrics
from sessionsimilaritysearch_tpu_torch.evalharness.knn import knn_recommendation_recall
from sessionsimilaritysearch_tpu_torch.index import sparse as sparse_index
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.index.dense import build_index
from sessionsimilaritysearch_tpu_torch.native_build import ensure_native_library


@dataclasses.dataclass
class SearchResult:
    D: np.ndarray
    I: np.ndarray
    embed_corpus_s: float
    build_s: float
    embed_query_s: float
    search_s: float
    qps: float
    report: Optional[dict] = None


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def to_device(batch: SessionGraph, device: torch.device) -> SessionGraph:
    """Host numpy batch -> tensors on ``device``. On a CUDA device each
    field goes through pinned host memory and a ``non_blocking`` copy, so
    the copies queue on the stream behind the previous batch's compute."""
    return SessionGraph(*(_upload(a, device) for a in batch))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sessions(data: Sequence) -> list:
    return [d[0] if isinstance(d, tuple) else d for d in data]


def _qps(n: int, seconds: float) -> float:
    return n / seconds if seconds > 0 else float("inf")


class EmbeddingPipeline:
    """Sessions -> padded graphs (``SessionGraphLoader``: built on a prefetch
    thread, ``prefetch`` batches ahead, in ``workers`` processes when > 0)
    -> batched encoder forward -> [N, d] embeddings in input order. The
    loader wrap-pads the last batch to ``batch_size``; the padding rows are
    dropped from the result.

    An ``encode_fn`` with a ``prepare(host_batch)`` method gets, for each
    batch, the numpy arrays it returns uploaded beside the batch and passed
    as keyword arguments (``None`` values pass as they are)."""

    def __init__(self, cfg: Config, tokenizer, encode_fn: Callable, *,
                 device, batch_size: int = 256, workers: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.encode_fn = encode_fn
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.workers = workers
        self.prefetch = prefetch
        ensure_native_library()  # before the loader first loads it

    def encode_batch(self, batch: SessionGraph):
        """One host batch through ``encode_fn`` on the device."""
        prepare = getattr(self.encode_fn, "prepare", None)
        extra = prepare(batch) if prepare is not None else {}
        extra = {k: v if v is None else _upload(v, self.device) for k, v in extra.items()}
        return self.encode_fn(to_device(batch, self.device), **extra)

    def __call__(self, data: Sequence, out: str = "np"):
        """``data``: (prefix, future) pairs or bare sessions. ``out``: 'np'
        returns a host float32 array; 'device' keeps the result a tensor on
        the device, so an index build takes the embeddings with no host
        round trip."""
        if out not in ("np", "device"):
            raise ValueError(f"out must be 'np' or 'device', got {out!r}")
        if len(data) == 0:
            z = torch.zeros((0, 0), device=self.device)
            return z if out == "device" else z.cpu().numpy()
        norm = [
            d if isinstance(d, tuple) and len(d) == 2 else (d, [])
            for d in data
        ]
        loader = SessionGraphLoader(
            norm, self.tokenizer, self.cfg.dims, self.batch_size,
            shuffle=False, ignore_query=self.cfg.ignore_query, cache=False,
            prefetch=self.prefetch, workers=self.workers,
        )
        try:
            with torch.inference_mode():
                parts = [self.encode_batch(b) for b in loader]
        finally:
            loader.close()
        emb = torch.cat(parts, dim=0)[: len(norm)]
        return emb if out == "device" else emb.float().cpu().numpy()


def run_dense_search(
    corpus_emb,
    query_emb,
    k: int,
    metric: str = "cos",
    chunk_size: int = 65536,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Build + timed search through K1 on ``device``; returns (D, I,
    build_s, search_s). The embeddings may be numpy arrays or tensors."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    index = build_index(corpus_emb, metric=metric, chunk_size=chunk_size, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    D, I = index.search(query_emb, k)  # numpy: the copy back ends the search
    t2 = time.perf_counter()
    return D, I, t1 - t0, t2 - t1


def evaluate_encoder(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    k: int = 100,
    with_report: bool = True,
    batch_size: int = 256,
    *,
    device,
) -> SearchResult:
    """The 'model' mode: embed corpus + queries with an encoder on
    ``device``, cosine flat search, full quality report."""
    dev = resolve_device(device)
    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, device=dev, batch_size=batch_size)
    corpus_sessions = _sessions(corpus_data)
    t0 = time.perf_counter()
    corpus_emb = pipe(corpus_sessions, out="device")
    _sync(dev)
    t1 = time.perf_counter()
    query_emb = pipe(test_data, out="device")
    _sync(dev)
    t2 = time.perf_counter()
    D, I, build_s, search_s = run_dense_search(corpus_emb, query_emb, k, device=dev)
    report = (metrics.full_report(D, I, test_data, corpus_sessions)
              if with_report else None)
    return SearchResult(D, I, t1 - t0, build_s, t2 - t1, search_s,
                        _qps(len(test_data), search_s), report)


def evaluate_binary(
    db_codes,
    query_codes,
    corpus_sessions: Sequence,
    test_data: Sequence,
    k: int = 100,
    mode: str = "sign",
    with_report: bool = True,
    selection: str = "exact",
    recall_target: float = 0.95,
    *,
    device,
) -> SearchResult:
    """Hamming search over hash codes: ``mode='packed'`` through K4,
    ``'sign'`` through K1. ``selection='approx'`` (sign mode, with its
    ``recall_target``) runs the exact selection, as ``BinaryIndex`` does."""
    dev = resolve_device(device)
    n_bits = db_codes.shape[1]
    t0 = time.perf_counter()
    index = BinaryIndex(n_bits, db_codes.shape[0], mode, device=dev, selection=selection,
                        recall_target=recall_target)
    index.add(db_codes)
    _sync(dev)
    t1 = time.perf_counter()
    D, I = index.search(query_codes, k)
    t2 = time.perf_counter()
    search_s = t2 - t1
    report = (metrics.full_report(D, I, test_data, corpus_sessions)
              if with_report else None)
    return SearchResult(D, I, 0.0, t1 - t0, 0.0, search_s,
                        _qps(len(test_data), search_s), report)


def evaluate_knn_recommendation(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    K: int = 20,
    sample_size: int = 500,
    batch_size: int = 256,
    *,
    device,
) -> dict:
    """Next-item recommendation via session kNN: retrieve similar sessions,
    pool their items weighted by similarity, report recall@K of the pooled
    ranking against each session's future items."""
    dev = resolve_device(device)
    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, device=dev, batch_size=batch_size)
    corpus_sessions = _sessions(corpus_data)
    corpus_emb = pipe(corpus_sessions, out="device")
    query_emb = pipe([t[0] for t in test_data], out="device")
    k_search = min(sample_size, corpus_emb.shape[0])
    D, I, _, search_s = run_dense_search(corpus_emb, query_emb, k_search, device=dev)
    recall = knn_recommendation_recall(
        D, I, test_data, corpus_sessions, K=K, sample_size=sample_size
    )
    return {"recall_at_k": recall, "K": K, "search_s": search_s,
            "qps": _qps(len(test_data), search_s)}


def evaluate_knn_pairings(
    cfg: Config,
    tokenizer,
    subsession_encode_fn: Callable,
    session_encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    K: int = 20,
    sample_size: int = 500,
    batch_size: int = 256,
    *,
    device,
    keep: Optional[dict] = None,
) -> dict:
    """The three-way pairing protocol: a subsession encoder (prefix
    objective) and a session encoder (whole-session objective) embed the
    same corpus into two indexes and the test prefixes through each; kNN
    next-item recall@K for the pairings ``subsession_session``,
    ``subsession_subsession`` and ``session_session`` (query, corpus).
    ``keep``: a dict that receives, per pairing, the corpus and query
    embeddings (``db``, ``queries``) and the search's ``D`` / ``I``."""
    dev = resolve_device(device)
    pipe_sub = EmbeddingPipeline(cfg, tokenizer, subsession_encode_fn, device=dev,
                                 batch_size=batch_size)
    pipe_ses = EmbeddingPipeline(cfg, tokenizer, session_encode_fn, device=dev,
                                 batch_size=batch_size)
    corpus_sessions = _sessions(corpus_data)
    db_session = pipe_ses(corpus_sessions, out="device")
    db_subsession = pipe_sub(corpus_sessions, out="device")
    queries = [t[0] for t in test_data]
    q_subsession = pipe_sub(queries, out="device")
    q_session = pipe_ses(queries, out="device")
    out = {"K": K}
    for name, q, db in (
        ("subsession_session", q_subsession, db_session),
        ("subsession_subsession", q_subsession, db_subsession),
        ("session_session", q_session, db_session),
    ):
        k_search = min(sample_size, db.shape[0])
        D, I, _, _ = run_dense_search(db, q, k_search, device=dev)
        if keep is not None:
            keep[name] = {"db": db, "queries": q, "D": D, "I": I}
        out[f"recall_{name}"] = knn_recommendation_recall(
            D, I, test_data, corpus_sessions, K=K, sample_size=sample_size
        )
    return out


def evaluate_sparse(
    cfg: Config,
    corpus_sessions: Sequence,
    test_data: Sequence,
    kind: str = "binary",
    k: int = 100,
    lammy: float = 1.04,
    with_report: bool = True,
) -> SearchResult:
    """The 'STAN' / 'SKNN' modes: sparse CPU brute force (numpy + scipy, as
    in the JAX package). The corpus is always binary item-indicator
    vectors; only the queries change vectorizer (STAN applies the
    exponential time decay to the query side)."""
    t0 = time.perf_counter()
    corpus = sparse_index.build_sparse_corpus(corpus_sessions, cfg.asin_num, kind="binary")
    t1 = time.perf_counter()
    vec_fn = (
        sparse_index.sequence_to_binary_vec
        if kind == "binary"
        else lambda s, n: sparse_index.sequence_to_stan_vec(s, n, lammy)
    )
    queries = np.stack([vec_fn(t[0], cfg.asin_num) for t in test_data])
    t2 = time.perf_counter()
    D, I = sparse_index.find_K_sparse_dense(corpus, queries, k)
    t3 = time.perf_counter()
    report = (metrics.full_report(D, I, test_data, corpus_sessions)
              if with_report else None)
    search_s = t3 - t2
    return SearchResult(D, I, 0.0, t1 - t0, t2 - t1, search_s,
                        _qps(len(test_data), search_s), report)


# ---------------------------------------------------------------------------
# Precomputed-results round trip: the 'load' evaluation mode (recompute the
# metric suite from a saved search run without searching again). The file
# is the JAX package's pickle, key for key; Actions are written as plain
# tuples so that either package reads it without importing the other.
# ---------------------------------------------------------------------------

def save_results(path: str, D, I, test_data: Sequence,
                 corpus_sessions: Sequence) -> None:
    """Persist a search run: retrieved scores/ids plus the sessions the
    metric suite needs to recompute ground truth later."""
    from sessionsimilaritysearch_tpu_torch.engine import _SessionPickler

    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    with open(path, "wb") as f:
        _SessionPickler(f).dump({
            "D": None if D is None else arr(D),
            "I": arr(I),
            "test_data": list(test_data),
            "corpus_sessions": list(corpus_sessions),
        })


def load_results(path: str) -> dict:
    """A file of :func:`save_results` (either package's): numpy arrays and
    sessions whose actions are the port's ``Action``; no other class loads."""
    from sessionsimilaritysearch_tpu_torch.engine import _SessionUnpickler

    with open(path, "rb") as f:
        blob = _SessionUnpickler(f).load()
    for key in ("I", "test_data", "corpus_sessions"):
        if key not in blob:
            raise KeyError(f"results file missing '{key}'")
    return blob


def evaluate_loaded(path: str) -> dict:
    """The 'load' mode: full metric report from a saved search run."""
    blob = load_results(path)
    return metrics.full_report(
        blob.get("D"), blob["I"], blob["test_data"], blob["corpus_sessions"]
    )


# ---------------------------------------------------------------------------
# Catalog tables: titles and search keywords repeat across sessions, so a
# corpus build embeds each distinct one once and the forward gathers by id
# (GraphLevelEncoder(title_table=, query_table=, query_kw=)).
# ---------------------------------------------------------------------------

def _encoder_device(encoder) -> torch.device:
    return next(encoder.parameters()).device


def build_title_table(
    cfg: Config,
    tokenizer,
    titles: Sequence[str],
    encoder,
    batch_size: int = 1024,
) -> torch.Tensor:
    """[len(titles), d_text] table on the encoder's device, in its text
    backbone's dtype: ``titles[i]`` embedded by ``encoder.embed_texts``,
    ``batch_size`` titles at a time. ``titles`` must be the canonical
    catalog titles keyed by asin id, the strings the graph transform
    tokenizes. Caveat (as in the JAX package): the no-product placeholder
    node (asin 0, 'UNK' text) gathers asin 0's real title under the table;
    only sessions with no product interaction are affected."""
    dev = _encoder_device(encoder)
    out = []
    with torch.inference_mode():
        for s in range(0, len(titles), batch_size):
            chunk = [t if t is not None else "" for t in titles[s: s + batch_size]]
            tok = tokenizer(chunk, max_length=cfg.dims.token_len)
            out.append(encoder.embed_texts(
                _upload(tok["input_ids"], dev), _upload(tok["token_type_ids"], dev),
                _upload(tok["attention_mask"], dev)))
    return torch.cat(out, dim=0)


def build_keyword_table(
    cfg: Config,
    tokenizer,
    keywords: Sequence[str],
    encoder,
    batch_size: int = 1024,
) -> Tuple[torch.Tensor, dict]:
    """The query-store twin of :func:`build_title_table`: embed each
    distinct search keyword once. Returns ``(table [n, d_text], lookup)``
    where ``lookup`` maps the padded int32 token row bytes of a keyword (what
    the graph transform writes into ``query_input_ids``) to its table row.
    Row 0 is the root query node's ``""``, always present; the all-zero
    padding row maps to row 0 (its output is masked by ``query_node_mask``)."""
    kws = [""] + [k for k in dict.fromkeys(keywords) if k != ""]
    table = build_title_table(cfg, tokenizer, kws, encoder, batch_size=batch_size)
    T = cfg.dims.token_len
    lookup: dict = {}
    for s in range(0, len(kws), batch_size):
        chunk = kws[s: s + batch_size]
        tok = tokenizer(chunk, max_length=T)
        ids = np.zeros((len(chunk), T), dtype=np.int32)
        m = tok["input_ids"].shape[1]
        ids[:, : min(m, T)] = tok["input_ids"][:, :T]
        for j in range(len(chunk)):
            lookup.setdefault(ids[j].tobytes(), s + j)
    lookup.setdefault(np.zeros(T, dtype=np.int32).tobytes(), 0)
    return table, lookup


def keyword_ids(lookup: dict, query_input_ids: np.ndarray) -> Optional[np.ndarray]:
    """[B, Q, T] host token grid -> [B, Q] int32 table ids via ``lookup``;
    None if any row is absent (the caller then takes the title-only path).
    One ``np.unique`` over a void view plus a dict lookup per distinct row:
    an ignore_query batch has two distinct rows (root and padding)."""
    ids = np.ascontiguousarray(query_input_ids, dtype=np.int32)
    B, Q, T = ids.shape
    rows = ids.reshape(B * Q, T).view(np.dtype((np.void, T * 4))).ravel()
    uniq, inv = np.unique(rows, return_inverse=True)
    mapped = np.empty(len(uniq), dtype=np.int32)
    for j, u in enumerate(uniq):
        v = lookup.get(u.tobytes())
        if v is None:
            return None
        mapped[j] = v
    return mapped[inv].reshape(B, Q)


_FROM_GRAPH = object()  # CachedEncodeFn: look the keywords up from the graph


class CachedEncodeFn:
    """``graph -> [B, d]`` through the encoder's cached forward: product
    titles gathered from ``title_table``, and, given ``query_table`` and
    ``kw_lookup``, the query nodes gathered from the keyword table, so the
    forward runs no text backbone. A batch holding a keyword outside the
    table takes the title-only path (still exact, slower); ``oov_batches``
    counts those batches.

    ``prepare(host_batch)`` looks the keyword ids up on the host batch;
    ``EmbeddingPipeline`` calls it before the upload and passes the ids as
    ``query_kw``. Called without ``query_kw``, the ids are read from the
    graph's ``query_input_ids`` (a device-to-host copy when they live on the
    card)."""

    def __init__(self, encoder, title_table, query_table=None, kw_lookup=None):
        if query_table is not None and kw_lookup is None:
            raise ValueError("query_table requires its kw_lookup")
        self.encoder = encoder
        self.title_table = title_table
        self.query_table = query_table
        self.kw_lookup = kw_lookup
        self.oov_batches = 0

    def _ids(self, query_input_ids: np.ndarray) -> Optional[np.ndarray]:
        kw = keyword_ids(self.kw_lookup, query_input_ids)
        if kw is None:
            self.oov_batches += 1
        return kw

    def prepare(self, batch: SessionGraph) -> dict:
        if self.query_table is None:
            return {}
        return {"query_kw": self._ids(batch.query_input_ids)}

    def __call__(self, g, query_kw=_FROM_GRAPH):
        if self.query_table is None:
            return self.encoder(g, title_table=self.title_table)
        if query_kw is _FROM_GRAPH:
            kw = self._ids(g.query_input_ids.cpu().numpy())
            query_kw = None if kw is None else torch.from_numpy(kw).to(self.query_table.device)
        if query_kw is None:  # a keyword outside the table: the title-only path
            return self.encoder(g, title_table=self.title_table)
        return self.encoder(g, title_table=self.title_table,
                            query_table=self.query_table, query_kw=query_kw)


def make_cached_encode_fn(encoder, title_table, query_table=None,
                          kw_lookup=None) -> CachedEncodeFn:
    """The cached serving forward as an ``encode_fn`` (for
    ``EmbeddingPipeline``, ``SessionSearchEngine`` or the runners above).
    The JAX function also takes the params; the port's module holds its
    own, so pass the module (e.g. ``utils.precision.serving_params(enc)``)."""
    return CachedEncodeFn(encoder, title_table, query_table, kw_lookup)


def evaluate_hybrid(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    k: int = 100,
    alpha: float = 0.5,
    kind: str = "overlap",
    fusion: str = "score",
    lammy: float = 1.04,
    with_report: bool = True,
    batch_size: int = 256,
    *,
    device,
) -> SearchResult:
    """Hybrid retrieval over the full corpus: fuse the learned
    session-embedding cosine with a sparse item cosine per (query, corpus)
    pair. ``kind``: 'overlap' (binary item-indicator cosine) or 'stan'
    (recency-decayed query side, binary corpus). ``fusion``: 'score'
    (``alpha * dense + (1 - alpha) * sparse``) or 'rrf' (``1/(60 + r_dense)
    + 1/(60 + r_sparse)``, sparse ties broken by the dense rank). The
    embeddings come from ``encode_fn`` on ``device``; the fusion runs on the
    host in numpy, as in the JAX package."""
    if kind not in ("overlap", "stan"):
        raise ValueError(f"unknown kind {kind!r}")
    if fusion not in ("score", "rrf"):
        raise ValueError(f"unknown fusion {fusion!r}")
    corpus_sessions = _sessions(corpus_data)
    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, device=device, batch_size=batch_size)
    t0 = time.perf_counter()
    ce = pipe(corpus_sessions)
    qe = pipe(test_data)
    t1 = time.perf_counter()
    ce = ce / np.clip(np.linalg.norm(ce, axis=1, keepdims=True), 1e-9, None)
    qe = qe / np.clip(np.linalg.norm(qe, axis=1, keepdims=True), 1e-9, None)
    sc = sparse_index.build_sparse_corpus(corpus_sessions, cfg.asin_num, kind="binary")
    if kind == "overlap":
        sq = np.stack([sparse_index.sequence_to_binary_vec(t[0], cfg.asin_num)
                       for t in test_data])
    else:
        sq = np.stack([sparse_index.sequence_to_stan_vec(t[0], cfg.asin_num, lammy)
                       for t in test_data])
    t2 = time.perf_counter()
    dense = qe @ ce.T                       # [nq, n] cosine
    overlap = np.asarray(sc.dot(sq.T)).T    # [nq, n] cosine
    if fusion == "rrf":
        nq, n = dense.shape
        rows = np.repeat(np.arange(nq, dtype=np.int64), n)
        # dense ranks (0 = best; stable order for exact ties)
        d_order = np.argsort(-dense, axis=1, kind="stable")
        r_dense = np.empty((nq, n), np.int64)
        np.put_along_axis(r_dense, d_order, np.arange(n, dtype=np.int64)[None, :], axis=1)
        # sparse ranks, dense rank as the tiebreak
        s_order = np.lexsort((r_dense.ravel(), -overlap.ravel(), rows)).reshape(nq, n) % n
        r_sparse = np.empty((nq, n), np.int64)
        np.put_along_axis(r_sparse, s_order, np.arange(n, dtype=np.int64)[None, :], axis=1)
        fused = (1.0 / (60.0 + r_dense) + 1.0 / (60.0 + r_sparse)).astype(np.float32)
    else:
        fused = alpha * dense + (1.0 - alpha) * overlap
    kk = min(k, fused.shape[1])
    part = np.argpartition(-fused, kk - 1, axis=1)[:, :kk]
    vals = np.take_along_axis(fused, part, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    I = np.full((fused.shape[0], k), -1, dtype=np.int32)
    D = np.full((fused.shape[0], k), -np.inf, dtype=np.float32)
    I[:, :kk] = np.take_along_axis(part, order, axis=1)
    D[:, :kk] = np.take_along_axis(vals, order, axis=1)
    t3 = time.perf_counter()
    report = (metrics.full_report(None, I, list(test_data), corpus_sessions)
              if with_report else None)
    search_s = t3 - t2
    return SearchResult(D, I, t1 - t0, t2 - t1, 0.0, search_s,
                        _qps(len(test_data), search_s), report)
