"""Top-k helpers of the exact search, and the numpy oracle that gates it.

Counterparts of ``sessionsimilaritysearch_tpu/ops/topk.py``: ``l2_normalize``
(:31), ``merge_topk`` (:38) and ``rerank_topk`` (:357) as torch ops;
``oracle_topk_np``,
``recall_at_k``, ``value_recall_at_k`` and ``value_recall_from_scores``
(:459-557) copied as they are, since they are numpy functions in a module
that imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row L2-normalize with clipped-norm semantics: divide by
    sqrt(clip(sum_sq, 1e-6)). Runs in ``x``'s dtype."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps))


def merge_topk(
    vals_a: torch.Tensor,
    idx_a: torch.Tensor,
    vals_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (values, indices) top-k candidate sets into the overall
    top-k (values descending)."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top_vals, top_pos = torch.topk(vals, k, dim=-1)
    return top_vals, torch.gather(idx, -1, top_pos)


def rerank_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    metric: str = "ip",
    corpus_scales=None,
    q_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of per-query candidate pools (stage 2 of two-stage
    serving, ``ops/topk.py:357``): gather each query's ``pool`` rows from the
    full-precision corpus and rank them by an f32 product (TF32 off), in
    tiles of ``q_chunk`` queries so the gathered [q_chunk, pool, d] block
    stays bounded.

    queries: [q, d] (normalized by the caller for 'cos'); corpus: [n, d];
    cand_idx: [q, pool] ids, -1 for missing slots. Returns (values [q, k]
    f32 descending, ids [q, k] int64); missing slots are (-inf, -1).
    ``metric='l2'`` and int8 ``corpus_scales`` are not ported yet (ROADMAP.md
    Queue 1 item 2)."""
    if metric == "l2" or corpus_scales is not None:
        what = "metric='l2'" if metric == "l2" else "corpus_scales"
        raise NotImplementedError(
            f"rerank_topk {what} is not ported yet (ROADMAP.md Queue 1 item 2)"
        )
    if metric not in ("ip", "cos"):
        raise ValueError(f"unknown metric {metric!r}")
    q, pool = cand_idx.shape
    kk = min(k, pool)
    vals = torch.empty((q, kk), dtype=torch.float32, device=queries.device)
    idx = torch.empty((q, kk), dtype=torch.int64, device=queries.device)
    for s in range(0, q, q_chunk):
        c = cand_idx[s: s + q_chunk].to(torch.int64)
        rows = corpus[c.clamp(min=0)].float()                    # [qc, pool, d]
        scores = torch.bmm(rows, queries[s: s + q_chunk].float()[..., None])[..., 0]
        scores = scores.masked_fill(c < 0, float("-inf"))
        v, pos = torch.topk(scores, kk, dim=1)
        vals[s: s + q_chunk] = v
        idx[s: s + q_chunk] = torch.gather(c, 1, pos).masked_fill(~torch.isfinite(v), -1)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return vals, idx


def oracle_topk_np(
    queries: np.ndarray, corpus: np.ndarray, k: int, metric: str = "ip"
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force f64 numpy oracle; tests assert device search against it."""
    queries = np.asarray(queries, np.float64)
    corpus = np.asarray(corpus, np.float64)
    if metric == "l2":
        scores = (
            2.0 * queries @ corpus.T
            - (queries**2).sum(-1, keepdims=True)
            - (corpus**2).sum(-1)[None, :]
        )
    else:
        scores = queries @ corpus.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals.astype(np.float32), idx.astype(np.int32)


def recall_at_k(found_idx: np.ndarray, true_idx: np.ndarray) -> float:
    """Fraction of oracle top-k recovered (order-insensitive)."""
    found_idx, true_idx = np.asarray(found_idx), np.asarray(true_idx)
    hits = 0
    for f, t in zip(found_idx, true_idx):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_idx.size


def value_recall_at_k(
    found_idx: np.ndarray,
    queries: np.ndarray,
    corpus: np.ndarray,
    k: int,
    metric: str = "ip",
    rel_tol: float = 0.0,
) -> float:
    """Tie/precision-aware recall: greedy one-to-one matching of the
    retrieved rows' TRUE (f64) scores against the oracle's top-k score
    multiset, within ``rel_tol`` (relative to the per-query score scale).
    A dropped true neighbour costs its slot even when deeper ties abound,
    and a duplicated row can only fill one slot. With ``rel_tol=0`` this
    equals set recall when all scores are distinct but also credits exact
    ties."""
    found_idx = np.asarray(found_idx)
    queries = np.asarray(queries, np.float64)
    corpus = np.asarray(corpus, np.float64)
    assert found_idx.shape[1] >= k
    found_idx = found_idx[:, :k]
    if metric == "l2":
        scores = (
            2.0 * queries @ corpus.T
            - (queries**2).sum(-1, keepdims=True)
            - (corpus**2).sum(-1)[None, :]
        )
    else:
        scores = queries @ corpus.T
    oracle = -np.sort(-scores, axis=1)[:, :k]  # descending top-k bars
    scale = np.maximum(np.abs(scores).max(axis=1), 1e-30)
    got = np.take_along_axis(
        scores, np.maximum(found_idx, 0).astype(np.int64), axis=1
    )
    got = np.where(found_idx >= 0, got, -np.inf)
    return value_recall_from_scores(got, oracle, rel_tol * scale)


def value_recall_from_scores(
    got: np.ndarray, oracle: np.ndarray, tol
) -> float:
    """The :func:`value_recall_at_k` matching from precomputed scores: the
    caller computes ``got`` [q, k] (true scores of the retrieved rows; -inf
    for missing slots) and ``oracle`` [q, k] (the true top-k score bars) on
    the device and pulls only those tiles. ``tol`` is the ABSOLUTE
    per-query tolerance (rel_tol * score scale)."""
    got = -np.sort(-np.asarray(got, np.float64), axis=1)  # descending
    oracle = -np.sort(-np.asarray(oracle, np.float64), axis=1)
    tol = np.broadcast_to(np.asarray(tol, np.float64), (got.shape[0],))
    q, k = oracle.shape
    assert got.shape[1] >= k, (got.shape, oracle.shape)
    matched = 0
    for r in range(q):
        j = 0
        for i in range(k):  # bars descend; each retrieved row used once
            if j < k and got[r, j] >= oracle[r, i] - tol[r]:
                matched += 1
                j += 1
    return matched / (k * max(q, 1))
