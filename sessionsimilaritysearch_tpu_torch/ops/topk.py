"""The selection layer of the search: the chunked top-k over a corpus, the
exact re-rank of candidate pools, and the numpy oracle that gates them.

Counterparts of ``sessionsimilaritysearch_tpu/ops/topk.py``: ``l2_normalize``
(:31), ``merge_topk`` (:38), ``exact_topk`` (:55), ``chunked_topk`` (:163)
and ``rerank_topk`` (:357) as torch ops; ``oracle_topk_np``,
``recall_at_k``, ``value_recall_at_k`` and ``value_recall_from_scores``
(:459-557) copied as they are, since they are numpy functions in a module
that imports JAX.

The scores of a chunk come from the kernels: K1 (``ops/mips.py``) for
float rows, K2 (``ops/mips_int8.py``) for int8 codes on both sides. A
bf16 x int8 chunk (``DenseIndex(quantize='int8')``) is scored in torch
ops, as the JAX package leaves it to XLA. On CPU tensors the kernels'
plain versions run.

**Selection modes.** ``'exact'`` is the bucketed two-pass selection over
the kernels' 128-row bucket maxes (``mips.select_topk``); ``'sort'`` ranks
the chunk's scores with one ``torch.topk``. ``'approx'`` and
``'exact_cert'`` stand for ``lax.approx_max_k`` on the TPU, which has no
GPU counterpart: the port runs the exact selection for them and keeps
their ``recall_target``. The exact top-k has recall 1.0, so it meets every
target that the approximate selection promises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8
from sessionsimilaritysearch_tpu_torch.utils.profiling import count, trace

MODES = ("exact", "approx", "exact_cert", "sort")
METRICS = ("ip", "cos", "l2")


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


def ties_by_id(vals: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A descending top-k [q, k] with equal values put in ascending id
    order, as ``lax.top_k`` orders them (``torch.topk`` leaves the order of
    ties undefined); missing slots (-inf, -1) stay last. Which of more than
    k equal values make the top k is not changed."""
    order = torch.argsort(idx, dim=1)
    vals, idx = torch.gather(vals, 1, order), torch.gather(idx, 1, order)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def check_selection(mode: str, recall_target: float) -> None:
    """Refuse a selection mode the JAX package does not have, and a recall
    target outside (0, 1]."""
    if mode not in MODES:
        raise ValueError(f"unknown selection mode {mode!r}; expected one of {MODES}")
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")


def _row_penalty(n: int, device, row_mask, penalty) -> Optional[torch.Tensor]:
    """The kernels' additive f32 [n] row term: ``penalty`` (or 0), -inf
    where ``row_mask`` is False; None when neither is given."""
    if row_mask is None:
        return penalty
    mask = torch.as_tensor(row_mask, device=device).to(torch.bool)
    if mask.shape != (n,):
        raise ValueError(f"row_mask must be [{n}], got {tuple(mask.shape)}")
    base = (torch.zeros(n, dtype=torch.float32, device=device)
            if penalty is None else penalty)
    return torch.where(mask, base, float("-inf")).contiguous()


def _chunk_scores(queries, chunk, pen, score_dtype, scales, int8x8):
    """(scores [q, m] ``score_dtype``, bucket maxes [q, ceil(m/128)] f32)
    of one corpus chunk: K2 for int8 x int8, torch ops for float queries
    against int8 codes, K1 for float rows."""
    if int8x8:
        return mips_int8.scores_with_bucket_max_int8(
            queries, chunk, scales, penalty=pen, score_dtype=score_dtype)
    if chunk.dtype == torch.int8:
        s = queries.float() @ chunk.float().T  # bf16 x int8 products: exact in f32
        if scales is not None:
            s *= scales
        if pen is not None:
            s += pen
        return s.to(score_dtype), mips.bucket_max(s)
    return mips.scores_with_bucket_max(queries, chunk, penalty=pen,
                                       score_dtype=score_dtype)


def _select(scores, bmax, k: int, mode: str):
    """Per-chunk top-k: one ``torch.topk`` under 'sort', else the bucketed
    exact selection (which 'approx' and 'exact_cert' also run)."""
    if mode == "sort":
        vals, pos = torch.topk(scores.float(), min(k, scores.shape[1]), dim=1)
        return mips._missing_slots(vals, pos, k)
    return mips.select_topk(scores, bmax, k)


def chunked_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    chunk_size: int = 262144,
    metric: str = "ip",
    valid_count: Optional[int] = None,
    mode: str = "exact",
    recall_target: float = 0.95,
    score_dtype: torch.dtype = torch.float32,
    corpus_scales: Optional[torch.Tensor] = None,
    query_scales: Optional[torch.Tensor] = None,
    row_mask=None,
    penalty: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a corpus in chunks of ``chunk_size`` rows, merged with
    :func:`merge_topk`, so the score buffer stays [q, chunk_size].

    queries: [q, d] (normalized by the caller for 'cos'); corpus: [n, d]
    float rows, or int8 codes with ``corpus_scales`` [n] (a row is code x
    scale). With int8 queries and ``query_scales`` [q] as well, the chunks
    run K2 and the query scale multiplies the selected [q, k] values.
    metric: 'ip', 'cos' or 'l2' (values are then -|q - c|^2, descending;
    K1 scores (2q).c with the per-row penalty -|c|^2, and |q|^2 is taken
    off the selected values). Rows at or past ``valid_count`` and rows
    where ``row_mask`` [n] is False never rank. ``penalty`` [n] f32 is an
    additive per-row term (the kernels' penalty), which ``DenseIndex``
    uses for its stored -|c|^2. ``mode`` and ``recall_target``: see the
    module docstring. Returns (values [q, k] f32 descending, ids [q, k]
    int64), equal values in ascending id order (:func:`ties_by_id`);
    missing slots are (-inf, -1)."""
    check_selection(mode, recall_target)
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    int8x8 = query_scales is not None
    if corpus_scales is not None and metric == "l2":
        raise ValueError("a quantized corpus supports 'ip'/'cos' only")
    if int8x8 and corpus_scales is None:
        raise ValueError("query_scales (int8 x int8) requires corpus_scales")
    if queries.dtype == torch.int8 and not int8x8:
        raise ValueError("int8 queries need query_scales")
    if corpus.dtype != torch.int8 and queries.dtype != corpus.dtype:
        dtype = torch.promote_types(queries.dtype, corpus.dtype)
        queries, corpus = queries.to(dtype), corpus.to(dtype)
    n, dev = corpus.shape[0], queries.device
    vc = n if valid_count is None else int(valid_count)
    if not 0 <= vc <= n:
        raise ValueError(f"valid_count {vc} outside [0, {n}]")
    pen = _row_penalty(n, dev, row_mask, penalty)
    sq_queries = None
    if metric == "l2":
        q32 = queries.float()
        sq_queries = (q32 * q32).sum(dim=1, keepdim=True)
        queries = queries * 2  # exact: K1 scores (2q).c - |c|^2
    queries = queries.contiguous()
    nq = queries.shape[0]
    vals = torch.full((nq, k), float("-inf"), device=dev)
    idx = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for base in range(0, vc, chunk_size):  # rows past valid_count never rank
        with trace("sss.index.chunk"):
            rows = slice(base, min(base + chunk_size, vc))
            chunk = corpus[rows]
            p = None if pen is None else pen[rows]
            if metric == "l2":
                c32 = chunk.float()
                sq = -(c32 * c32).sum(dim=1)
                p = sq if p is None else p + sq
            scales = None if corpus_scales is None else corpus_scales[rows]
            with trace("sss.index.score"):
                scores, bmax = _chunk_scores(queries, chunk, p, score_dtype, scales, int8x8)
            with trace("sss.index.select"):
                c_vals, c_idx = _select(scores, bmax, k, mode)
            with trace("sss.index.merge"):
                if int8x8:
                    c_vals = c_vals * query_scales.float()[:, None]
                c_idx = torch.where(c_idx >= 0, c_idx + base, c_idx)
                vals, idx = merge_topk(vals, idx, c_vals, c_idx, k)
    count("index.chunks", -(-vc // chunk_size))
    count("index.rows_scanned", vc)
    vals, idx = ties_by_id(vals, idx)
    if sq_queries is not None:
        vals = vals - sq_queries  # -|q - c|^2; missing slots stay -inf
    return vals, idx


def exact_topk(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, metric: str = "ip"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-shot top-k (JAX ``:55``): the whole corpus as one chunk,
    ranked by one ``torch.topk`` of its scores. Right for small corpora;
    :func:`chunked_topk` bounds the score buffer at scale."""
    return chunked_topk(queries, corpus, k, chunk_size=max(corpus.shape[0], 1),
                        metric=metric, mode="sort")


def rerank_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    metric: str = "ip",
    score_dtype: torch.dtype = torch.float32,
    corpus_scales: Optional[torch.Tensor] = None,
    q_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of per-query candidate pools (stage 2 of two-stage
    serving, ``ops/topk.py:357``): gather each query's ``pool`` rows from the
    full-precision corpus and rank them by an f32 product (TF32 off), in
    tiles of ``q_chunk`` queries so the gathered [q_chunk, pool, d] block
    stays bounded.

    queries: [q, d] (normalized by the caller for 'cos'); corpus: [n, d]
    rows, or int8 codes with ``corpus_scales`` [n] (rows dequantize to
    code x scale before the product); cand_idx: [q, pool] ids, -1 for
    missing slots. ``metric='l2'`` ranks by -|q - c|^2 (not with
    ``corpus_scales``). Scores are rounded to ``score_dtype`` before the
    ranking. Returns (values [q, k] f32 descending, ids [q, k] int64);
    missing slots are (-inf, -1)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "l2" and corpus_scales is not None:
        raise ValueError("an int8 re-rank supports 'ip'/'cos' only")
    q, pool = cand_idx.shape
    kk = min(k, pool)
    vals = torch.empty((q, kk), dtype=torch.float32, device=queries.device)
    idx = torch.empty((q, kk), dtype=torch.int64, device=queries.device)
    for s in range(0, q, q_chunk):
        c = cand_idx[s: s + q_chunk].to(torch.int64)
        safe = c.clamp(min=0)
        rows = corpus[safe].float()                              # [qc, pool, d]
        if corpus_scales is not None:
            rows *= corpus_scales[safe][..., None]
        qt = queries[s: s + q_chunk].float()
        scores = torch.bmm(rows, qt[..., None])[..., 0]
        if metric == "l2":
            scores = (2.0 * scores - (qt * qt).sum(dim=1, keepdim=True)
                      - (rows * rows).sum(dim=2))
        scores = scores.to(score_dtype).float().masked_fill(c < 0, float("-inf"))
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
