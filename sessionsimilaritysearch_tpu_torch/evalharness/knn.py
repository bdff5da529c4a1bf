"""kNN-based next-item recommendation
(reference: test_amazon_filterd.py:59-85): retrieve similar sessions, pool
their items weighted by retrieval score, rank, report precision/recall."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence, Set, Tuple

import numpy as np

from sessionsimilaritysearch_tpu_torch.data import schema


def get_prediction_by_knn(
    D_row: np.ndarray,
    I_row: np.ndarray,
    corpus: Sequence,
    K: int,
) -> List[int]:
    """Aggregate retrieved sessions' items weighted by similarity
    (test_amazon_filterd.py:59-78). ``D_row``/``I_row`` are one query's
    retrieval scores/indices."""
    aw = defaultdict(float)
    for d, idx in zip(D_row, I_row):
        if idx < 0:
            continue
        for asin in schema.get_item(corpus[int(idx)]):
            aw[asin] += float(d)
    ranked = sorted(aw.items(), key=lambda kv: kv[1], reverse=True)
    return [asin for asin, _ in ranked[:K]]


def get_p_r(gt: Set[int], pred: Sequence[int], K: int) -> Tuple[float, float]:
    """Precision/recall of a top-K prediction (test_amazon_filterd.py:80-85)."""
    pred = list(pred)[:K]
    hit = float(len(gt & set(pred)))
    return hit / K, (hit / len(gt) if gt else 0.0)


def knn_recommendation_recall(
    D, I, test_data, corpus, K: int = 20, sample_size: int = 500
) -> float:
    """End-to-end recall@K of kNN next-item prediction over a test split
    (the evaluation loop of test_amazon_filterd.py:178-205)."""
    recalls = []
    D, I = np.asarray(D), np.asarray(I)
    for i, (prefix, future) in enumerate(test_data):
        gt = schema.get_item(future)
        if not gt:
            continue
        pred = get_prediction_by_knn(D[i, :sample_size], I[i, :sample_size], corpus, K)
        _, r = get_p_r(gt, pred, K)
        recalls.append(r)
    return float(np.mean(recalls)) if recalls else 0.0
