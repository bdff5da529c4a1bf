"""Embedding pipeline, catalog tables, evaluation runners and retrieval metrics of the port (counterpart of ``sessionsimilaritysearch_tpu.evalharness``)."""

from sessionsimilaritysearch_tpu_torch.evalharness import metrics  # noqa: F401
from sessionsimilaritysearch_tpu_torch.evalharness.knn import (  # noqa: F401
    get_p_r,
    get_prediction_by_knn,
)
