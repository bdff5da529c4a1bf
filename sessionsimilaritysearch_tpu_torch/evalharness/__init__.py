"""Embedding pipeline and retrieval metrics of the port (counterpart of ``sessionsimilaritysearch_tpu.evalharness``)."""
