"""Embedding pipeline, catalog tables, evaluation runners and retrieval metrics of the port (counterpart of ``sessionsimilaritysearch_tpu.evalharness``)."""
