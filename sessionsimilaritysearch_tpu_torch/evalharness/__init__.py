"""Embedding pipeline of the port (counterpart of ``sessionsimilaritysearch_tpu.evalharness``)."""
