"""Indexes of the port (counterparts of ``sessionsimilaritysearch_tpu.index``)."""
