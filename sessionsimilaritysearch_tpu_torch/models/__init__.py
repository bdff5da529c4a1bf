"""Encoder modules of the port (counterparts of ``sessionsimilaritysearch_tpu.models``)."""
