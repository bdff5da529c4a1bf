"""Megabytes (10^6 bytes) a request that the embedding loop hands to its
upload (the program's ``embed.upload_bytes`` counter) in the traced
window."""

from portbench import spans


def read(run):
    v = spans.counter(run, "embed.upload_bytes")
    return None if v is None else v / 1e6
