"""Device milliseconds per request of what the index span runs besides
its scoring kernels: selection, merges, the re-rank, copies."""


def read(run):
    t = run.trace
    n = t.count("index") if t is not None else 0
    if n == 0 or not t.device:
        return None
    return t.device_time(span="index", exclude=run.scoring) / n * 1e3
