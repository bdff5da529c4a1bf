"""Mean host milliseconds of ``engine.search_embeddings`` (to host arrays)
per request in the traced window."""

import numpy as np


def read(run):
    h = run.host.get("index")
    return float(np.mean(h)) * 1e3 if h else None
