"""Mean host milliseconds of ``engine.embed`` (to device, synchronized)
per request in the traced window."""

import numpy as np


def read(run):
    h = run.host.get("embed")
    return float(np.mean(h)) * 1e3 if h else None
