"""Mean host milliseconds a request of the dense scan's per-chunk
selection and merge (the program's ``sss.index.select`` and
``sss.index.merge`` spans) in the traced window."""

from portbench import spans


def read(run):
    return spans.host_ms(run, ["sss.index.select", "sss.index.merge"])
