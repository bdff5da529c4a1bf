"""Mean host milliseconds a request that the embedding loop waits on its
loader (``sss.embed.wait`` spans: the loader's start and each blocking
``next``) in the traced window."""

from portbench import spans


def read(run):
    return spans.host_ms(run, ["sss.embed.wait"])
