"""Mean host milliseconds a request of the embedding loop's upload
(``sss.embed.upload`` spans: the pinned staging and the enqueued copies of
the graph fields and the keyword ids) in the traced window."""

from portbench import spans


def read(run):
    return spans.host_ms(run, ["sss.embed.upload"])
