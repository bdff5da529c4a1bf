"""Mean host milliseconds a request of the program's graph build
(``sss.embed.build`` spans, on the loader's thread) in the traced window."""

from portbench import spans


def read(run):
    return spans.host_ms(run, ["sss.embed.build"])
