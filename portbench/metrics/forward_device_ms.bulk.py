"""Mean device milliseconds a request between the CUDA events of the
program's ``sss.embed.forward`` spans (the encoder's forward on the card)
in the traced window."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "sss.embed.forward")
