"""The whole step's share of the card's peak in the traced window: the
operations of every profiled request's encoder forward (at its sessions'
own sizes), scan and re-rank, each at its own published peak rate, over
the window's seconds, in %."""

from portbench import roofline


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0 or not run.work:
        return None
    need = sum(ops / roofline.PEAK[peak]
               for work in run.work for ops, _, peak in work.values())
    return 100.0 * need / t.window_s
