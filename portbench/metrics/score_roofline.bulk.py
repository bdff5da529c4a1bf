"""The scoring kernels' share of their roofline in the traced window: the
least time of the scan's work at the published peaks over the device time
of the configuration's scoring kernels, in %."""

from portbench import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.device_time(run.scoring, span="index")
    if busy <= 0:
        return None
    least = sum(roofline.least_seconds(*work["scan"]) for work in run.work)
    return 100.0 * least / busy
