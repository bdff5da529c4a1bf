"""Query sessions answered in the window over the window's seconds."""


def read(run):
    w = run.window
    return (w.attempted - w.n_failed) / w.seconds if w.seconds > 0 else None
