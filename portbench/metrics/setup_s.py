"""Seconds from the process's start to the window's first request."""


def read(run):
    return run.setup_s
