"""setup_s: process start to the start of the window (host clock)."""


def read(run):
    return run.setup_s
