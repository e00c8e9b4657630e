"""aligns_per_s: aligns completed in the window, over its seconds (host
clock; the window closes after a sync)."""

from portbench.metrics._common import units


def read(run):
    n = len(units(run, "align"))
    return n / run.window.seconds if n else None
