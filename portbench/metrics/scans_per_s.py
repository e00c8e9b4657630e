"""scans_per_s: scans whose mapping_step completed in the window, over the
window's seconds (host clock; the window closes after a sync)."""

from portbench.metrics._common import units


def read(run):
    n = len(units(run, "scan"))
    return n / run.window.seconds if n else None
