"""device_idle_pct.mapping: the share of the traced window in which no
operation ran on the device, over consecutive scans of one log."""

from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
