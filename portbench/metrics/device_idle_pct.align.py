"""device_idle_pct.align: the share of the traced window in which no
operation ran on the device, over consecutive aligns."""

from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
