"""host_syncs_per_scan: the device-to-host waits of mapping_step (the
eighth entry of its tuple), averaged over the window's scans."""

from portbench.metrics._common import units
from portbench.stats import mean


def read(run):
    xs = [r.info["host_syncs"] for r in units(run, "scan")]
    return mean(xs) if xs else None
