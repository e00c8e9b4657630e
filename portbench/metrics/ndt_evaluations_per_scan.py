"""ndt_evaluations_per_scan: NDT derivative evaluations of mapping_step
(the sixth entry of its tuple), averaged over the window's scans."""

from portbench.metrics._common import units
from portbench.stats import mean


def read(run):
    xs = [r.info["evaluations"] for r in units(run, "scan")]
    return mean(xs) if xs else None
