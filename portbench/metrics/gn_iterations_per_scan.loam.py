"""gn_iterations_per_scan.loam: LoamStepOut.gn_iterations (the Gauss-Newton
iteration whose pose loam_step's done flag kept, or all of them when it
never fired), averaged over the window's scans. Each of the fixed
iterations after it still runs."""

from portbench.metrics._common import units
from portbench.stats import mean


def read(run):
    xs = [r.info["gn_iterations"] for r in units(run, "scan")
          if "gn_iterations" in r.info]
    return mean(xs) if xs else None
