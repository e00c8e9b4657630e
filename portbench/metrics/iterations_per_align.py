"""iterations_per_align: GICPResult.iterations (outer iterations, one
correspondence search each), averaged over the window's aligns."""

from portbench.metrics._common import units
from portbench.stats import mean


def read(run):
    xs = [r.info["iterations"] for r in units(run, "align")]
    return mean(xs) if xs else None
