"""scan_p95_ms: 95th percentile of the host time of the window's scans,
from handing the scan to mapping_step until its pose is on the host; the
scans inside the profiler session are left out."""

from portbench.metrics._common import units
from portbench.stats import percentile


def read(run):
    xs = [1e3 * r.seconds for r in units(run, "scan", traced=False)]
    return percentile(xs, 95) if xs else None
