"""align_p95_ms: 95th percentile of the host time of every align of the
window, from the call to gicp_align until its transform is on the host."""

from portbench.metrics._common import units
from portbench.stats import percentile


def read(run):
    xs = [1e3 * r.seconds for r in units(run, "align")]
    return percentile(xs, 95) if xs else None
