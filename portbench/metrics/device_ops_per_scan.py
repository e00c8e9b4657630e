"""device_ops_per_scan: the profiler's device operations (kernels, copies,
sets) in the traced window, per traced scan."""

from portbench.metrics._common import ops_per


def read(run):
    return ops_per(run, "scan")
