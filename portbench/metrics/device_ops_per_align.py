"""device_ops_per_align: the profiler's device operations (kernels, copies,
sets) in the traced window, per traced align."""

from portbench.metrics._common import ops_per


def read(run):
    return ops_per(run, "align")
