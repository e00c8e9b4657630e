"""k4_roofline_pct: K4's (nearest_neighbor) share of its roofline in the
traced aligns: the least time of its searches (roofline.py: 8 operations a
valid source x valid target pair at the bf16 tensor-core peak, or its
bytes at the memory peak, whichever is longer), over its device time in
the profiler's trace. One search runs an outer iteration of gicp_align;
the session's own check holds the launches to the program's counter."""

from portbench import roofline
from portbench.metrics._common import units
from portbench.trace import KERNELS, kernel_pattern


def read(run):
    t = run.window.trace
    aligns = units(run, "align", traced=True)
    if t is None or not aligns:
        return None
    if sum(r.info["iterations"] for r in aligns) != t.launches.get(
            "nearest_neighbor", 0):
        return None
    pat = kernel_pattern(KERNELS["nearest_neighbor"])
    device_s = sum(s for n, (_, s) in t.by_name.items() if pat.search(n))
    least_s = sum(r.info["iterations"] * roofline.nearest_neighbor_least_s(
        r.info["n_src"], r.info["n_tgt"], r.info["capacity"],
        r.info["capacity"]) for r in aligns)
    return 100.0 * least_s / device_s if device_s > 0 else None
