"""What several readers share: the window's units of one kind, and the
traced units."""

from __future__ import annotations


def units(run, kind: str, traced=None):
    """The window's records of ``kind``; with ``traced`` True or False only
    those inside or outside the profiler session."""
    return [r for r in run.window.records
            if r.kind == kind and (traced is None or r.traced == traced)]


def idle_pct(run):
    t = run.window.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def ops_per(run, kind: str):
    t = run.window.trace
    n = len(units(run, kind, traced=True))
    if t is None or n == 0:
        return None
    return t.ops / n
