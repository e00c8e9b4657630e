"""The measured window: a closed loop over a cell's units of work.

A cell's ``units()`` yields ``Unit``s, one call into the program each,
in the order a client would make them; the loop runs them back to back
until ``seconds`` have passed, waits for the device and closes the window.
Each unit's host time runs from the call until its answer is on the host.

With tracing on, one run of the mix's ``traced_units`` consecutive units,
starting at the first unit that may start it once ``TRACED_FROM`` of the
window has passed, runs inside a profiler session (``trace.Session``);
those units are marked, so that host-clock metrics leave them out.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, NamedTuple

import torch

from portbench import trace

# The traced run starts once this share of the window has passed, past the
# first logs' or aligns' warm caches, and a session that lost events is
# retried on a fresh run of units up to this many sessions in all.
TRACED_FROM = 0.4
TRACED_SESSIONS = 3


class Unit(NamedTuple):
    kind: str  # what the unit counts as, e.g. "scan", "init", "align"
    call: Callable[[], dict]  # runs it; returns what it counted
    can_start_trace: bool = True


class Record(NamedTuple):
    kind: str
    seconds: float
    info: dict
    traced: bool


class Window(NamedTuple):
    seconds: float
    records: list
    trace: trace.Summary | None
    lost_sessions: list  # why each thrown-away session was thrown away


def run(units, seconds: float, traffic: dict | None = None,
        launches=None, sync=torch.cuda.synchronize) -> Window:
    """Runs ``units`` (an iterator) for ``seconds``. With ``traffic``
    (the mix's settings) and ``launches`` (the program's launch counters)
    it traces one run of units as the module says, trying a fresh run of
    units when a session loses events, up to ``TRACED_SESSIONS``
    sessions."""
    clock = time.perf_counter
    # The collector's pauses would land in whichever unit triggers them.
    gc.collect()
    gc.disable()
    try:
        return _loop(iter(units), seconds, traffic, launches, sync, clock)
    finally:
        gc.enable()


def _loop(units, seconds, traffic, launches, sync, clock) -> Window:
    tracing = traffic is not None
    n_traced = traffic["traced_units"] if tracing else 0
    sessions = TRACED_SESSIONS if tracing else 0
    summary, lost = None, []
    records = []
    t0 = clock()
    while clock() - t0 < seconds:
        unit = next(units)
        if (tracing and summary is None and len(lost) < sessions
                and unit.can_start_trace
                and clock() - t0 >= TRACED_FROM * seconds):
            batch = [unit] + [next(units) for _ in range(n_traced - 1)]
            recs = []
            with trace.Session(launches) as session:
                for u in batch:
                    with session.span(u.kind):
                        t = clock()
                        info = u.call()
                        recs.append(Record(u.kind, clock() - t, info, True))
            records += recs
            try:
                summary = session.summary()
            except trace.LostEvents as e:
                lost.append(str(e))
                print(f"portbench: traced session thrown away: {e}",
                      file=sys.stderr)
            continue
        t = clock()
        info = unit.call()
        records.append(Record(unit.kind, clock() - t, info, False))
    sync()
    return Window(clock() - t0, records, summary, lost)
